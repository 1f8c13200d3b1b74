"""What the per-layer readers take from the program's own ranges
(``streetunveiler_torch.trace``): device time launched inside them, and
per range the device operations launched inside it and the time in it
that the card spent idle. Every function returns None where the traced
window has no such range or no device operation, as a program without
the ranges gives."""

from __future__ import annotations

import bisect
import statistics


def device_ms_per_step(reading, names):
    """Device milliseconds per step of the operations launched inside the
    ranges ``names`` (each name's ranges apart; names whose ranges nest in
    one another would count twice)."""
    t = reading.tracer
    if not reading.steps or not t.device_ops \
            or not any(n in t.spans for n in names):
        return None
    seconds = sum(t.device_s_in_spans(n) for n in names)
    return 1e3 * seconds / reading.steps if seconds > 0 else None


def median_launches(tracer, name):
    """The median over the ranges ``name`` of the device operations
    launched inside each."""
    spans = tracer.spans.get(name)
    if not spans or not tracer.device_ops:
        return None
    launches = sorted(op[3] for op in tracer.device_ops if op[3] is not None)
    return statistics.median(bisect.bisect_left(launches, hi)
                             - bisect.bisect_left(launches, lo)
                             for lo, hi in spans)


def median_idle_ms(tracer, name):
    """The median over the ranges ``name`` of each range's length less
    the union of the card's busy intervals inside it, in milliseconds."""
    spans = tracer.spans.get(name)
    if not spans or not tracer.busy:
        return None
    ends = [hi for _, hi in tracer.busy]
    idle = []
    for lo, hi in spans:
        busy = 0
        i = bisect.bisect_right(ends, lo)
        while i < len(tracer.busy) and tracer.busy[i][0] < hi:
            b_lo, b_hi = tracer.busy[i]
            busy += min(b_hi, hi) - max(b_lo, lo)
            i += 1
        idle.append((hi - lo - busy) / 1e6)
    return statistics.median(idle)
