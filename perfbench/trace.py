"""The traced window: ``torch.profiler`` over the whole measured window,
reduced to what the per-layer readers and the result's ``device`` and
``breakdown`` read.

* busy: the union of the device's activity intervals (kernels, copies,
  sets) inside the window; ``busy_s`` is its length, ``window_s`` the
  window's, and the idle share is 1 − busy/window;
* host spans: the ``record_function`` ranges the entry drivers open
  (``bin_step``, ``frame``) and the window's own range;
* launch times: each device operation is tied, by its correlation id, to
  the host call that launched it, so a device operation belongs to a host
  span when its launch lies inside it;
* the breakdown: the device operations that took the most time, by name,
  and the longest idle gaps, each named by the innermost host operation
  running at its middle.
"""

from __future__ import annotations

import bisect
import contextlib
import time

WINDOW = "perfbench.window"
# host events of the profiler's own bookkeeping
PROFILER_OWN = ("Activity Buffer Request",)


class Tracer:
    """Opens the profiler around a window when ``enabled``; otherwise only
    synchronizes and times it. Spans are ``record_function`` ranges when
    enabled and nothing otherwise."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = device
        self.window_s = 0.0
        self.busy_s = 0.0
        self.device_ops: list = []     # (name, start_ns, dur_ns, launch_ns)
        self.host_ops: list = []       # (name, start_ns, end_ns)
        self.spans: dict = {}          # name -> [(start_ns, end_ns)]
        self.busy: list = []           # merged (start_ns, end_ns)
        self.t0_ns = self.t1_ns = 0
        self.t_begin = self.t_end = 0.0

    def _sync(self):
        import torch
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    @contextlib.contextmanager
    def window(self):
        """The measured window, from ``t_begin`` to ``t_end`` on
        ``time.perf_counter``'s clock: it starts and ends with the device
        synchronized, so the work the window queued is inside it."""
        if not self.enabled:
            self._sync()
            self.t_begin = time.perf_counter()
            yield
            self._sync()
            self.t_end = time.perf_counter()
            return
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        import torch
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        prof = profile(activities=acts)
        prof.__enter__()
        try:
            with record_function(WINDOW):
                self.t_begin = time.perf_counter()
                yield
                self._sync()
                self.t_end = time.perf_counter()
        finally:
            prof.__exit__(None, None, None)
        t = time.perf_counter()
        self._reduce(prof)
        self.reduce_s = time.perf_counter() - t

    def _reduce(self, prof):
        from torch.autograd import DeviceType
        events = prof.profiler.kineto_results.events()
        launch = {}
        dev_raw, host = [], []
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                dev_raw.append((e.name(), e.start_ns(), e.duration_ns(),
                                e.correlation_id(),
                                bool(e.is_user_annotation())))
            else:
                name = e.name()
                start = e.start_ns()
                end = start + e.duration_ns()
                if e.is_user_annotation():
                    self.spans.setdefault(name, []).append((start, end))
                elif name.startswith("cu"):
                    launch[e.correlation_id()] = start
                elif name not in PROFILER_OWN:
                    host.append((name, start, end))
        win = self.spans.get(WINDOW, [])
        if win:
            self.t0_ns, self.t1_ns = win[0]
        names = set(self.spans)
        for name, start, dur, corr, annot in dev_raw:
            # a record_function range mirrored on the device's timeline is
            # no device work
            if annot or name in names:
                continue
            self.device_ops.append((name, start, dur, launch.get(corr)))
        self.device_ops.sort(key=lambda op: op[1])
        self.host_ops = sorted(host, key=lambda op: op[1])
        for v in self.spans.values():
            v.sort()
        self.window_s = (self.t1_ns - self.t0_ns) / 1e9
        merged = []
        for _, start, dur, _ in self.device_ops:
            lo, hi = max(start, self.t0_ns), min(start + dur, self.t1_ns)
            if hi <= lo:
                continue
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        self.busy = [tuple(m) for m in merged]
        self.busy_s = sum(hi - lo for lo, hi in self.busy) / 1e9

    # ---------------------------------------------------------- queries

    def ops_launched_in(self, start_ns: int, end_ns: int, name_part=None):
        """Device operations launched inside [start, end), optionally
        only those whose name contains ``name_part``."""
        return [op for op in self.device_ops
                if op[3] is not None and start_ns <= op[3] < end_ns
                and (name_part is None or name_part in op[0])]

    def device_s_in_spans(self, span_name: str) -> float:
        """Device seconds of the operations launched inside the spans
        named ``span_name``."""
        spans = self.spans.get(span_name, [])
        starts = [s for s, _ in spans]
        total = 0
        for _, _, dur, t in self.device_ops:
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < spans[i][1]:
                total += dur
        return total / 1e9

    def breakdown(self, top: int = 10) -> dict:
        by_name = {}
        for name, _, dur, _ in self.device_ops:
            by_name[name] = by_name.get(name, 0) + dur
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        prev = self.t0_ns
        for lo, hi in self.busy + [(self.t1_ns, self.t1_ns)]:
            if lo > prev:
                gaps.append((lo - prev, prev, lo))
            prev = max(prev, hi)
        gaps.sort(reverse=True)
        return {"device_ops": [[n[:200], d / 1e9] for n, d in ops],
                "idle_gaps": [[self.host_label((a + b) // 2), g / 1e9]
                              for g, a, b in gaps[:top]]}

    def host_label(self, t_ns: int, look_back: int = 50_000) -> str:
        """The innermost host operation running at ``t_ns`` (among the
        ``look_back`` that started last before it), else the innermost
        span, else 'host'."""
        if not hasattr(self, "_host_starts"):
            self._host_starts = [op[1] for op in self.host_ops]
        best = None
        i = bisect.bisect_right(self._host_starts, t_ns)
        for name, start, end in self.host_ops[max(0, i - look_back):i]:
            if end > t_ns and (best is None or end - start < best[1]):
                best = (name, end - start)
        if best is None:
            for name, spans in self.spans.items():
                for start, end in spans:
                    if start <= t_ns < end and name != WINDOW and (
                            best is None or end - start < best[1]):
                        best = (name, end - start)
        return (best[0] if best else "host")[:200]
