"""step_idle_ms.unveil: the median over the program's ``unveil.step``
ranges (one ``pipeline/reoptimize.reoptimize_step``: apply_deltas, the
render, the loss, the backward, Adam) of each range's length less the
union of the card's busy intervals inside it, in milliseconds, over the
traced window: the card's idle time inside a delta step. A median,
because the harness copies state inside the steps it checks. None where
the program has no such range."""

from perfbench.spans import median_idle_ms


def read(reading):
    if reading.kind != "unveil":
        return None
    return median_idle_ms(reading.tracer, "unveil.step")
