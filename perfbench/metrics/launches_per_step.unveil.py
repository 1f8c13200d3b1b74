"""launches_per_step.unveil: the median over the program's ``unveil.step``
ranges (one ``pipeline/reoptimize.reoptimize_step``) of the device
operations launched inside each, over the traced window. A median,
because the harness copies state inside the steps it checks. None where
the program has no such range."""

from perfbench.spans import median_launches


def read(reading):
    if reading.kind != "unveil":
        return None
    return median_launches(reading.tracer, "unveil.step")
