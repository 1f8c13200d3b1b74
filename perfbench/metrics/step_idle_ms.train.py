"""step_idle_ms.train: the median over the program's ``train.iteration``
ranges of each range's length less the union of the card's busy
intervals inside it, in milliseconds, over the traced window: the card's
idle time inside a loop iteration. A median, because the harness copies
state inside the iterations it checks."""

from perfbench.spans import median_idle_ms


def read(reading):
    if reading.kind != "train":
        return None
    return median_idle_ms(reading.tracer, "train.iteration")
