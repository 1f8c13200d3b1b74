"""launches_per_step.train: the median over the program's
``train.iteration`` ranges (one iteration of ``train/loop.train_scene``:
the binning, the step, the schedule, the capacity check) of the device
operations launched inside each, over the traced window. A median,
because the harness copies state inside the iterations it checks."""

from perfbench.spans import median_launches


def read(reading):
    if reading.kind != "train":
        return None
    return median_launches(reading.tracer, "train.iteration")
