"""bin_ms.train: device milliseconds per training step of the binning, the
operations launched inside the program's own ``train.bin`` ranges
(``train/step.bin_step``: the steps' binning and each chunk's capacity
probe), over the traced window. ``binning_ms.train`` reads the same work
from the ranges the harness opens around the calls."""

from perfbench.spans import device_ms_per_step


def read(reading):
    if reading.kind != "train":
        return None
    return device_ms_per_step(reading, ("train.bin",))
