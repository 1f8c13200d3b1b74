"""record_scatter_ms.train: device milliseconds per training step of the
record scatter, the operations launched inside the program's
``raster.record_scatter`` ranges (``_gather_records``' backward: the
``index_add_`` that takes K2's record gradients back to the surfels),
over the traced window."""

from perfbench.spans import device_ms_per_step


def read(reading):
    if reading.kind != "train":
        return None
    return device_ms_per_step(reading, ("raster.record_scatter",))
