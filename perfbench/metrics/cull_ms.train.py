"""cull_ms.train: device milliseconds per training step of the binning's
tile rectangles and exact conic cull, the operations launched inside the
program's ``bin.cull`` ranges (``tiles.tile_rects`` and
``tiles.conic_cull``), over the traced window."""

from perfbench.spans import device_ms_per_step


def read(reading):
    if reading.kind != "train":
        return None
    return device_ms_per_step(reading, ("bin.cull",))
