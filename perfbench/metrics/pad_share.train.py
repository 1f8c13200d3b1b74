"""pad_share.train: the share of the duplicate stream's slots that hold no
duplicate, 100 · (1 − duplicates ÷ slots), from the program's counters
``raster.duplicates`` (min(demand, capacity) of each stream) and
``raster.slots`` (each stream's capacity), which ``api.rasterize`` counts
on the streams K1, K2, the gather and the scatter process while the
traced window's profiler collects. None where the program has no
counters."""


def read(reading):
    if reading.kind != "train":
        return None
    try:
        from streetunveiler_torch import trace
    except ImportError:
        return None
    c = trace.counters()
    if c.get("raster.slots", 0) <= 0 or "raster.duplicates" not in c:
        return None
    return 100.0 * (1.0 - c["raster.duplicates"] / c["raster.slots"])
