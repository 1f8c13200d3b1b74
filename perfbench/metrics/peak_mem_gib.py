"""peak_mem_gib.<kind>: the card's peak allocated memory over the traced
window, ``torch.cuda.max_memory_allocated()`` after a reset at its start,
in GiB. One reader for every cell's window (the
harness finds it by the metric name's stem)."""


def read(reading):
    if not reading.peak_bytes:
        return None
    return reading.peak_bytes / 2 ** 30
