"""idle_share.<kind>: the share of the traced window in which no operation
ran on the card, 100 · (1 − busy / window), busy being the union of the
device's kernel, copy and set intervals (``perfbench/trace.py``). One
reader for every cell's window: the harness finds it by the metric name's
stem (``idle_share.train``, ``idle_share.render``)."""


def read(reading):
    if reading.tracer.window_s <= 0 or not reading.tracer.device_ops:
        return None
    return 100.0 * (1.0 - reading.tracer.busy_s / reading.tracer.window_s)
