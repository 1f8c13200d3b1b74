"""frame_mfu.render: the whole render view's share of the card's float32
peak (67 TFLOP/s; the view runs with TF32 off), 100 · (counted operations
of a frame) / (time of a frame × peak). The operations are the mean over
the sampled frames at the traced window's end: K1's of both blends
(``perfbench/counts.py``, from the reference's pairs of the frame's view)
and the sky's MLP forward; the rest counts zero, so this is a lower
bound. The time of a frame is the untraced window's, its length over its
frames (from the call to the outputs on the host): the profiler slows a
frame on the host, so the traced window's would read low."""

from perfbench.counts import F32_OPS_PER_S


def read(reading):
    if reading.kind != "render" or not reading.sample \
            or not reading.frame_s or not reading.tracer.device_ops:
        return None
    ops = sum(s["ops"] for s in reading.sample) / len(reading.sample)
    return 100.0 * ops / (reading.frame_s * F32_OPS_PER_S)
