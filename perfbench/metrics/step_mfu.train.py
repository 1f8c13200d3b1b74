"""step_mfu.train: the whole training step's share of the card's float32
peak (67 TFLOP/s outside the tensor cores; the step runs with TF32 off),
100 · (counted operations of a step) / (time of a step × peak). The
operations are the mean over the sampled steps near the traced window's
end: K1's and K2's (``perfbench/counts.py``, from the reference's pairs
of the step's view), the sky's MLP forward and backward, and SSIM's
blurs; the rest counts zero, so this is a lower bound. The time of a step
is the untraced window's, its length over its steps: the profiler slows
a step on the host, so the traced window's would read low."""

from perfbench.counts import F32_OPS_PER_S


def read(reading):
    if reading.kind != "train" or not reading.sample \
            or not reading.step_s or not reading.tracer.device_ops:
        return None
    ops = sum(s["ops"] for s in reading.sample) / len(reading.sample)
    return 100.0 * ops / (reading.step_s * F32_OPS_PER_S)
