"""step_mfu.unveil: the whole delta step's share of the card's float32
peak (67 TFLOP/s outside the tensor cores; the step runs with TF32 off),
100 · (counted operations of a step) / (time of a step × peak). The
operations are the mean over the sampled steps at the traced window's
end: K1's and K2's at nq 6 (``perfbench/counts.py``'s formulas, from the
reference's pairs of the step's frame on the effective state at the
window's close) and L1's 5 an image element; the rest (apply_deltas,
Adam, the binning, the distortion and normal terms) counts zero, so this
is a lower bound. The time of a step is the untraced window's, its length
over its steps."""

from perfbench.counts import F32_OPS_PER_S


def read(reading):
    if reading.kind != "unveil" or not reading.sample \
            or not reading.step_s or not reading.tracer.device_ops:
        return None
    ops = sum(s["ops"] for s in reading.sample) / len(reading.sample)
    return 100.0 * ops / (reading.step_s * F32_OPS_PER_S)
