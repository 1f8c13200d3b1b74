"""k2_roofline.train: K2's (the blend backward's) share of its roofline in
the training window, 100 · Σ bound / Σ device time over the K2 launches
(kernels whose name holds ``blend_bwd``, gated or not) of the sampled
steps near the window's end. Each bound is the larger of the operations
over the float32 peak and the bytes over the HBM rate, counted by
``perfbench/counts.py`` from the reference's pairs of that step's view."""

NAME = "blend_bwd"


def read(reading):
    if reading.kind != "train" or not reading.sample:
        return None
    bound = time = 0.0
    for s in reading.sample:
        ops = reading.tracer.ops_launched_in(*s["span"], name_part=NAME)
        if len(ops) != 1:
            return None
        bound += s["k2_bound_s"]
        time += ops[0][2] / 1e9
    return 100.0 * bound / time if time > 0 else None
