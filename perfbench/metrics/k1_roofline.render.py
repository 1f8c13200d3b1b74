"""k1_roofline.render: K1's share of its roofline in the render window,
100 · Σ bound / Σ device time over the K1 launches (kernels whose name
holds ``blend_fwd``) of the sampled frames at the window's end, both
blends of each frame (the render at nq 6, the semantic render at nq 9).
Bounds as for ``k1_roofline.train``."""

NAME = "blend_fwd"


def read(reading):
    if reading.kind != "render" or not reading.sample:
        return None
    bound = time = 0.0
    for s in reading.sample:
        ops = reading.tracer.ops_launched_in(*s["span"], name_part=NAME)
        if len(ops) != s["k1_launches"]:
            return None
        bound += s["k1_bound_s"]
        time += sum(op[2] for op in ops) / 1e9
    return 100.0 * bound / time if time > 0 else None
