"""The frozen reference against the port's CPU path at a miniature size:
the street (``tools/street.MINI``'s view: 600 surfels at 128×96). The
reference is a copy of that path as it stood when the
benchmark was defined; these tests show when the two part."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from perfbench import scenes, states
from perfbench.reference import model as ref

from .cells import SEED, mini

CPU = torch.device("cpu")


def _street(seed=SEED):
    cfg = mini("street-1920x1280.train-late").config
    raw = scenes.street_raw_state(scenes.street_arrays(cfg, seed, CPU), cfg)
    w2c, K = scenes.street_cameras(cfg, CPU)[1]
    return cfg, raw, w2c, K


def _close(a, b, tol=1e-6):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.shape == b.shape
    assert torch.allclose(a, b, rtol=tol, atol=tol), \
        float((a - b).abs().max())


def test_render_view_matches_the_port():
    from streetunveiler_torch.cli.render import render_view
    cfg, raw, w2c, K = _street()
    sky = scenes.sky_arrays(SEED, CPU)
    w, h = cfg["width"], cfg["height"]
    got = render_view(states.program_camera(w2c, K, w, h),
                      states.program_state(raw, CPU), torch.zeros(3),
                      states.program_sky(sky, CPU), 128 * 64, True, "cpu")
    st = states.reference_state(raw, CPU)
    cam = states.reference_camera(w2c, K, w, h)
    res = ref.render(cam, st, torch.zeros(3), duplicate_capacity=128 * 64,
                     device=CPU)
    rsky = ref.render_sky(states.reference_sky(sky, CPU), h, w, K,
                          torch.linalg.inv(w2c))
    want = (res.render + rsky * (1.0 - res.rend_alpha)[..., None],
            res.surf_depth, res.rend_normal_world(cam),
            ref.render_semantic(cam, st, duplicate_capacity=128 * 64,
                                device=CPU))
    for g, r in zip(got, want):
        _close(g, r)


@pytest.mark.parametrize("late", [False, True])
def test_train_step_matches_the_port(late):
    from streetunveiler_torch.config import OptimizationParams
    from streetunveiler_torch.train.optim import adam_init
    from streetunveiler_torch.train.step import init_optimizer, train_step
    cfg, raw, w2c, K = _street()
    w, h = cfg["width"], cfg["height"]
    opts = cfg["optimization"]
    it = 32001 if late else 25001
    gt = torch.rand((h, w, 3), generator=torch.Generator().manual_seed(1))
    sem = torch.randint(0, 6, (h, w), generator=torch.Generator()
                        .manual_seed(2)).to(torch.int32)
    sky = scenes.sky_arrays(SEED, CPU) if late else None
    bg = torch.zeros(3)

    ps = states.program_state(raw, CPU)
    psky = states.program_sky(sky, CPU) if late else None
    p_out = train_step(ps, init_optimizer(ps),
                       states.program_camera(w2c, K, w, h), gt, bg, it,
                       OptimizationParams(**opts), sky_params=psky,
                       sky_opt_state=adam_init(psky) if late else None,
                       gt_semantic=sem if late else None, class_dist=late,
                       duplicate_capacity=128 * 64, device="cpu")
    rs = states.reference_state(raw, CPU)
    rsky = states.reference_sky(sky, CPU) if late else None
    r_opt = ref.StepOptions(**{k: v for k, v in opts.items()
                               if k in ref.StepOptions.__dataclass_fields__})
    r_out = ref.train_step(rs, ref.init_optimizer(rs),
                           states.reference_camera(w2c, K, w, h), gt, bg, it,
                           r_opt, sky_params=rsky,
                           sky_opt_state=ref.adam_init(rsky) if late
                           else None,
                           gt_semantic=sem if late else None,
                           class_dist=late, duplicate_capacity=128 * 64,
                           device=CPU)
    _close(p_out[4]["loss"], r_out[4]["loss"])
    for name, t in states.leaves(p_out[0].params, p_out[2]).items():
        _close(t, states.leaves(r_out[0].params, r_out[2])[name])


def test_tf32_control_rounds_operands():
    x = torch.tensor([1.0 + 2 ** -12, -3.14159, 2.0 ** -20])
    with ref.mode(tf32=True):
        y = ref._operand(x)
    assert y.tolist() == [1.0, -3.140625, 2.0 ** -20]
    assert ref._operand(x) is x
