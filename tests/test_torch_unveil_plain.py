"""The unveil stage's delta re-optimization (``pipeline/reoptimize``) on the
CPU at a small size, against the benchmark's plain reference
(``perfbench/reference/unveil.py``): the step's loss, gradients and
deltas; the rows outside the train mask left exactly as they were;
``reoptimize_frames`` resumable chunk by chunk and the same as
``unveil()``'s own loop; and the stage's spans and counters under a CPU
profiler.

The state is the benchmark's street (``perfbench/scenes``) at 1,000
surfels seen at 64×48, its splats 12× larger so that they cover pixels
here as the street's do at 1920 columns, a tenth of its rows removed and
a third of the rest trainable, drawn from a seed; the targets and the
sky are random images.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch
from torch.profiler import profile

from perfbench import scenes, states
from perfbench.reference import model as ref
from perfbench.reference import unveil as ref_unveil
from streetunveiler_torch import trace
from streetunveiler_torch.config import ReOptimizationParams
from streetunveiler_torch.models.deltas import apply_deltas, zero_deltas
from streetunveiler_torch.models.gaussians import SurfelParams, prune_mask
from streetunveiler_torch.pipeline import reoptimize as rp
from streetunveiler_torch.pipeline.masks import RemovalMasks
from streetunveiler_torch.train.optim import adam_init

torch.set_num_threads(1)

CPU = torch.device("cpu")
W, H, N, VIEWS, SEED = 64, 48, 1000, 3, 2 ** 31 + 19
CFG = dict(n_surfels=N, width=W, height=H, focal=1970.0 * W / 1920,
           sh_degree=3, n_views=VIEWS, view_step=1.0, spatial_scale=30.0)
OPT = ReOptimizationParams()
REF_OPT = ref.StepOptions(**{
    k: getattr(OPT, k) for k in ref.StepOptions.__dataclass_fields__})
PARAMS = states.PARAMS
STEPS = 3
CAP = 128 * 24       # the demand (~2,160) with room: no overflow


@pytest.fixture(scope="module")
def setup():
    raw = scenes.street_raw_state(scenes.street_arrays(CFG, SEED, CPU), CFG)
    raw["scaling"] = raw["scaling"] + float(np.log(12.0))
    g = torch.Generator().manual_seed(SEED)
    removed = torch.rand(N, generator=g) < 0.1
    trainable = (torch.rand(N, generator=g) < 1 / 3) | removed
    cams = scenes.street_cameras(CFG, CPU)
    targets = [torch.rand(H, W, 3, generator=g) for _ in cams]
    sky = [0.5 * torch.rand(H, W, 3, generator=g) for _ in cams]
    return types.SimpleNamespace(
        raw=raw, removed=removed, train_mask=trainable & ~removed,
        trainable=trainable, cams=cams, targets=targets, sky=sky,
        pcams=[states.program_camera(w2c, K, W, H) for w2c, K in cams])


def program_steps(s, frames):
    """The port's ``reoptimize_step`` over ``frames`` from zero deltas:
    (base, deltas, losses, first gradient)."""
    base = prune_mask(states.program_state(s.raw, CPU), s.removed)
    deltas = zero_deltas(base.params)
    opt_state = adam_init(deltas)
    losses, g1 = [], None
    for i, f in enumerate(frames):
        deltas, opt_state, loss = rp.reoptimize_step(
            base, deltas, opt_state, s.train_mask, s.pcams[f], s.targets[f],
            torch.zeros(3), i + 1, OPT, sky_image=s.sky[f],
            duplicate_capacity=CAP)
        losses.append(float(loss))
        if g1 is None:
            g1 = {k: getattr(opt_state.mu, k) / 0.1 for k in PARAMS}
    return base, deltas, losses, g1


def reference_steps(s, frames):
    base = ref_unveil.prune(states.reference_state(s.raw, CPU), s.removed)
    deltas = ref_unveil.zero_deltas(base.params)
    opt_state = ref.adam_init(deltas)
    losses, g1 = [], None
    for i, f in enumerate(frames):
        w2c, K = s.cams[f]
        deltas, opt_state, loss, overflow = ref_unveil.reoptimize_step(
            base, deltas, opt_state, s.train_mask,
            states.reference_camera(w2c, K, W, H), s.targets[f],
            torch.zeros(3), i + 1, REF_OPT, sky_image=s.sky[f],
            duplicate_capacity=CAP)
        assert not overflow
        losses.append(float(loss))
        if g1 is None:
            g1 = {k: getattr(opt_state.mu, k) / 0.1 for k in PARAMS}
    return deltas, losses, g1


@pytest.fixture(scope="module")
def both(setup):
    frames = list(range(STEPS))
    return program_steps(setup, frames), reference_steps(setup, frames)


def test_step_matches_the_plain_reference(both):
    """(a) Three steps, frames 0, 1, 2. The port's CPU path runs the plain
    versions of K1, K2 and the record scatter, which do the reference's
    float32 operations; what may differ is the order in which the record
    scatter sums a surfel's duplicates, a few ulps of each gradient. So
    the losses agree to 1e-6 relative, the first gradient to 1e-5 of the
    leaf's largest element, and the deltas after three Adam steps to 1e-5
    of the leaf's largest (Adam divides by the gradient's own size, so a
    gradient at round-off level may move by its sign's step: the deltas'
    largest elements are ~3 steps of the leaf's rate, far above it)."""
    (_, p_deltas, p_losses, p_g1), (r_deltas, r_losses, r_g1) = both
    np.testing.assert_allclose(p_losses, r_losses, rtol=1e-6)
    for k in PARAMS:
        want, got = r_g1[k], p_g1[k]
        assert torch.allclose(got, want, rtol=0,
                              atol=1e-5 * float(want.abs().max())), k
        want, got = getattr(r_deltas, k), getattr(p_deltas, k)
        assert float(want.abs().max()) > 0, k
        assert torch.allclose(got, want, rtol=0,
                              atol=1e-5 * float(want.abs().max())), k


def test_rows_outside_the_mask_stay_the_base(setup, both):
    """(b) After the steps every delta outside the train mask is exactly 0
    and the effective state there is the base, bit for bit."""
    base, deltas, _, _ = both[0]
    out = ~setup.train_mask
    eff = apply_deltas(base, deltas, setup.train_mask)
    for k in PARAMS:
        d = getattr(deltas, k)
        assert not d[out].any(), k
        assert d[setup.train_mask].any(), k
        assert torch.equal(getattr(eff.params, k)[out],
                           getattr(base.params, k)[out]), k


def _frames(s, base, chunks, targets, seed=5):
    """``reoptimize_frames`` over the frames of ``targets`` in ``chunks``
    (iteration counts) from zero deltas, carrying the order and the
    generator."""
    deltas = zero_deltas(base.params)
    opt_state = adam_init(deltas)
    rng, order, first = np.random.default_rng(seed), [], 1
    for n in chunks:
        deltas, opt_state, loss, order = rp.reoptimize_frames(
            base, deltas, opt_state, s.train_mask, s.pcams, targets,
            torch.zeros(3), list(targets), first, n, OPT, rng, order=order,
            duplicate_capacity=CAP)
        first += n
    return deltas, opt_state, loss


class PassThrough:
    """An inpainter that returns its input: the targets are the frames'
    own images."""

    def inpaint(self, image, mask, reference=None):
        return np.asarray(image, np.float32)


def test_frames_resume_and_match_unveil(setup):
    """(c) ``unveil()`` with one key frame (frames 0 and 1 its
    candidates, frame 2 the propagation boundary) runs its 4 iterations as
    one ``reoptimize_frames`` call; two calls of 2 from its targets and
    seed, the second starting inside a permutation of the two frames,
    carry on exactly where the first stopped and train the same deltas,
    bit for bit."""
    s = setup
    state = states.program_state(s.raw, CPU)
    base = prune_mask(state, s.removed)
    scene = types.SimpleNamespace(
        train_cameras=s.pcams,
        train_images=[t.numpy() for t in s.targets],
        pcd_in_frame_mask=lambda xyz, f: torch.ones(xyz.shape[0],
                                                    dtype=torch.bool))
    masks = RemovalMasks(removed=s.removed.numpy(),
                         editable=s.trainable.numpy(),
                         trainable=s.trainable.numpy())
    _, deltas, targets = rp.unveil(
        scene, state, masks, [0], PassThrough(),
        opt=dataclasses.replace(OPT, iterations=4), duplicate_capacity=CAP,
        seed=5, device="cpu")
    assert sorted(targets) == [0, 1]
    two = _frames(s, base, [2, 2],
                  {f: torch.as_tensor(targets[f]) for f in (0, 1)})
    for k in PARAMS:
        assert torch.equal(getattr(deltas, k), getattr(two[0], k)), k


def test_spans_and_counters_once_a_step(setup):
    """(d) Under a CPU profiler each step opens ``unveil.step`` with
    ``unveil.deltas``, ``unveil.deltas_bwd``, ``unveil.loss`` and
    ``unveil.adam`` inside it, once each; the counters read the train
    mask's rows and the base's alive rows once a step."""
    s = setup
    base = prune_mask(states.program_state(s.raw, CPU), s.removed)
    trace.reset_counters()
    with profile() as prof:
        _frames(s, base, [2], {0: s.targets[0], 1: s.targets[1]})
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            spans.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    steps = sorted(spans["unveil.step"])
    assert len(steps) == 2
    for name in ("unveil.deltas", "unveil.deltas_bwd", "unveil.loss",
                 "unveil.adam"):
        assert len(spans[name]) == 2, name
        for lo, hi in spans[name]:
            assert any(a <= lo and hi <= b for a, b in steps), name
    c = trace.counters()
    assert c["unveil.trainable"] == 2 * int(s.train_mask.sum())
    assert c["unveil.surfels"] == 2 * int(base.alive.sum())
