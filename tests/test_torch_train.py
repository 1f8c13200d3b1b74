"""Port vs JAX: the stage-1 training slice.

* ``l1_loss``, ``ssim``, ``psnr``, ``expon_lr`` and ``adam_update`` at
  1e-6;
* ``densify_and_prune`` fed the same split samples (including the
  full-capacity case of ``tests/test_train.py:100``), ``reset_opacity``
  and ``prune_mask``: equal;
* ``stage1_loss`` and its gradients, with and without the semantic loss,
  and in the late phase (the gated per-class distortion and the sky);
* one ``train_step`` from the same state, photometric and late-phase
  (semantics, class_dist, the sky trained jointly);
* port only: ``train_scene`` on a tiny synthetic street raises PSNR and
  bumps an absurd duplicate capacity, and reaches the late phase with the
  sky; the checkpoint round trip with the JAX package's ``splatting.npz``,
  the sky included; the training CLI on the CPU, with ``--sky
  --semantics`` through the late phase and a resume.

Gradients: ``tests/test_kernel.py:86`` (atol 2e-4·max|g|, rtol 1e-3);
losses rtol 1e-4 (the blend and SSIM sum in another order).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streetunveiler_tpu.config import OptimizationParams as JOpt
from streetunveiler_tpu.config import load_config as jload_config
from streetunveiler_tpu.models import gaussians as jgs
from streetunveiler_tpu.models import sky as jsky
from streetunveiler_tpu.renderer import render as jrender
from streetunveiler_tpu.scene.cameras import make_camera as jmake_camera
from streetunveiler_tpu.train import checkpoint as jckpt
from streetunveiler_tpu.train import losses as jlosses
from streetunveiler_tpu.train import optim as joptim
from streetunveiler_tpu.train import schedule as jschedule
from streetunveiler_tpu.train import step as jstep
from streetunveiler_torch import convert
from streetunveiler_torch.config import OptimizationParams
from streetunveiler_torch.models import gaussians as tgs
from streetunveiler_torch.models.gaussians import SurfelParams
from streetunveiler_torch.scene.cameras import make_camera
from streetunveiler_torch.train import checkpoint as tckpt
from streetunveiler_torch.train import losses as tlosses
from streetunveiler_torch.train import optim as toptim
from streetunveiler_torch.train import schedule as tschedule
from streetunveiler_torch.train import step as tstep

torch.set_num_threads(1)

PARAMS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
W, H, F = 48, 32, 30.0
# every stage-1 loss term on (normal consistency, distortion, shrink)
ALL_TERMS = dict(normal_consist_from_iter=0, semantic_dist_from_iter=0,
                 shrinking_from_iter=0)


def jax_scene(n=60, seed=0):
    """The scene of tests/test_train.py:19 (JAX state, JAX cameras)."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(4, 8, n)], 1).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    sem = rng.integers(0, 6, n)
    state = jgs.create_from_pcd(pts, cols, sem, spatial_scale=4.0,
                                capacity=2 * n, sh_degree=3)
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
    cams = [(np.array([dx, 0, 0.0]), K) for dx in (-0.3, 0.0, 0.3)]
    return state, cams


def to_port(jstate):
    return convert.state_from_arrays(jckpt._flatten(jstate, "state"),
                                     device="cpu")


def jcam(c):
    return jmake_camera(np.eye(3), c[0], c[1], W, H)


def tcam(c):
    return make_camera(np.eye(3), c[0], c[1], W, H, device="cpu")


def np_(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def assert_grads_close(got, want, names):
    for name in names:
        a, b = np_(got[name]), np_(want[name])
        scale = np.abs(b).max()
        np.testing.assert_allclose(a, b, atol=2e-4 * scale + 1e-12,
                                   rtol=1e-3, err_msg=name)


@pytest.fixture(scope="module")
def setup():
    """A JAX state with SH detail, its port copy, cameras, and ground
    truth from the JAX render of a perturbed copy (opacity raised, as in
    tests/test_train.py:44), random semantic labels."""
    jstate, cams = jax_scene()
    rng = np.random.default_rng(4)
    jstate = dataclasses.replace(jstate, params=dataclasses.replace(
        jstate.params,
        features_rest=jnp.asarray(rng.normal(
            0, 0.05, jstate.params.features_rest.shape), jnp.float32),
        scaling=jstate.params.scaling + 0.5))
    gt_state = dataclasses.replace(jstate, params=dataclasses.replace(
        jstate.params, opacity=jnp.full_like(jstate.params.opacity, 2.0)))
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    gt = np.array(jrender(jcam(cams[0]), gt_state, jnp.asarray(bg),
                          interpret=True).render)
    gt_sem = rng.integers(0, 6, (H, W)).astype(np.int32)
    return jstate, to_port(jstate), cams, np.clip(gt, 0, 1), gt_sem, bg


# ------------------------------------------------------------ leaves

def test_losses_schedule_and_adam_match_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (32, 48, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    for tf, jf, rtol in ((tlosses.l1_loss, jlosses.l1_loss, 1e-6),
                         (tlosses.l2_loss, jlosses.l2_loss, 1e-6),
                         (tlosses.psnr, jlosses.psnr, 1e-6),
                         (tlosses.ssim, jlosses.ssim, 1e-6),
                         # (1 − λ)·L1 + λ·(1 − SSIM) loses a digit
                         (tlosses.photometric_loss,
                          jlosses.photometric_loss, 1e-5)):
        np.testing.assert_allclose(float(tf(ta, tb)), float(jf(a, b)),
                                   rtol=rtol, err_msg=tf.__name__)
    assert float(tlosses.ssim(ta, ta)) == pytest.approx(1.0, abs=1e-5)

    for step in (0, 1, 500, 10_000, 49_999, 60_000):
        for kw in (dict(), dict(lr_delay_steps=1000, lr_delay_mult=0.01)):
            np.testing.assert_allclose(
                tschedule.expon_lr(step, 1.6e-4, 1.6e-6, max_steps=50_000,
                                   **kw),
                float(jschedule.expon_lr(step, 1.6e-4, 1.6e-6,
                                         max_steps=50_000, **kw)),
                rtol=1e-6)

    shapes = dict(xyz=(7, 3), features_dc=(7, 1, 3),
                  features_rest=(7, 15, 3), scaling=(7, 2), rotation=(7, 4),
                  opacity=(7, 1))
    mk = lambda: {k: rng.normal(size=s).astype(np.float32)
                  for k, s in shapes.items()}
    p0, lrs = mk(), dict(xyz=1e-3, features_dc=2.5e-3, features_rest=1.25e-4,
                         scaling=1e-3, rotation=1e-3, opacity=0.05)
    jp = jgs.SurfelParams(**{k: jnp.asarray(v) for k, v in p0.items()})
    tp = SurfelParams(**{k: torch.tensor(v) for k, v in p0.items()})
    js, ts = joptim.adam_init(jp), toptim.adam_init(tp)
    for _ in range(3):
        g = mk()
        jp, js = joptim.adam_update(
            jgs.SurfelParams(**{k: jnp.asarray(v) for k, v in g.items()}),
            js, jp, jgs.SurfelParams(**lrs))
        tp, ts = toptim.adam_update(
            SurfelParams(**{k: torch.tensor(v) for k, v in g.items()}),
            ts, tp, SurfelParams(**lrs))
    assert ts.step == int(js.step) == 3
    for k in shapes:
        for t, j in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
            np.testing.assert_allclose(np_(getattr(t, k)),
                                       np.asarray(getattr(j, k)),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


def _assert_states_equal(t, j, children=False):
    """Every leaf equal. With ``children`` (split children were placed)
    their positions and scales are held at a tolerance instead: a child
    sits at parent + R·(s·sample), the offsets reach ~7 here (scales e²),
    and its log-scale is log(e^s / 1.6); the two packages' rotation
    matrices, exp and log differ in the last bit."""
    for k in PARAMS:
        a, b = np_(getattr(t.params, k)), np.asarray(getattr(j.params, k))
        if k == "xyz" and children:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-5)
        elif k == "scaling" and children:
            np.testing.assert_allclose(a, b, rtol=1e-6)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("semantics", "alive", "max_radii2d", "grad_accum", "denom"):
        np.testing.assert_array_equal(np_(getattr(t, k)),
                                      np.asarray(getattr(j, k)), err_msg=k)


@pytest.mark.parametrize("case", ["partial", "full", "screen_size"])
def test_densify_and_prune_matches_jax(case):
    jstate, _ = jax_scene(n=40)
    if case == "full":
        # tests/test_train.py:100: every slot alive, every surfel splits
        jstate = dataclasses.replace(
            jstate, alive=jnp.ones_like(jstate.alive),
            params=dataclasses.replace(
                jstate.params,
                opacity=jnp.full_like(jstate.params.opacity, 2.0),
                scaling=jnp.full_like(jstate.params.scaling, 2.0)),
            grad_accum=jnp.ones_like(jstate.grad_accum),
            denom=jnp.ones_like(jstate.denom))
    else:
        # tests/test_train.py:76: large gradients on a few surfels, some
        # of them large enough to split
        scaling = jstate.params.scaling.at[:5].add(2.0)
        jstate = dataclasses.replace(
            jstate, grad_accum=jstate.grad_accum.at[:10].set(1.0),
            denom=jnp.ones_like(jstate.denom),
            max_radii2d=jnp.linspace(0.0, 40.0, jstate.capacity),
            params=dataclasses.replace(jstate.params, scaling=scaling))
    max_screen = 20.0 if case == "screen_size" else None
    jo = jstep.init_optimizer(jstate)
    jo = jo._replace(mu=jax.tree.map(lambda x: x + 0.5, jo.mu),
                     nu=jax.tree.map(lambda x: x + 0.25, jo.nu))
    key = jax.random.PRNGKey(3)
    samples = np.asarray(jax.random.normal(key, (2, jstate.capacity, 2)))
    j2, jmu, jnu = jgs.densify_and_prune(
        jstate, jo.mu, jo.nu, 2e-4, 0.005, max_screen, key)

    tstate = to_port(jstate)
    to_ = toptim.adam_init(tstate.params)
    mu = SurfelParams(**{k: getattr(to_.mu, k) + 0.5 for k in PARAMS})
    nu = SurfelParams(**{k: getattr(to_.nu, k) + 0.25 for k in PARAMS})
    t2, tmu, tnu = tgs.densify_and_prune(
        tstate, mu, nu, 2e-4, 0.005, max_screen,
        samples=torch.tensor(samples))
    _assert_states_equal(t2, j2, children=True)
    for k in PARAMS:
        np.testing.assert_array_equal(np_(getattr(tmu, k)),
                                      np.asarray(getattr(jmu, k)))
        np.testing.assert_array_equal(np_(getattr(tnu, k)),
                                      np.asarray(getattr(jnu, k)))
    if case == "full":
        assert int(t2.num_alive) == int(tstate.num_alive) == tstate.capacity
    else:
        assert int(t2.num_alive) != int(tstate.num_alive)
    # the inputs are left as they were
    np.testing.assert_array_equal(np_(tstate.alive), np.asarray(jstate.alive))


def test_reset_opacity_and_prune_mask_match_jax():
    jstate, _ = jax_scene(n=30)
    tstate = to_port(jstate)
    jo, to_ = jstep.init_optimizer(jstate), tstep.init_optimizer(tstate)
    j2, jmu, _ = jgs.reset_opacity(jstate, jo.mu, jo.nu)
    t2, tmu, _ = tgs.reset_opacity(tstate, to_.mu, to_.nu)
    _assert_states_equal(t2, j2)
    assert float(t2.get_opacity()[t2.alive].max()) <= 0.011
    mask = np.asarray(jstate.semantics) == 3
    _assert_states_equal(tgs.prune_mask(tstate, torch.as_tensor(mask)),
                         jgs.prune_mask(jstate, jnp.asarray(mask)))


# ------------------------------------------------------------ step

@pytest.mark.parametrize("semantics", [False, True])
def test_stage1_loss_and_grads_match_jax(setup, semantics):
    jstate, tstate, cams, gt, gt_sem, bg = setup
    sem = gt_sem if semantics else None
    jopt, opt = JOpt(**ALL_TERMS), OptimizationParams(**ALL_TERMS)
    it = 5000

    def jloss(params, off):
        st = dataclasses.replace(jstate, params=params)
        return jstep.stage1_loss(st, jcam(cams[0]), jnp.asarray(gt),
                                 jnp.asarray(bg), it, jopt,
                                 gt_semantic=(None if sem is None
                                              else jnp.asarray(sem)),
                                 center2d_offset=off, interpret=True)
    (jl, jaux), (jg, jgo) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            jstate.params, jnp.zeros((jstate.capacity, 2)))

    leaves = {k: getattr(tstate.params, k).clone().requires_grad_(True)
              for k in PARAMS}
    off = torch.zeros((tstate.capacity, 2), requires_grad=True)
    st = dataclasses.replace(tstate, params=SurfelParams(**leaves))
    tl, taux = tstep.stage1_loss(st, tcam(cams[0]), torch.as_tensor(gt),
                                 torch.as_tensor(bg), it, opt,
                                 gt_semantic=(None if sem is None
                                              else torch.as_tensor(sem)),
                                 center2d_offset=off)
    grads = torch.autograd.grad(tl, [leaves[k] for k in PARAMS] + [off])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    for k in ("l1", "ssim", "psnr", "semantic"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    assert (float(taux["semantic"]) > 0) == semantics
    want = {k: getattr(jg, k) for k in PARAMS}
    want["center2d_offset"] = jgo
    got = dict(zip(list(PARAMS) + ["center2d_offset"], grads))
    assert_grads_close(got, want, want)


def test_train_step_matches_jax(setup):
    """One step from the same state. Adam's first step moves each entry
    by about ±lr·sign(g), so the updated parameters are compared where
    |g_ref| > 1e-3·max|g_ref| and bounded by 2·lr elsewhere."""
    jstate, tstate, cams, gt, _, bg = setup
    it = 1500
    jopt, opt = JOpt(), OptimizationParams()
    # the reference gradients, for the mask
    jloss = lambda p: jstep.stage1_loss(
        dataclasses.replace(jstate, params=p), jcam(cams[0]),
        jnp.asarray(gt), jnp.asarray(bg), it, jopt, interpret=True)[0]
    jg = jax.grad(jloss)(jstate.params)
    j2, _, _, _, jm = jstep.train_step(
        jstate, jstep.init_optimizer(jstate), jcam(cams[0]), jnp.asarray(gt),
        jnp.asarray(bg), jnp.asarray(it), jopt, interpret=True)

    p0 = {k: getattr(tstate.params, k).clone() for k in PARAMS}
    t0 = dataclasses.replace(tstate, params=SurfelParams(**p0))
    t2, ts, tsky, tsky_opt, tm = tstep.train_step(
        t0, tstep.init_optimizer(t0), tcam(cams[0]), gt, bg, it, opt,
        device="cpu")
    assert tsky is None and tsky_opt is None
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    assert ts.step == 1 and int(tm["n_alive"]) == int(jm["n_alive"])
    lrs = tstep.make_lrs(opt, it, float(tstate.spatial_scale))
    for k in PARAMS:
        g = np.abs(np.asarray(getattr(jg, k)))
        big = g > 1e-3 * g.max()
        a, b = np_(getattr(t2.params, k)), np.asarray(getattr(j2.params, k))
        lr = float(getattr(lrs, k))
        np.testing.assert_allclose(a[big], b[big], rtol=0,
                                   atol=1e-6 + 0.02 * lr, err_msg=k)
        assert np.abs(a - b).max() <= 2 * lr + 1e-6, k
    # densification statistics
    np.testing.assert_array_equal(np_(t2.denom), np.asarray(j2.denom))
    np.testing.assert_allclose(np_(t2.max_radii2d), np.asarray(j2.max_radii2d),
                               rtol=1e-5)
    ga, gj = np_(t2.grad_accum), np.asarray(j2.grad_accum)
    np.testing.assert_allclose(ga, gj, atol=2e-4 * gj.max(), rtol=1e-3)


# ------------------------------------------------------------ port only

def test_train_scene_raises_psnr_and_bumps_capacity(tmp_path):
    """tests/test_train.py:161's tiny synthetic street: an absurd
    capacity (one chunk) is bumped before training, nothing overflows,
    and 60 iterations raise the training views' PSNR by ≥ 1 dB."""
    from streetunveiler_torch.scene.readers import make_synthetic_street
    from streetunveiler_torch.scene.scene import Scene
    from streetunveiler_torch.train.loop import evaluate_views, train_scene

    info = make_synthetic_street(n_points=400, n_cameras=3, width=64,
                                 height=48, focal=45.0, seed=5, device="cpu")
    scene = Scene(info, model_path=str(tmp_path), device="cpu")
    state = scene.create_state(capacity=512)
    bg = torch.tensor(scene.background)
    p0, _ = evaluate_views(state, scene.train_cameras, scene.train_images, bg)
    opt = OptimizationParams(densify_from_iter=10, normal_consist_from_iter=0,
                             semantic_dist_from_iter=10**9,
                             prune_from_iter=10**9)
    state2, _, reps = train_scene(scene, state, opt, bg=bg, iterations=60,
                                  log_every=20, duplicate_capacity=128,
                                  save_iterations=(60,), device="cpu")
    p1, _ = evaluate_views(state2, scene.train_cameras, scene.train_images,
                           bg)
    assert [r.iteration for r in reps] == [20, 40, 60]
    assert reps[-1].dup_capacity > 128
    assert all(r.overflow_frac == 0.0 for r in reps)
    assert p1 > p0 + 1.0, (p0, p1)
    assert os.path.exists(os.path.join(scene.ply_dir(60), "point_cloud.ply"))
    # held-out evaluation in row slabs (exact crops) reads the same, and an
    # overflowing capacity is retried at the demand
    imgs = scene.train_images
    one = evaluate_views(state2, scene.train_cameras, imgs, bg)
    np.testing.assert_allclose(evaluate_views(state2, scene.train_cameras,
                                              imgs, bg, n_slabs=3), one,
                               rtol=1e-5)
    np.testing.assert_allclose(evaluate_views(state2, scene.train_cameras,
                                              imgs, bg,
                                              duplicate_capacity=128), one,
                               rtol=1e-5)


def test_checkpoint_roundtrip_with_jax(setup, tmp_path):
    """A JAX ``splatting.npz`` loads in the port leaf for leaf, and the
    port's loads back in the JAX package."""
    jstate, _, _, _, _, _ = setup
    jo = jstep.init_optimizer(jstate)
    jo = jo._replace(step=jnp.asarray(7, jnp.int32),
                     mu=jax.tree.map(lambda x: x + 0.5, jo.mu),
                     nu=jax.tree.map(lambda x: x + 0.25, jo.nu))
    jckpt.save_checkpoint(str(tmp_path / "j"), jstate, jo, 123)
    st, ost, it, sky, skyopt = tckpt.load_checkpoint(str(tmp_path / "j"),
                                                     device="cpu")
    assert it == 123 and ost.step == 7 and sky is None and skyopt is None
    _assert_states_equal(st, jstate)
    for k in PARAMS:
        np.testing.assert_array_equal(np_(getattr(ost.mu, k)),
                                      np.asarray(getattr(jo.mu, k)))
    tckpt.save_checkpoint(str(tmp_path / "t"), st, ost, 124)
    j2, jo2, it2 = jckpt.load_checkpoint(str(tmp_path / "t"), jstate, jo)
    assert it2 == 124 and int(jo2.step) == 7
    _assert_states_equal(st, j2)
    for k in PARAMS:
        np.testing.assert_array_equal(np.asarray(getattr(jo2.nu, k)),
                                      np_(getattr(ost.nu, k)))


def test_cli_train_on_cpu(tmp_path):
    """``python -m streetunveiler_torch.cli.train --device cpu`` at a tiny
    size: cfg_args.json readable by the JAX package, cameras.json, the
    PLY and the checkpoint; unported options are refused (the sky is
    ported: ``test_cli_train_sky_semantics_late_phase``; ``--profile``:
    ``tests/test_torch_render_cli.py``)."""
    from streetunveiler_torch.cli import train as cli_train
    out = str(tmp_path / "model")
    state, reports = cli_train.main([
        "--model_path", out, "--iterations", "6", "--log_every", "3",
        "--device", "cpu", "--semantics", "--synthetic_points", "300",
        "--synthetic_cameras", "3", "--synthetic_width", "48",
        "--synthetic_height", "32", "--synthetic_focal", "30"])
    assert [r.iteration for r in reports] == [3, 6]
    assert np.isfinite(reports[-1].loss)
    cfg = jload_config(out)
    assert cfg["model"].synthetic_points == 300
    assert cfg["optimization"] == JOpt()
    with open(os.path.join(out, "cameras.json")) as f:
        assert len(json.load(f)) == 3
    assert os.path.exists(os.path.join(out, "point_cloud", "iteration_6",
                                       "point_cloud.ply"))
    st, _, it, sky, _ = tckpt.load_checkpoint(
        os.path.join(out, "checkpoint", "iteration_6"), device="cpu")
    assert it == 6 and sky is None
    np.testing.assert_array_equal(np_(st.params.xyz), np_(state.params.xyz))
    for flag in (["--tile_devices", "2"], ["--multihost"]):
        with pytest.raises(SystemExit, match="not ported"):
            cli_train.main(["--model_path", out, "--device", "cpu"] + flag)
    with pytest.raises(NotImplementedError, match="reader"):
        cli_train.main(["--model_path", out, "--device", "cpu", "--scene",
                        "colmap"])


def test_cli_detect_anomaly_raises_on_a_nan_loss(tmp_path, monkeypatch):
    """``--detect_anomaly`` (the JAX CLI's flag, ``jax_debug_nans`` there;
    ``torch.autograd.set_detect_anomaly`` here, as the reference's
    train.py:310,325): with the L1 term forced to NaN the training raises
    in the backward; without the flag it trains through on NaN."""
    from streetunveiler_torch.cli import train as cli_train
    from streetunveiler_torch.train import step as tstep
    l1 = tstep.l1_loss
    monkeypatch.setattr(tstep, "l1_loss",
                        lambda a, b: torch.sqrt(l1(a, b) - 2.0))
    common = ["--iterations", "2", "--log_every", "2", "--device", "cpu",
              "--synthetic_points", "200", "--synthetic_cameras", "2",
              "--synthetic_width", "32", "--synthetic_height", "24",
              "--synthetic_focal", "20"]
    with pytest.raises(RuntimeError, match="nan"):
        cli_train.main(["--model_path", str(tmp_path / "a"),
                        "--detect_anomaly"] + common)
    assert not torch.is_anomaly_enabled()
    _, reports = cli_train.main(["--model_path", str(tmp_path / "b")]
                                + common)
    assert [r.iteration for r in reports] == [2]
    assert np.isnan(reports[-1].loss)


# ------------------------------------------------------------ late phase

LATE_IT = 31_001   # past semantic_dist_from_iter, normal consistency and
#                    shrink: every stage-1 loss term on


def to_port_sky(jsky_params):
    return convert.sky_from_arrays(jckpt._flatten(jsky_params, "sky"),
                                   device="cpu")


@pytest.fixture(scope="module")
def sky_pair():
    jp = jsky.init_sky(jax.random.PRNGKey(5))
    return jp, to_port_sky(jp)


def _late_jax_loss(jstate, cams, gt, gt_sem, bg):
    def jloss(params, off, sky):
        st = dataclasses.replace(jstate, params=params)
        return jstep.stage1_loss(st, jcam(cams[0]), jnp.asarray(gt),
                                 jnp.asarray(bg), LATE_IT, JOpt(),
                                 sky_params=sky,
                                 gt_semantic=jnp.asarray(gt_sem),
                                 class_dist=True, center2d_offset=off,
                                 interpret=True)
    return jloss


def test_late_stage1_loss_and_grads_match_jax(setup, sky_pair):
    """The late-phase loss (semantics, the gated per-class distortion over
    the 5 classes but sky, the sky composited) and its gradients to the
    surfels, ``center2d_offset`` and every sky parameter."""
    jstate, tstate, cams, gt, gt_sem, bg = setup
    jsp, tsp = sky_pair
    (jl, jaux), jgrads = jax.value_and_grad(
        _late_jax_loss(jstate, cams, gt, gt_sem, bg), argnums=(0, 1, 2),
        has_aux=True)(jstate.params, jnp.zeros((jstate.capacity, 2)), jsp)

    leaves = {k: getattr(tstate.params, k).clone().requires_grad_(True)
              for k in PARAMS}
    off = torch.zeros((tstate.capacity, 2), requires_grad=True)
    sky = tsp.map(lambda t: t.clone().requires_grad_(True))
    st = dataclasses.replace(tstate, params=SurfelParams(**leaves))
    opt = OptimizationParams()
    tl, taux = tstep.stage1_loss(st, tcam(cams[0]), torch.as_tensor(gt),
                                 torch.as_tensor(bg), LATE_IT, opt,
                                 sky_params=sky,
                                 gt_semantic=torch.as_tensor(gt_sem),
                                 class_dist=True, center2d_offset=off)
    sky_named = sky.named_tensors()
    grads = torch.autograd.grad(tl, [leaves[k] for k in PARAMS] + [off]
                                + list(sky_named.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    for k in ("l1", "ssim", "psnr", "semantic"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    want = {k: getattr(jgrads[0], k) for k in PARAMS}
    want["center2d_offset"] = jgrads[1]
    want.update({"sky" + k: v
                 for k, v in jckpt._flatten(jgrads[2], "").items()})
    got = dict(zip(list(PARAMS) + ["center2d_offset"]
                   + ["sky" + k for k in sky_named], grads))
    assert_grads_close(got, want, want)
    # the per-class distortion is in the loss
    with torch.no_grad():
        t_off, _ = tstep.stage1_loss(
            tstate, tcam(cams[0]), torch.as_tensor(gt),
            torch.as_tensor(bg), LATE_IT, opt, sky_params=tsp,
            gt_semantic=torch.as_tensor(gt_sem), class_dist=False)
    assert float(tl.detach()) > float(t_off)


def test_late_train_step_matches_jax(setup, sky_pair):
    """One late-phase step (semantics, class_dist, the sky trained jointly)
    from the same state: loss, updated surfel parameters and updated sky
    parameters, at ``test_train_step_matches_jax``'s tolerance (Adam's
    first step moves each entry by about ±lr·sign(g): compared where
    |g_ref| > 1e-3·max|g_ref|, bounded by 2·lr elsewhere)."""
    jstate, tstate, cams, gt, gt_sem, bg = setup
    jsp, tsp = sky_pair
    jg, _, jgs = jax.grad(
        lambda *a: _late_jax_loss(jstate, cams, gt, gt_sem, bg)(*a)[0],
        argnums=(0, 1, 2))(jstate.params, jnp.zeros((jstate.capacity, 2)),
                           jsp)
    jopt, opt = JOpt(), OptimizationParams()
    j2, _, jsky2, jskyopt2, jm = jstep.train_step(
        jstate, jstep.init_optimizer(jstate), jcam(cams[0]), jnp.asarray(gt),
        jnp.asarray(bg), jnp.asarray(LATE_IT), jopt, sky_params=jsp,
        sky_opt_state=joptim.adam_init(jsp),
        gt_semantic=jnp.asarray(gt_sem), class_dist=True, interpret=True)

    p0 = {k: getattr(tstate.params, k).clone() for k in PARAMS}
    t0 = dataclasses.replace(tstate, params=SurfelParams(**p0))
    t2, _, tsky2, tskyopt2, tm = tstep.train_step(
        t0, tstep.init_optimizer(t0), tcam(cams[0]), gt, bg, LATE_IT, opt,
        sky_params=tsp.map(torch.clone), gt_semantic=gt_sem,
        class_dist=True, device="cpu")
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    assert tskyopt2.step == 1
    lrs = tstep.make_lrs(opt, LATE_IT, float(tstate.spatial_scale))
    pairs = [(np_(getattr(t2.params, k)), np.asarray(getattr(j2.params, k)),
              np.asarray(getattr(jg, k)), float(getattr(lrs, k)), k)
             for k in PARAMS]
    jsky_new = jckpt._flatten(jsky2, "")
    jsky_g = jckpt._flatten(jgs, "")
    pairs += [(np_(t), jsky_new[k], jsky_g[k], tstep.SKY_LR, "sky" + k)
              for k, t in tsky2.named_tensors().items()]
    for a, b, g, lr, name in pairs:
        g = np.abs(g)
        big = g > 1e-3 * g.max()
        np.testing.assert_allclose(a[big], b[big], rtol=0,
                                   atol=1e-6 + 0.02 * lr, err_msg=name)
        assert np.abs(a - b).max() <= 2 * lr + 1e-6, name
    # the sky moved
    assert any(float((t - t0).abs().max()) > 0 for t, t0 in zip(
        tsky2.named_tensors().values(), tsp.named_tensors().values()))


def test_checkpoint_with_sky_roundtrip_with_jax(setup, tmp_path):
    """A JAX ``splatting.npz`` with a sky and its Adam state loads in the
    port, and the port's loads back in the JAX package; the render-time
    sky reader finds it."""
    jstate, _, _, _, _, _ = setup
    jo = jstep.init_optimizer(jstate)
    jp = jsky.init_sky(jax.random.PRNGKey(1))
    jso = joptim.adam_init(jp)
    jso = jso._replace(step=jnp.asarray(3, jnp.int32),
                       mu=jax.tree.map(lambda x: x + 0.5, jso.mu),
                       nu=jax.tree.map(lambda x: x + 0.25, jso.nu))
    jckpt.save_checkpoint(str(tmp_path / "m" / "checkpoint" / "iteration_9"),
                          jstate, jo, 9, sky_params=jp, sky_opt_state=jso)
    st, ost, it, sky, skyopt = tckpt.load_checkpoint(
        str(tmp_path / "m" / "checkpoint" / "iteration_9"), device="cpu")
    assert it == 9 and skyopt.step == 3
    _assert_states_equal(st, jstate)
    want = {**jckpt._flatten(jp, "sky"), **jckpt._flatten(jso, "skyopt")}
    got = {"sky" + k: t for k, t in sky.named_tensors().items()}
    for part in ("mu", "nu"):
        got.update({f"skyopt.{part}{k}": t for k, t in
                    getattr(skyopt, part).named_tensors().items()})
    assert set(got) == set(want) - {"skyopt.step"}
    for k, t in got.items():
        np.testing.assert_array_equal(np_(t), want[k], err_msg=k)
    reread = tckpt.load_sky_for_iteration(str(tmp_path / "m"), 9,
                                          device="cpu")
    np.testing.assert_array_equal(np_(reread.mlp_w[0]), np.asarray(jp.mlp_w[0]))
    assert tckpt.load_sky_for_iteration(str(tmp_path / "m"), 8,
                                        device="cpu") is None
    tckpt.save_checkpoint(str(tmp_path / "t"), st, ost, 10, sky_params=sky,
                          sky_opt_state=skyopt)
    _, _, it2, jsky2, jso2 = jckpt.load_checkpoint(
        str(tmp_path / "t"), jstate, jo, sky_template=jp,
        sky_opt_template=jso)
    assert it2 == 10 and int(jso2.step) == 3
    for k, v in jckpt._flatten(jsky2, "sky").items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    # a checkpoint without a sky reads as None
    tckpt.save_checkpoint(str(tmp_path / "n"), st, ost, 11)
    assert tckpt.load_checkpoint(str(tmp_path / "n"),
                                 device="cpu")[3:] == (None, None)


def test_train_scene_late_phase_with_sky(tmp_path):
    """``train_scene`` with semantics and the sky on a tiny synthetic
    street, with the late phase from iteration 10 of 30: the gated
    per-class distortion runs, the sky trains, nothing goes non-finite and
    the training views' PSNR (sky composited) rises."""
    from streetunveiler_torch.models.sky import init_sky
    from streetunveiler_torch.scene.readers import make_synthetic_street
    from streetunveiler_torch.scene.scene import Scene
    from streetunveiler_torch.train import loop

    info = make_synthetic_street(n_points=300, n_cameras=3, width=48,
                                 height=32, focal=35.0, seed=5, device="cpu")
    scene = Scene(info, model_path=str(tmp_path), device="cpu")
    state = scene.create_state(capacity=512)
    bg = torch.tensor(scene.background)
    sky = init_sky(torch.Generator().manual_seed(0), device="cpu")
    sky0 = sky.map(torch.clone)
    p0, _ = loop.evaluate_views(state, scene.train_cameras,
                                scene.train_images, bg, sky_params=sky)
    opt = OptimizationParams(densify_from_iter=10**9,
                             semantic_dist_from_iter=10,
                             normal_consist_from_iter=0,
                             prune_from_iter=10**9)
    calls = []
    orig = loop.train_step

    def spy(*a, **kw):
        calls.append((a[5], kw["class_dist"], kw["sky_params"] is not None,
                      kw["gt_semantic"] is not None))
        return orig(*a, **kw)

    loop.train_step = spy
    try:
        state2, sky2, reps = loop.train_scene(
            scene, state, opt, sky_params=sky, bg=bg, iterations=30,
            log_every=10, use_semantics=True, device="cpu")
    finally:
        loop.train_step = orig
    assert [c[1] for c in calls] == [it > 10 for it in range(1, 31)]
    assert all(c[2] and c[3] for c in calls)
    assert all(np.isfinite(r.loss) for r in reps)
    assert all(bool(torch.isfinite(t).all())
               for t in sky2.named_tensors().values())
    assert float((sky2.mlp_b[-1] - sky0.mlp_b[-1]).abs().max()) > 0
    p1, _ = loop.evaluate_views(state2, scene.train_cameras,
                                scene.train_images, bg, sky_params=sky2)
    assert p1 > p0 + 1.0, (p0, p1)


def test_cli_train_sky_semantics_late_phase(tmp_path):
    """The CLI with ``--sky --semantics`` and a compressed schedule that
    reaches the late phase: the checkpoint carries the sky, and a resume
    from it trains on with that sky."""
    from streetunveiler_torch.cli import train as cli_train
    out = str(tmp_path / "model")
    common = ["--model_path", out, "--device", "cpu", "--sky", "--semantics",
              "--log_every", "4", "--synthetic_points", "300",
              "--synthetic_cameras", "3", "--synthetic_width", "48",
              "--synthetic_height", "32", "--synthetic_focal", "30",
              "--semantic_dist_from_iter", "4"]
    state, reports = cli_train.main(common + ["--iterations", "8"])
    assert [r.iteration for r in reports] == [4, 8]
    st, _, it, sky, _ = tckpt.load_checkpoint(
        os.path.join(out, "checkpoint", "iteration_8"), device="cpu")
    assert it == 8 and sky is not None
    np.testing.assert_array_equal(np_(st.params.xyz), np_(state.params.xyz))
    fresh = tsky_init(0)
    assert float((sky.mlp_b[-1] - fresh.mlp_b[-1]).abs().max()) > 0
    state2, reports2 = cli_train.main(common + ["--iterations", "12",
                                                "--start_iteration", "8"])
    assert [r.iteration for r in reports2] == [12]
    sky12 = tckpt.load_sky_for_iteration(out, 12, device="cpu")
    assert float((sky12.mlp_b[-1] - sky.mlp_b[-1]).abs().max()) > 0
    assert np.isfinite(reports2[-1].loss)


def tsky_init(seed):
    from streetunveiler_torch.models.sky import init_sky
    return init_sky(torch.Generator().manual_seed(seed), device="cpu")
