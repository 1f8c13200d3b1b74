"""Port vs JAX: multi-device training (``parallel/shard.py``) on gloo ranks.

The port's ranks are spawned processes (``parallel.multihost.
launch_local``) that run ``parallel/dryrun.py``'s bundle entries, so a
rank imports nothing but the port; the JAX side runs its
``make_sharded_train_step`` on the conftest's 8 virtual CPU devices.

* ``shift_packT`` and ``bin_slab_from_inputs`` against JAX: equal streams;
* slab renders against the full render's rows (atol 1e-5,
  ``tests/test_shard.py:48``);
* the sharded step on 2×2, 2×1 and 1×2 meshes against JAX's on the same
  mesh shapes — the 1×2 case with semantics, class distortion and the
  sky, through the sharded preprocess: loss and metrics at rtol 1e-4 (the
  blend and SSIM sum in another order, as ``tests/test_torch_train.py``
  holds ``train_step``), the first Adam moments (0.1·g) at the gradient
  tolerance of ``tests/test_kernel.py:86``, the updated parameters as
  ``test_train_step_matches_jax`` compares them, the densification counts
  equal;
* 1×1 against the single-device ``train_step`` at rtol 1e-5
  (``tests/test_loop_sharded.py:119-121``);
* ZeRO against replicated on 2×2 at ``tests/test_shard_zero.py:44-54``'s
  tolerances, and the replicated preprocess against the sharded one on
  1×2.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streetunveiler_tpu.config import OptimizationParams as JOpt
from streetunveiler_tpu.models import sky as jsky
from streetunveiler_tpu.models.gaussians import create_from_pcd
from streetunveiler_tpu.ops.rasterizer import api as japi
from streetunveiler_tpu.ops.rasterizer.types import \
    RasterizeSettings as JSettings
from streetunveiler_tpu.parallel import shard as jshard
from streetunveiler_tpu.train import checkpoint as jckpt
from streetunveiler_tpu.train.step import init_optimizer as jinit_opt
from streetunveiler_torch import convert
from streetunveiler_torch.config import OptimizationParams
from streetunveiler_torch.ops.rasterizer import api as tapi
from streetunveiler_torch.ops.rasterizer.kernel import pack_geometry_T
from streetunveiler_torch.ops.rasterizer.preprocess import preprocess_surfels
from streetunveiler_torch.ops.rasterizer.types import RasterizeSettings
from streetunveiler_torch.parallel import dryrun
from streetunveiler_torch.parallel.multihost import launch_local
from streetunveiler_torch.renderer import render
from streetunveiler_torch.scene.cameras import Camera
from streetunveiler_torch.train import step as tstep

torch.set_num_threads(1)

PARAMS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
W, H, F = 32, 64, 30.0
LATE_IT = JOpt().semantic_dist_from_iter + 1


def jax_state(n=50, seed=0):
    """The scene of tests/test_shard.py:19."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                    rng.uniform(3, 8, n)], 1).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    return create_from_pcd(pts, cols, rng.integers(0, 6, n),
                           spatial_scale=4.0, capacity=64)


def to_port(jstate):
    return convert.state_from_arrays(jckpt._flatten(jstate, "state"),
                                     device="cpu")


def batch(b, seed=3):
    rng = np.random.default_rng(seed)
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
    w2c = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    for i in range(b):          # distinct cameras on distinct data rows
        w2c[i, 0, 3] = 0.2 * i
    gt = rng.uniform(0, 1, (b, H, W, 3)).astype(np.float32)
    sem = rng.integers(0, 6, (b, H, W)).astype(np.int32)
    return w2c, np.tile(K, (b, 1, 1)), gt, sem


# JAX cases: (n_data, n_tile, flags, iteration, with semantic labels)
CASES = {
    "2x2": (2, 2, {}, 1, False),
    "2x1": (2, 1, {}, 1, False),
    "1x2_late_sky": (1, 2, dict(semantics=True, class_dist=True, sky=True),
                     LATE_IT, True),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every sharded step of this file: JAX's on its virtual mesh, the
    port's on spawned gloo ranks (one launch per world size)."""
    root = tmp_path_factory.mktemp("shard")
    jstate = jax_state()
    jsky_p = jsky.init_sky(jax.random.PRNGKey(1))
    from streetunveiler_torch.convert import sky_from_arrays
    tsky_p = sky_from_arrays(jckpt._flatten(jsky_p, "sky"), device="cpu")

    jax_out = {}
    for name, (nd, nt, flags, it, with_sem) in CASES.items():
        b = nd
        w2c, K, gt, sem = batch(b)
        mesh = jshard.make_mesh(nd, nt)
        step = jshard.make_sharded_train_step(mesh, JOpt(), W, H, **flags)
        args = (jstate, jinit_opt(jstate), jnp.asarray(w2c), jnp.asarray(K),
                jnp.asarray(gt), jnp.zeros(3), jnp.asarray(it),
                jnp.asarray(sem) if with_sem else None)
        if flags.get("sky"):
            from streetunveiler_tpu.train.optim import adam_init
            out = step(*args, jsky_p, adam_init(jsky_p))
            jax_out[name] = (out[0], out[1], out[4])
            jax_out["sky"] = (jsky_p, out[2])
        else:
            jax_out[name] = step(*args)

    def bundle(name, b, it, with_sem, sky):
        w2c, K, gt, sem = batch(b)
        st = to_port(jstate)
        path = str(root / f"{name}.pt")
        torch.save({"state": st, "opt_state": tstep.init_optimizer(st),
                    "w2c": w2c, "K": K, "gt": gt,
                    "gt_sem": sem if with_sem else None,
                    "bg": torch.zeros(3), "iteration": it,
                    "sky": tsky_p if sky else None}, path)
        out = root / name
        out.mkdir()
        return path, str(out)

    late = dict(semantics=True, class_dist=True, sky=True)
    world = {
        4: [("2x2", 2, 2, {}, 1, False),
            ("2x2_zero", 2, 2, dict(shard_surfels=True), 1, False)],
        2: [("2x1", 2, 1, {}, 1, False),
            ("1x2_late_sky", 1, 2, late, LATE_IT, True),
            ("1x2_late_sky_replicated", 1, 2,
             dict(late, shard_preprocess=False), LATE_IT, True)],
    }
    port_dirs = {}
    for ws, cases in world.items():
        spec = []
        for name, nd, nt, flags, it, with_sem in cases:
            path, out = bundle(name, nd, it, with_sem, flags.get("sky"))
            spec.append((path, out, nd, nt, flags))
            port_dirs[name] = out
        launch_local(dryrun.run_step_bundles, ws, "cpu", (spec,))

    def load(name, rank=0):
        return torch.load(os.path.join(port_dirs[name], f"rank{rank}.pt"),
                          weights_only=False)
    return dict(jax=jax_out, load=load, ranks={n: ws for ws, cs in
                                               world.items() for n, *_ in cs},
                tsky=tsky_p)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax(runs, name):
    js, jo, jm = runs["jax"][name]
    out = runs["load"](name)
    tm, ts, to = out["metrics"], out["state"], out["opt_state"]
    keys = ["loss", "l1", "ssim", "psnr", "semantic"]
    for k in keys:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert bool(tm["overflow"]) is bool(jm["overflow"]) is False
    assert int(tm["n_alive"]) == int(jm["n_alive"])
    lrs = tstep.make_lrs(OptimizationParams(), CASES[name][3], 4.0)
    for k in PARAMS:
        mu_j = np.asarray(getattr(jo.mu, k))
        mu_t = _np(getattr(to.mu, k))
        if mu_j.size == 0:
            continue
        np.testing.assert_allclose(mu_t, mu_j, rtol=1e-3,
                                   atol=2e-4 * np.abs(mu_j).max(),
                                   err_msg=f"mu {k}")
        big = np.abs(mu_j) > 1e-3 * np.abs(mu_j).max()
        a, b = _np(getattr(ts.params, k)), np.asarray(getattr(js.params, k))
        lr = float(getattr(lrs, k))
        np.testing.assert_allclose(a[big], b[big], rtol=0,
                                   atol=1e-6 + 0.02 * lr, err_msg=k)
        assert np.abs(a - b).max() <= 2 * lr + 1e-6, k
    np.testing.assert_array_equal(_np(ts.denom), np.asarray(js.denom))
    np.testing.assert_allclose(_np(ts.max_radii2d),
                               np.asarray(js.max_radii2d), rtol=1e-5)
    # every rank ends with the same replica
    for r in range(1, runs["ranks"][name]):
        other = runs["load"](name, r)["state"]
        for k in PARAMS:
            assert torch.equal(getattr(other.params, k),
                               getattr(ts.params, k)), (r, k)


def test_sharded_late_step_trains_the_sky(runs):
    """The jointly trained sky after the 1×2 late step: Adam's first step
    moves each entry by about ±lr·sign(g), so the port's sky is within
    2·lr of JAX's and has moved."""
    from streetunveiler_torch.convert import sky_from_arrays
    _, jsky1 = runs["jax"]["sky"]
    want = sky_from_arrays(jckpt._flatten(jsky1, "sky"), device="cpu")
    got = runs["load"]("1x2_late_sky")["sky"]
    moved = False
    for (k, a), b, c in zip(got.named_tensors().items(),
                            want.named_tensors().values(),
                            runs["tsky"].named_tensors().values()):
        assert np.abs(_np(a) - _np(b)).max() <= 2e-4 + 1e-6, k
        moved = moved or not torch.equal(a, c)
    assert moved


def test_zero_matches_replicated(runs):
    rep, zero = runs["load"]("2x2"), runs["load"]("2x2_zero")
    np.testing.assert_allclose(float(zero["metrics"]["loss"]),
                               float(rep["metrics"]["loss"]), rtol=1e-6)
    for k in ("xyz", "scaling", "rotation", "opacity", "features_dc"):
        np.testing.assert_allclose(_np(getattr(zero["state"].params, k)),
                                   _np(getattr(rep["state"].params, k)),
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(_np(zero["opt_state"].mu.xyz),
                               _np(rep["opt_state"].mu.xyz), atol=1e-7)
    np.testing.assert_allclose(_np(zero["state"].grad_accum),
                               _np(rep["state"].grad_accum), atol=1e-6)
    assert zero["opt_state"].step == rep["opt_state"].step == 1


def test_shard_preprocess_matches_replicated(runs):
    """The sharded preprocess (records all-gathered over ``tile``, shifted
    to the slab) against each rank preprocessing every surfel, at
    ``tests/test_loop_sharded.py``'s tolerances for this pair."""
    shd, rep = runs["load"]("1x2_late_sky"), \
        runs["load"]("1x2_late_sky_replicated")
    for k in ("loss", "l1", "ssim", "psnr", "semantic"):
        np.testing.assert_allclose(float(shd["metrics"][k]),
                                   float(rep["metrics"][k]), rtol=2e-4,
                                   atol=1e-6, err_msg=k)
    for k in ("xyz", "scaling", "rotation", "opacity", "features_dc"):
        np.testing.assert_allclose(_np(getattr(shd["state"].params, k)),
                                   _np(getattr(rep["state"].params, k)),
                                   rtol=5e-3, atol=5e-6, err_msg=k)
    np.testing.assert_allclose(_np(shd["state"].grad_accum),
                               _np(rep["state"].grad_accum), rtol=5e-3,
                               atol=1e-7)


def test_one_by_one_matches_train_step(tmp_path):
    """A 1×1 mesh (a one-rank gloo group in this process) against the
    single-device ``train_step`` from the same state."""
    import torch.distributed as dist

    from streetunveiler_torch.parallel.multihost import bootstrap
    from streetunveiler_torch.parallel.shard import (make_mesh,
                                                     make_sharded_train_step)
    w2c, K, gt, _ = batch(1)
    opt = OptimizationParams()
    st1, st2 = to_port(jax_state()), to_port(jax_state())
    cam = Camera(w2c=torch.as_tensor(w2c[0]), K=torch.as_tensor(K[0]),
                 width=W, height=H)
    _, _, _, _, m1 = tstep.train_step(st1, tstep.init_optimizer(st1), cam,
                                      gt[0], torch.zeros(3), 1, opt,
                                      device="cpu")
    bootstrap("cpu", init_method="file://" + str(tmp_path / "store"),
              rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1, "cpu")
        step = make_sharded_train_step(mesh, opt, W, H)
        _, _, m2 = step(st2, tstep.init_optimizer(st2),
                        torch.as_tensor(w2c), torch.as_tensor(K),
                        torch.as_tensor(gt), torch.zeros(3), 1)
    finally:
        dist.destroy_process_group()
    for k in ("loss", "l1", "ssim", "psnr", "semantic"):
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=1e-5,
                                   err_msg=k)
    assert bool(m1["overflow"]) is bool(m2["overflow"]) is False
    assert int(m1["n_alive"]) == int(m2["n_alive"])
    for k in PARAMS:
        np.testing.assert_array_equal(_np(getattr(st2.params, k)),
                                      _np(getattr(st1.params, k)),
                                      err_msg=k)


def test_shift_packT_and_slab_binning_match_jax():
    jstate = jax_state(n=60, seed=4)
    st = to_port(jstate)
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[0, 3] = 0.1
    settings = RasterizeSettings(width=W, height=H, znear=0.2, zfar=100.0)
    jset = JSettings(width=W, height=H, znear=0.2, zfar=100.0)
    row0, slab = 32, 32
    targs = (st.params.xyz, st.get_scaling(), st.get_rotation(),
             st.get_opacity()[:, 0])
    jargs = (jstate.params.xyz, jstate.get_scaling(), jstate.get_rotation(),
             jstate.get_opacity()[:, 0])
    tin = tapi.bin_inputs_for_camera(*targs, torch.as_tensor(w2c),
                                     torch.as_tensor(K), settings)
    jin = japi.bin_inputs_for_camera(*jargs, jnp.asarray(w2c),
                                     jnp.asarray(K), jset)
    for a, b in zip(tin, jin):
        np.testing.assert_allclose(_np(a).astype(np.float64),
                                   np.asarray(b).astype(np.float64),
                                   rtol=1e-5, atol=1e-4)
    cap = 1024
    tb = tapi.bin_slab_from_inputs(tin, row0, W, slab, cap)
    jb = japi.bin_slab_from_inputs(jin, row0, W, slab, cap, interpret=True)
    np.testing.assert_array_equal(_np(tb.sorted_surfel),
                                  np.asarray(jb.sorted_surfel))
    np.testing.assert_array_equal(_np(tb.tile_offsets),
                                  np.asarray(jb.tile_offsets))
    assert int(tb.demand) == int(jb.demand) > 0

    # the records, shifted, against JAX's shift of the same records
    cols = torch.rand((st.capacity, 3), generator=torch.Generator()
                      .manual_seed(0))
    sur = preprocess_surfels(*targs, cols, torch.as_tensor(w2c),
                             torch.as_tensor(K), settings)
    packT = pack_geometry_T(sur, st.capacity)
    got = _np(tapi.shift_packT(packT, row0))
    want = np.asarray(japi.shift_packT(jnp.asarray(_np(packT)), row0))
    np.testing.assert_array_equal(got, want)

    # and the shifted records equal the records of the slab camera
    k_slab = torch.as_tensor(K).clone()
    k_slab[1, 2] -= row0
    sur_s = preprocess_surfels(*targs, cols, torch.as_tensor(w2c), k_slab,
                               RasterizeSettings(width=W, height=slab,
                                                 znear=0.2, zfar=100.0))
    keep = _np(sur.valid) & _np(sur_s.valid)
    np.testing.assert_allclose(got[:8, :-1][:, keep],
                               _np(pack_geometry_T(sur_s, st.capacity))
                               [:8, :-1][:, keep], rtol=1e-5, atol=1e-4)


def test_slab_renders_match_full():
    """Principal-point-shifted slab renders == the full render's rows
    (``tests/test_shard.py:36``)."""
    st = to_port(jax_state())
    K = torch.tensor([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]])
    bg = torch.tensor([0.2, 0.1, 0.0])
    full = render(Camera(w2c=torch.eye(4), K=K, width=W, height=H), st, bg,
                  device="cpu").render
    n_slab = 4
    slab = H // n_slab
    parts = []
    for i in range(n_slab):
        ki = K.clone()
        ki[1, 2] -= float(i * slab)
        parts.append(render(Camera(w2c=torch.eye(4), K=ki, width=W,
                                   height=slab), st, bg,
                            device="cpu").render)
    np.testing.assert_allclose(_np(torch.cat(parts, 0)), _np(full),
                               atol=1e-5)


def _strip_share(render_rows, n_slab, height):
    """Each slab of ``n_slab`` rendered through the shifted principal point
    against the full render's rows: per slab, the share of pixels whose
    largest colour error passes 1e-5 and 1e-4, and the largest error."""
    full = render_rows(0, height)
    out = []
    slab = height // n_slab
    for i in range(n_slab):
        e = np.abs(render_rows(i * slab, slab)
                   - full[i * slab:(i + 1) * slab]).max(-1)
        out.append(dict(over_1e5=float((e > 1e-5).mean()),
                        over_1e4=float((e > 1e-4).mean()),
                        max_abs_err=float(e.max())))
    return out


def test_slab_rounding_is_the_designs():
    """At the street's 1280 rows a shifted-K slab is not the full render's
    rows within 1e-5, in the JAX package as in the port: the crop is exact
    in real arithmetic, but slab-local coordinates round otherwise in f32.
    A 32-column strip through the centre of the 1920×1280 street camera
    (its surfels: those the strip can see), 4 slabs of 320 rows; the first
    slab is bit for bit the full rows in both, the others pass 1e-5 on a
    share of their pixels in both, the port's share within 2× JAX's, and
    neither passes ``chip_smoke.py``'s slab check (past 1e-4 on at most
    1e-3 of a slab, nowhere past 2/255). ``tests/slab_rounding_witness.py``
    prints these shares, and those of the same pixels at the full frame's
    x coordinates, as the card renders them."""
    from streetunveiler_tpu.models.gaussians import SurfelParams, SurfelState
    from streetunveiler_tpu.renderer import render as jrender
    from streetunveiler_tpu.scene.cameras import Camera as JCamera
    from streetunveiler_torch.tools import street

    sw, sh, f = 32, street.H, street.FOCAL
    st = street.street_state(street.N_SURFELS, device="cpu")
    xyz = st.params.xyz
    keep = torch.nonzero((xyz[:, 2] > 0.2) & (
        (xyz[:, 0] / xyz[:, 2]).abs() < (sw / 2 + 16) / f))[:, 0]
    p = type(st.params)(**{k: getattr(st.params, k)[keep] for k in PARAMS})
    st = dataclasses.replace(st, params=p, **{
        k: getattr(st, k)[keep] for k in ("semantics", "alive",
                                          "max_radii2d", "grad_accum",
                                          "denom")})
    j = lambda t: jnp.asarray(_np(t))
    jst = SurfelState(
        params=SurfelParams(**{k: j(getattr(p, k)) for k in PARAMS}),
        semantics=j(st.semantics), alive=j(st.alive),
        max_radii2d=j(st.max_radii2d), grad_accum=j(st.grad_accum),
        denom=j(st.denom), spatial_scale=jnp.float32(30.0))
    K = np.array([[f, 0, sw / 2], [0, f, sh / 2], [0, 0, 1]], np.float32)
    bg = np.array([0.2, 0.1, 0.0], np.float32)

    def shifted(row0):
        k = K.copy()
        k[1, 2] -= row0
        return k

    port = _strip_share(lambda r0, h: _np(render(Camera(
        w2c=torch.eye(4), K=torch.as_tensor(shifted(r0)), width=sw,
        height=h), st, torch.as_tensor(bg), device="cpu").render), 4, sh)
    jx = _strip_share(lambda r0, h: np.asarray(jrender(JCamera(
        w2c=jnp.eye(4), K=jnp.asarray(shifted(r0)), width=sw, height=h),
        jst, jnp.asarray(bg)).render), 4, sh)
    print("slab rounding, 32x1280 strip, 4 slabs:", dict(port=port, jax=jx))
    for got in (port, jx):
        assert got[0]["max_abs_err"] == 0.0
        assert all(s["over_1e4"] <= 1e-3 and s["max_abs_err"] <= 2 / 255
                   for s in got)
    share = lambda got: np.mean([s["over_1e5"] for s in got[1:]])
    assert share(jx) > 0.0, "the JAX package's slabs no longer round"
    assert share(port) <= 2.0 * share(jx), (port, jx)
