"""Port vs JAX: the blend forward (K1's plain version) and ``rasterize``.

* On identical records and CSR ranges (the JAX binning and gather, as
  numpy), ``blend_forward_plain`` against the Pallas ``blend_stream``
  (interpret mode): every accumulator channel and ``lk``, at nq=6 and
  nq=9, with and without early termination.
* ``rasterize`` (preprocess → binning → plain K1 → assembly) against JAX
  ``rasterize(interpret=True)`` and against the port's untiled oracle,
  on the kernel-test scene, on a dense occlusion stack and with empty
  tiles.

Tolerances are those of ``tests/test_kernel.py``: α 2e-5, color 5e-5,
expected depth 5e-4, normal 5e-5, distortion 5e-5, median 1e-5. With
early termination on, the trigger ``T·(1−α) < t_eps`` is a knife-edge on
f32 rounding and flips at a few pixels when T is computed in another
order (log-space prefix on the TPU, cumprod here); ≤ 0.1% of pixels may
then differ. With t_eps=0 ``lk`` must agree except where a pair's α sits
on the 1/255 threshold. The CUDA kernel is held against this plain
version on a card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streetunveiler_tpu.ops.rasterizer import RasterizeSettings as JSettings
from streetunveiler_tpu.ops.rasterizer import api as japi
from streetunveiler_tpu.ops.rasterizer import kernel as jkernel
from streetunveiler_tpu.ops.rasterizer import rasterize as jrasterize
from streetunveiler_tpu.ops.rasterizer import rasterize_oracle as joracle
from streetunveiler_tpu.ops.rasterizer import tiles as jtiles
from streetunveiler_tpu.ops.rasterizer.preprocess import \
    preprocess_surfels as jpre
from streetunveiler_torch import trace
from streetunveiler_torch.ops.rasterizer import (RasterizeSettings, rasterize,
                                                 rasterize_oracle)
from streetunveiler_torch.ops.rasterizer import kernel as tkernel

torch.set_num_threads(1)

TOL = dict(color=5e-5, alpha=2e-5, expected_depth=5e-4, normal=5e-5,
           distortion=5e-5, median_depth=1e-5)
FLIP_FRACTION = 1e-3


def random_scene(n=300, seed=0, W=64, H=48, f=50.0, zspread=(3.0, 12.0)):
    rng = np.random.default_rng(seed)
    means = np.stack([
        rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
        rng.uniform(*zspread, n)], axis=1).astype(np.float32)
    scales = rng.uniform(0.05, 0.6, (n, 2)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.05, 0.95, n).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return (means, scales, quats, opac, cols), np.eye(4, dtype=np.float32), \
        K, (W, H)


def dense_scene(n=1500, W=128, H=96, f=110.0, seed=0):
    """Deep stack of mostly-opaque surfels: most pixels terminate early."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(-2, 2, n),
                      rng.uniform(2.0, 30.0, n)], 1).astype(np.float32)
    scales = rng.uniform(0.2, 0.9, (n, 2)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.5, 0.98, n).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return (means, scales, quats, opac, cols), np.eye(4, dtype=np.float32), \
        K, (W, H)


def to_torch(scene, **settings):
    args, w2c, K, (W, H) = scene
    return (tuple(torch.as_tensor(a) for a in args), torch.as_tensor(w2c),
            torch.as_tensor(K), RasterizeSettings(width=W, height=H,
                                                  **settings))


def to_jax(scene, **settings):
    args, w2c, K, (W, H) = scene
    return (tuple(jnp.asarray(a) for a in args), jnp.asarray(w2c),
            jnp.asarray(K), JSettings(width=W, height=H, **settings))


def compare(ref, out, fields=tuple(TOL), flips=0.0):
    """Each field within its tolerance on all but ``flips`` of pixels."""
    for f in fields:
        a = np.asarray(getattr(ref, f))
        b = getattr(out, f).numpy() if torch.is_tensor(getattr(out, f)) \
            else np.asarray(getattr(out, f))
        assert a.shape == b.shape, f
        bad = np.abs(a - b) > TOL[f]
        if bad.ndim == 3:
            bad = bad.any(axis=-1)
        assert bad.mean() <= flips, (f, int(bad.sum()),
                                     float(np.abs(a - b).max()))


@pytest.fixture(scope="module")
def scene():
    return random_scene()


def test_rasterize_matches_jax_and_oracle(scene):
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jargs, jw2c, jK, jst = to_jax(scene)
    targs, tw2c, tK, tst = to_torch(scene)
    jout = jrasterize(*jargs, jw2c, jK, jst, bg=jnp.asarray(bg),
                      interpret=True)
    out = rasterize(*targs, tw2c, tK, tst, bg=torch.as_tensor(bg))
    ref = rasterize_oracle(*targs, tw2c, tK, tst, bg=torch.as_tensor(bg),
                           chunk_surfels=64, pixel_block=1024)
    # the port's tiled path against its own untiled oracle: same
    # preprocess, so everywhere within tolerance
    compare(ref, out)
    np.testing.assert_array_equal(out.radii.numpy(), ref.radii.numpy())
    # against JAX: the preprocess sums its 3-wide contractions in another
    # order, and the ulps move the median of a few pixels slightly
    compare(jout, out, fields=[f for f in TOL if f != "median_depth"])
    assert_median_close(out.median_depth.numpy(),
                        np.asarray(jout.median_depth))
    assert int(out.demand) == int(jout.demand)
    assert not bool(out.overflow)
    assert float(out.alpha.max()) > 0.5


def _jax_stream(scene, nq, t_eps):
    """Records, CSR offsets, and the Pallas blend's (acc, lk), as numpy."""
    jargs, jw2c, jK, jst = to_jax(scene, t_eps=t_eps)
    n = jargs[0].shape[0]
    sur = jpre(*jargs, jw2c, jK, jst)
    extra = None
    if nq > 6:
        extra = jnp.asarray(np.random.default_rng(7).uniform(
            0, 1, (n, nq - 6)).astype(np.float32))
    b = jtiles.bin_surfels_stream(sur.center2d, sur.ext, sur.depth,
                                  sur.valid, jst.width, jst.height,
                                  jkernel.TILE_W, jkernel.TILE_H,
                                  japi.default_duplicate_capacity(
                                      n, jst.width, jst.height),
                                  cull=sur.cull, interpret=True)
    recT = japi._gather_records(jkernel.pack_geometry_T(sur, n, extra),
                                b.sorted_surfel)
    acc, lk = jkernel.blend_stream(
        recT, b.tile_of_visit, b.chunk_of_visit, b.first_of_tile,
        b.last_of_tile, b.init_rev, b.lane_lo, b.lane_hi,
        b.tiles_x * b.tiles_y, b.tiles_x, jst, True, nq)
    return (np.array(recT), np.array(b.tile_offsets), b.tiles_x, b.tiles_y,
            np.array(acc), np.array(lk))


@pytest.mark.parametrize("nq,t_eps", [(6, 1e-4), (6, 0.0), (9, 1e-4)])
def test_plain_k1_matches_pallas_blend(scene, nq, t_eps):
    recT, off, tiles_x, tiles_y, jacc, jlk = _jax_stream(scene, nq, t_eps)
    settings = RasterizeSettings(width=64, height=48, t_eps=t_eps)
    trace.reset_launch_counts()
    acc, lk = tkernel.blend_forward_plain(
        torch.as_tensor(recT), torch.as_tensor(off), tiles_x, tiles_y,
        settings, nq, tile_batch=4)
    assert trace.launch_counts["blend_fwd"] == 0
    acc, lk = acc.numpy(), lk.numpy()
    assert acc.shape == jacc.shape == (tiles_x * tiles_y, 512, nq + 6)
    lk_ok = lk == jlk
    # without termination no knife-edge remains (and no pair of this
    # scene sits on the 1/255 threshold): lk is exact
    assert 1.0 - lk_ok.mean() <= (FLIP_FRACTION if t_eps else 0.0)
    same = lk_ok[..., 0]
    tol = [5e-5] * nq + [2e-5, 5e-4, 0.0, 5e-5, 5e-5]
    for c in range(nq + 5):
        err = np.abs(acc[..., c] - jacc[..., c])[same]
        assert err.max() <= tol[c], (c, float(err.max()))
    assert_median_close(acc[..., nq + 5][same], jacc[..., nq + 5][same])


def assert_median_close(got, want):
    """Median depth: 1e-5 absolute on all but 0.1% of pixels, 1e-5
    relative everywhere (the median is the intersection depth t = det/kz
    of one pair, and XLA and torch round det and kz differently)."""
    err = np.abs(got - want)
    assert (err > TOL["median_depth"]).mean() <= FLIP_FRACTION
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=TOL["median_depth"])


def test_rasterize_extra_payload_nq9(scene):
    """nq=9 (the semantic render's payload) through ``rasterize``: the
    extra channels blend like color does, against the oracle rendering
    those channels as color."""
    targs, tw2c, tK, tst = to_torch(scene)
    n = targs[0].shape[0]
    extra = torch.as_tensor(np.random.default_rng(7).uniform(
        0, 1, (n, 3)).astype(np.float32))
    out = rasterize(*targs, tw2c, tK, tst, extra_payload=extra)
    assert out.extra.shape == (48, 64, 3)
    ref = rasterize_oracle(*targs[:4], extra, tw2c, tK, tst)
    np.testing.assert_allclose(out.extra.numpy(), ref.color.numpy(),
                               atol=5e-5)
    base = rasterize(*targs, tw2c, tK, tst)
    np.testing.assert_allclose(out.color.numpy(), base.color.numpy(),
                               atol=5e-5)


@pytest.mark.parametrize("t_eps", [1e-4, 0.0])
def test_dense_occlusion(t_eps):
    """~Dozens of opaque layers per pixel: the early-termination path.
    Against the port's oracle and the JAX oracle."""
    scene = dense_scene()
    targs, tw2c, tK, tst = to_torch(scene, t_eps=t_eps)
    jargs, jw2c, jK, jst = to_jax(scene, t_eps=t_eps)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    out = rasterize(*targs, tw2c, tK, tst, bg=torch.as_tensor(bg))
    ref = rasterize_oracle(*targs, tw2c, tK, tst, bg=torch.as_tensor(bg))
    jref = joracle(*jargs, jw2c, jK, jst, bg=jnp.asarray(bg))
    flips = FLIP_FRACTION if t_eps else 0.0
    compare(ref, out, flips=flips)
    compare(jref, out, flips=FLIP_FRACTION)
    assert float(out.alpha.mean()) > 0.9
    if t_eps:
        # termination really happened: the deep stack stops near 1 − t_eps
        assert float(out.alpha.max()) < 1.0 - 0.5 * t_eps


def test_empty_tiles_are_zero():
    """Tiles with no duplicates come back as exact zeros, lk −1."""
    args, w2c, K, _ = random_scene(n=40, W=128, H=96)
    means = args[0].copy()
    means[:, 0] = -np.abs(means[:, 0]) * 0.5 - 1.0
    means[:, 1] = -np.abs(means[:, 1]) * 0.5 - 1.0
    scene = ((means,) + args[1:], w2c, K, (128, 96))
    targs, tw2c, tK, tst = to_torch(scene)
    out = rasterize(*targs, tw2c, tK, tst)
    ref = rasterize_oracle(*targs, tw2c, tK, tst)
    compare(ref, out)
    assert float(out.color[60:, 80:].abs().max()) == 0.0
    assert float(out.alpha[60:, 80:].abs().max()) == 0.0
    assert float(out.alpha.max()) > 0.5


def test_refusals(scene):
    """A non-RGB colour width is refused; gated chains run (with every
    surfel in both classes, each class's distortion is the main one); the
    backward (K2's plain version here) runs and reaches the colours."""
    targs, tw2c, tK, tst = to_torch(scene)
    gates = torch.ones((targs[0].shape[0], 2), dtype=torch.bool)
    out = rasterize(*targs, tw2c, tK, tst, class_gates=gates)
    for g in range(2):
        np.testing.assert_allclose(out.class_dist[..., g].numpy(),
                                   out.distortion.numpy(), atol=5e-5)
    cols = targs[4].clone().requires_grad_(True)
    out = rasterize(*targs[:4], cols, tw2c, tK, tst)
    out.color.sum().backward()
    assert torch.isfinite(cols.grad).all() and cols.grad.abs().max() > 0
    with pytest.raises(ValueError):
        rasterize(*targs[:4], torch.zeros((targs[0].shape[0], 4)), tw2c, tK,
                  tst)
