"""Port vs JAX: the blend backward (K2's plain version).

* ``blend_backward_plain`` against the Pallas ``blend_stream``'s VJP
  (interpret mode) on identical records, CSR ranges, forward residuals
  (the JAX forward's acc and lk) and cotangents, at nq 6 and 12, with
  early termination on and off.
* ``blend_backward_plain`` against autograd through
  ``blend_forward_plain``, and ``blend_stream``'s backward on a CPU
  tensor.

Tolerance per record row: 2e-4 of the row's largest gradient plus 1e-3
relative (``tests/test_kernel.py:86`` applied row by row): both sides sum
f32 terms that cancel, in another order. The CUDA kernel is held against
this plain version on a card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streetunveiler_tpu.ops.rasterizer import RasterizeSettings as JSettings
from streetunveiler_tpu.ops.rasterizer import api as japi
from streetunveiler_tpu.ops.rasterizer import kernel as jkernel
from streetunveiler_tpu.ops.rasterizer import tiles as jtiles
from streetunveiler_tpu.ops.rasterizer.preprocess import \
    preprocess_surfels as jpre
from streetunveiler_torch.ops.rasterizer import RasterizeSettings, cuda_lib
from streetunveiler_torch.ops.rasterizer import kernel as tkernel

torch.set_num_threads(1)



def random_scene(n=300, seed=0, W=64, H=48, f=50.0):
    """The scene of tests/test_kernel.py:18."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                      rng.uniform(3.0, 12.0, n)], 1).astype(np.float32)
    scales = rng.uniform(0.05, 0.6, (n, 2)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.05, 0.95, n).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return (means, scales, quats, opac, cols), K, (W, H)


# ------------------------------------------------------------ blend level

def _jax_stream(scene, nq, t_eps):
    """The JAX pipeline up to the blend: records, CSR offsets, the Pallas
    forward's acc/lk and a VJP closure, as numpy."""
    args, K, (W, H) = scene
    st = JSettings(width=W, height=H, t_eps=t_eps)
    jargs = tuple(jnp.asarray(a) for a in args)
    n = args[0].shape[0]
    sur = jpre(*jargs, jnp.eye(4), jnp.asarray(K), st)
    extra = None
    if nq > 6:
        extra = jnp.asarray(np.random.default_rng(7).uniform(
            0, 1, (n, nq - 6)).astype(np.float32))
    b = jtiles.bin_surfels_stream(sur.center2d, sur.ext, sur.depth,
                                  sur.valid, W, H, jkernel.TILE_W,
                                  jkernel.TILE_H,
                                  japi.default_duplicate_capacity(n, W, H),
                                  cull=sur.cull, interpret=True)
    recT = japi._gather_records(jkernel.pack_geometry_T(sur, n, extra),
                                b.sorted_surfel)

    def blend(r):
        return jkernel.blend_stream(
            r, b.tile_of_visit, b.chunk_of_visit, b.first_of_tile,
            b.last_of_tile, b.init_rev, b.lane_lo, b.lane_hi,
            b.tiles_x * b.tiles_y, b.tiles_x, st, True, nq)

    (acc, lk), vjp = jax.vjp(blend, recT)
    return (np.array(recT), np.array(b.tile_offsets), b.tiles_x, b.tiles_y,
            np.array(acc), np.array(lk), vjp)


def _dacc(shape, nq, seed=3):
    """Cotangents on every channel the backward reads (payload, alpha,
    depth, m1, m2); the spare and median channels carry no gradient."""
    d = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    d[..., nq + 2] = 0.0
    d[..., nq + 5] = 0.0
    return d


def assert_rows_close(got, want):
    for r in range(want.shape[0]):
        scale = np.abs(want[r]).max()
        np.testing.assert_allclose(got[r], want[r], atol=2e-4 * scale + 1e-12,
                                   rtol=1e-3, err_msg=f"record row {r}")


@pytest.fixture(scope="module")
def scene():
    return random_scene()


@pytest.mark.parametrize("nq,t_eps", [(6, 1e-4), (6, 0.0), (12, 1e-4),
                                      (12, 0.0)])
def test_plain_k2_matches_pallas_vjp(scene, nq, t_eps):
    recT, off, tiles_x, tiles_y, acc, lk, vjp = _jax_stream(scene, nq, t_eps)
    dacc = _dacc(acc.shape, nq)
    (want,) = vjp((jnp.asarray(dacc), np.zeros(lk.shape, jax.dtypes.float0)))
    want = np.array(want)
    settings = RasterizeSettings(width=64, height=48, t_eps=t_eps)
    cuda_lib.reset_launch_counts()
    got = tkernel.blend_backward_plain(
        torch.as_tensor(recT), torch.as_tensor(off), tiles_x, tiles_y,
        settings, torch.as_tensor(acc), torch.as_tensor(lk),
        torch.as_tensor(dacc), nq, tile_batch=4)
    assert cuda_lib.launch_counts["blend_bwd"] == 0
    got = got.numpy()
    assert got.shape == want.shape == recT.shape
    # the Pallas kernel leaves the chunks it never visits (past the
    # stream's end) unwritten; the port zeroes them
    total = int(off[-1])
    want = want[:, :total]
    assert np.abs(want[:10 + nq]).max(axis=1).min() > 0
    assert_rows_close(got[:, :total], want)
    assert not got[:, total:].any()
    assert not got[10 + nq:].any()


@pytest.mark.parametrize("nq", [6, 12])
def test_plain_k2_matches_autograd_of_plain_k1(scene, nq):
    """Without early termination the keep set is fixed, so autograd
    through the plain forward is the same function's VJP."""
    args, K, (W, H) = scene
    recT, off, tiles_x, tiles_y, _, _, _ = _jax_stream(scene, nq, 0.0)
    settings = RasterizeSettings(width=W, height=H, t_eps=0.0)
    r = torch.as_tensor(recT).requires_grad_(True)
    offs = torch.as_tensor(off)
    acc, lk = tkernel.blend_forward_plain(r, offs, tiles_x, tiles_y,
                                          settings, nq)
    dacc = torch.as_tensor(_dacc(tuple(acc.shape), nq, seed=5))
    (want,) = torch.autograd.grad(acc, r, dacc)
    got = tkernel.blend_backward_plain(r.detach(), offs, tiles_x, tiles_y,
                                       settings, acc.detach(), lk, dacc, nq)
    assert_rows_close(got.numpy(), want.numpy())


def test_plain_k2_counts_kept_pairs(scene):
    """``count_pairs`` returns the same gradients and the number of pairs
    with α > 0 at or before the pixel's ``lk``, counted here tile by tile
    over the whole range at once (the plain version walks 128-duplicate
    chunks of 4-tile batches)."""
    from streetunveiler_torch.ops.rasterizer.blendmath import \
        pair_alpha_depth
    recT, off, tiles_x, tiles_y, acc, lk, _ = _jax_stream(scene, 6, 1e-4)
    settings = RasterizeSettings(width=64, height=48)
    dacc = _dacc(acc.shape, 6)
    args = (torch.as_tensor(recT), torch.as_tensor(off), tiles_x, tiles_y,
            settings, torch.as_tensor(acc), torch.as_tensor(lk),
            torch.as_tensor(dacc), 6)
    got, counts = tkernel.blend_backward_plain(*args, tile_batch=4,
                                               count_pairs=True)
    kept = counts["kept"]
    np.testing.assert_array_equal(
        got.numpy(), tkernel.blend_backward_plain(*args).numpy())
    pix = torch.arange(tkernel.PIX)
    want = 0
    for t in range(tiles_x * tiles_y):
        idx = torch.arange(int(off[t]), int(off[t + 1]))
        r = torch.as_tensor(recT)[:, idx][..., None]          # [rec, S, 1]
        px = (t % tiles_x) * tkernel.TILE_W + pix % tkernel.TILE_W + 0.5
        py = (t // tiles_x) * tkernel.TILE_H + pix // tkernel.TILE_W + 0.5
        c2dx, c2dy, z = r[6], r[7], r[8]
        a, _ = pair_alpha_depth(
            (r[0], r[3], c2dx * z, r[1], r[4], c2dy * z, r[2], r[5], z),
            (c2dx, c2dy), z, r[9], r[9] > 0.0, px.float(), py.float(),
            settings.znear)
        lk_t = torch.as_tensor(lk[t, :, 0]).long()
        want += int(((a > 0.0) & (idx[:, None] <= lk_t[None, :])).sum())
    assert 0 < kept == want == counts["any_kept"]
    assert counts["gated_kept"] == 0 and counts["evaluated"] > kept


def test_blend_stream_backward_runs_k2_path_on_cpu(scene):
    """``blend_stream`` is differentiable: its backward is the plain K2 on
    a CPU tensor (no launch); with gated chains the main chain's channels
    are the ungated ones."""
    recT, off, tiles_x, tiles_y, _, _, _ = _jax_stream(scene, 6, 1e-4)
    settings = RasterizeSettings(width=64, height=48)
    r = torch.as_tensor(recT).requires_grad_(True)
    cuda_lib.reset_launch_counts()
    acc, lk = tkernel.blend_stream(r, torch.as_tensor(off), tiles_x,
                                   tiles_y, settings, 6)
    dacc = torch.as_tensor(_dacc(tuple(acc.shape), 6))
    (g,) = torch.autograd.grad(acc, r, dacc)
    want = tkernel.blend_backward_plain(r.detach(), torch.as_tensor(off),
                                        tiles_x, tiles_y, settings,
                                        acc.detach(), lk, dacc, 6)
    np.testing.assert_array_equal(g.numpy(), want.numpy())
    assert not any(cuda_lib.launch_counts.values())
    assert not lk.requires_grad
    # gated chains read their class bitmask from the row after the
    # payload: append one
    r2 = torch.cat([r.detach(), torch.full_like(r[:1], 3.0)])
    acc2, lk2 = tkernel.blend_stream(r2, torch.as_tensor(off), tiles_x,
                                     tiles_y, settings, 6, n_gates=2)
    assert acc2.shape[-1] == 12 + 8
    np.testing.assert_array_equal(acc2[..., :12].numpy(), acc.detach().numpy())
    np.testing.assert_array_equal(lk2.numpy(), lk.numpy())
