"""Port vs JAX: the gated per-class chains of the blend (K1's and K2's
plain versions) and ``rasterize(class_gates=...)``.

* ``gate_bits`` (the integer decode the CUDA kernels use) against JAX's
  floor/halve ``_gate_bits`` for every bitmask below 2^G, G = 1..6.
* ``blend_forward_plain``/``blend_backward_plain`` with gates against the
  Pallas ``blend_stream`` and its VJP (interpret mode) on identical
  records, gate rows, CSR ranges and cotangents: G = 3 at nq = 6, G = 5 at
  nq = 12 (record 24 rows, gate row 22), early termination on and off,
  and a dense-occlusion stack whose front surfels are one class, so that
  the other classes' chains outlive the main chain.
* ``rasterize(class_gates=...)`` against JAX's, forward and gradients,
  and against the port's own separately gated renders
  (``tests/test_kernel.py:124-165``).

Tolerances: accumulator channels as ``tests/test_kernel.py:46-53`` (α and
α_g 2e-5, payload 5e-5, expected depth 5e-4, m1/m2 and m1_g/m2_g 5e-5,
median 1e-5); with t_eps > 0 the trigger is a knife-edge on f32 rounding
and ≤ 0.1% of pixels may differ in lk or lk_g (those pixels are left out
of the channel checks). Record gradients per row 2e-4 of the row's
largest gradient plus 1e-3 relative, surfel gradients
``tests/test_kernel.py:86`` (atol 2e-4·max|g|, rtol 1e-3). The CUDA
kernels are held against these plain versions on a card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streetunveiler_tpu.ops.rasterizer import RasterizeSettings as JSettings
from streetunveiler_tpu.ops.rasterizer import api as japi
from streetunveiler_tpu.ops.rasterizer import kernel as jkernel
from streetunveiler_tpu.ops.rasterizer import rasterize as jrasterize
from streetunveiler_tpu.ops.rasterizer import tiles as jtiles
from streetunveiler_tpu.ops.rasterizer.preprocess import \
    preprocess_surfels as jpre
from streetunveiler_torch.ops.rasterizer import (RasterizeSettings,
                                                 cuda_lib, rasterize)
from streetunveiler_torch.ops.rasterizer import kernel as tkernel

torch.set_num_threads(1)

FLIP_FRACTION = 1e-3
TOL_MAIN = dict(payload=5e-5, alpha=2e-5, depth=5e-4, moment=5e-5)


def random_scene(n=300, seed=0, W=64, H=48, f=50.0):
    """The scene of tests/test_kernel.py:18, with random class gates
    (each bit set with probability 0.4: masks overlap, some are 0)."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                      rng.uniform(3.0, 12.0, n)], 1).astype(np.float32)
    scales = rng.uniform(0.05, 0.6, (n, 2)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.05, 0.95, n).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    gates = np.random.default_rng(seed + 11).random((n, 6)) < 0.4
    return (means, scales, quats, opac, cols), K, (W, H), gates


def dense_scene(n=700, W=64, H=48, f=60.0, seed=0):
    """A deep stack of mostly opaque surfels whose nearest third is all of
    class 0: the main chain and class 0 freeze in front, classes 1 and 2
    (the rest, at random) go on behind them."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 30.0, n)
    means = np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(-2, 2, n), z],
                     1).astype(np.float32)
    scales = rng.uniform(0.2, 0.9, (n, 2)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.5, 0.98, n).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    cls = np.where(z < np.quantile(z, 1 / 3), 0, rng.integers(1, 3, n))
    gates = np.stack([cls == g for g in range(6)], 1)
    return (means, scales, quats, opac, cols), K, (W, H), gates


SCENES = {"random": random_scene, "dense": dense_scene}


@pytest.fixture(scope="module")
def scenes():
    return {k: f() for k, f in SCENES.items()}


def _jax_stream(scene, nq, n_gates, t_eps):
    """The JAX pipeline up to the gated blend: records with the gate row
    (``encode_extra``), CSR offsets, the Pallas forward's acc/lk and a VJP
    closure, as numpy."""
    args, K, (W, H), gates = scene
    st = JSettings(width=W, height=H, t_eps=t_eps)
    jargs = tuple(jnp.asarray(a) for a in args)
    n = args[0].shape[0]
    sur = jpre(*jargs, jnp.eye(4), jnp.asarray(K), st)
    extra = None
    if nq > 6:
        extra = jnp.asarray(np.random.default_rng(7).uniform(
            0, 1, (n, nq - 6)).astype(np.float32))
    pack_extra, g = japi.encode_extra(extra, jnp.asarray(gates[:, :n_gates]))
    assert g == n_gates
    b = jtiles.bin_surfels_stream(sur.center2d, sur.ext, sur.depth,
                                  sur.valid, W, H, jkernel.TILE_W,
                                  jkernel.TILE_H,
                                  japi.default_duplicate_capacity(n, W, H),
                                  cull=sur.cull, interpret=True)
    recT = japi._gather_records(jkernel.pack_geometry_T(sur, n, pack_extra),
                                b.sorted_surfel)

    def blend(r):
        return jkernel.blend_stream(
            r, b.tile_of_visit, b.chunk_of_visit, b.first_of_tile,
            b.last_of_tile, b.init_rev, b.lane_lo, b.lane_hi,
            b.tiles_x * b.tiles_y, b.tiles_x, st, True, nq, n_gates,
            jkernel.Q_ROW0 + nq)

    (acc, lk), vjp = jax.vjp(blend, recT)
    return (np.array(recT), np.array(b.tile_offsets), b.tiles_x, b.tiles_y,
            np.array(acc), np.array(lk), vjp, RasterizeSettings(
                width=W, height=H, t_eps=t_eps))


CASES = [("random", 6, 3, 1e-4), ("random", 6, 3, 0.0),
         ("random", 12, 5, 1e-4), ("random", 12, 5, 0.0),
         ("dense", 6, 3, 1e-4), ("dense", 12, 5, 1e-4)]


@pytest.mark.parametrize("n_gates", range(1, tkernel.MAX_GATES + 1))
def test_gate_bits_match_jax(n_gates):
    row = np.arange(2 ** n_gates, dtype=np.float32)[None, :]
    want = np.stack([np.asarray(b) for b in
                     jkernel._gate_bits(jnp.asarray(row), n_gates)])
    got = tkernel.gate_bits(torch.as_tensor(row), n_gates).numpy()
    np.testing.assert_array_equal(got, want.astype(bool))


def _check_acc(acc, lk, jacc, jlk, nq, G, t_eps):
    """Every channel of the gated accumulator against the Pallas one."""
    ch = nq + 6
    assert acc.shape == jacc.shape == (jacc.shape[0], 512, ch + 4 * G)
    flips = FLIP_FRACTION if t_eps else 0.0
    lk_ok = (lk == jlk)[..., 0]
    assert 1.0 - lk_ok.mean() <= flips
    tol = ([TOL_MAIN["payload"]] * nq
           + [TOL_MAIN["alpha"], TOL_MAIN["depth"], 0.0, TOL_MAIN["moment"],
              TOL_MAIN["moment"]])
    for c in range(ch - 1):
        err = np.abs(acc[..., c] - jacc[..., c])[lk_ok]
        assert err.max() <= tol[c], (c, float(err.max()))
    # the median (tests/test_torch_blend.py's rule): 1e-5 absolute on all
    # but 0.1% of pixels, 1e-5 relative everywhere
    med, jmed = acc[..., ch - 1][lk_ok], jacc[..., ch - 1][lk_ok]
    assert (np.abs(med - jmed) > 1e-5).mean() <= FLIP_FRACTION
    np.testing.assert_allclose(med, jmed, rtol=1e-5, atol=1e-5)
    for g in range(G):
        c0 = ch + 4 * g
        lkg_ok = acc[..., c0 + 3] == jacc[..., c0 + 3]
        assert 1.0 - lkg_ok.mean() <= flips, g
        for k, t in enumerate((TOL_MAIN["alpha"], TOL_MAIN["moment"],
                               TOL_MAIN["moment"])):
            err = np.abs(acc[..., c0 + k] - jacc[..., c0 + k])[lkg_ok]
            assert err.max() <= t, (g, k, float(err.max()))


@pytest.mark.parametrize("name,nq,G,t_eps", CASES)
def test_plain_k1_gated_matches_pallas(scenes, name, nq, G, t_eps):
    recT, off, tx, ty, jacc, jlk, _, settings = _jax_stream(
        scenes[name], nq, G, t_eps)
    assert recT.shape[0] == tkernel.rec_for(nq + 1)
    cuda_lib.reset_launch_counts()
    acc, lk, counts = tkernel.blend_forward_plain(
        torch.as_tensor(recT), torch.as_tensor(off), tx, ty, settings, nq,
        G, tile_batch=4, count_pairs=True)
    assert not any(cuda_lib.launch_counts.values())
    _check_acc(acc.numpy(), lk.numpy(), jacc, jlk, nq, G, t_eps)
    # the main chain is the ungated blend
    acc0, lk0, counts0 = tkernel.blend_forward_plain(
        torch.as_tensor(recT), torch.as_tensor(off), tx, ty, settings, nq,
        count_pairs=True)
    np.testing.assert_array_equal(acc[..., :nq + 6].numpy(), acc0.numpy())
    np.testing.assert_array_equal(lk.numpy(), lk0.numpy())
    assert counts["kept"] == counts0["kept"] and counts0["gated_kept"] == 0
    assert counts["evaluated"] >= counts0["evaluated"]
    assert counts["gated_kept"] > 0
    if name == "dense":
        # the chains behind the front class outlive the main chain
        assert counts["evaluated"] > 1.1 * counts0["evaluated"]
        lkg = acc[..., nq + 6 + 7].numpy()            # class 1's lk_g
        assert (lkg > lk0[..., 0].numpy()).mean() > 0.1


def _dacc(shape, nq, G, seed=3):
    """Cotangents on every channel the backward reads; the spare, median
    and lk_g channels carry none."""
    d = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    d[..., nq + 2] = 0.0
    d[..., nq + 5] = 0.0
    for g in range(G):
        d[..., nq + 6 + 4 * g + 3] = 0.0
    return d


def assert_rows_close(got, want):
    for r in range(want.shape[0]):
        scale = np.abs(want[r]).max()
        np.testing.assert_allclose(got[r], want[r], atol=2e-4 * scale + 1e-12,
                                   rtol=1e-3, err_msg=f"record row {r}")


@pytest.mark.parametrize("name,nq,G,t_eps", CASES)
def test_plain_k2_gated_matches_pallas_vjp(scenes, name, nq, G, t_eps):
    recT, off, tx, ty, acc, lk, vjp, settings = _jax_stream(
        scenes[name], nq, G, t_eps)
    dacc = _dacc(acc.shape, nq, G)
    (want,) = vjp((jnp.asarray(dacc), np.zeros(lk.shape, jax.dtypes.float0)))
    want = np.array(want)
    got, counts = tkernel.blend_backward_plain(
        torch.as_tensor(recT), torch.as_tensor(off), tx, ty, settings,
        torch.as_tensor(acc), torch.as_tensor(lk), torch.as_tensor(dacc), nq,
        G, tile_batch=4, count_pairs=True)
    got = got.numpy()
    total = int(off[-1])
    want = want[:, :total]
    assert np.abs(want[:10 + nq]).max(axis=1).min() > 0
    assert_rows_close(got[:, :total], want)
    assert not got[:, total:].any()
    assert not got[10 + nq:].any()           # the gate row included
    assert counts["gated_kept"] > 0
    assert counts["kept"] <= counts["any_kept"] <= counts["evaluated"]
    # the gated chains' cotangents matter: without them the gradient moves
    d0 = dacc.copy()
    d0[..., nq + 6:] = 0.0
    ungated = tkernel.blend_backward_plain(
        torch.as_tensor(recT), torch.as_tensor(off), tx, ty, settings,
        torch.as_tensor(acc), torch.as_tensor(lk), torch.as_tensor(d0), nq,
        G).numpy()
    assert np.abs(ungated[:10] - got[:10]).max() > 1e-3 * np.abs(got).max()


@pytest.mark.parametrize("nq,G", [(6, 3), (12, 5)])
def test_plain_k2_gated_matches_autograd_of_plain_k1(scenes, nq, G):
    """Without early termination the keep sets are fixed, so autograd
    through the plain gated forward is the same function's VJP."""
    recT, off, tx, ty, _, _, _, settings = _jax_stream(
        scenes["random"], nq, G, 0.0)
    r = torch.as_tensor(recT).requires_grad_(True)
    offs = torch.as_tensor(off)
    acc, lk = tkernel.blend_forward_plain(r, offs, tx, ty, settings, nq, G)
    dacc = torch.as_tensor(_dacc(tuple(acc.shape), nq, G, seed=5))
    (want,) = torch.autograd.grad(acc, r, dacc)
    got = tkernel.blend_backward_plain(r.detach(), offs, tx, ty, settings,
                                       acc.detach(), lk, dacc, nq, G)
    assert_rows_close(got.numpy(), want.numpy())


def test_blend_stream_gated_runs_plain_path_on_cpu(scenes):
    """``blend_stream(n_gates > 0)`` on a CPU tensor: the plain gated
    forward and backward, no kernel launch."""
    recT, off, tx, ty, _, _, _, settings = _jax_stream(
        scenes["random"], 6, 3, 1e-4)
    r = torch.as_tensor(recT).requires_grad_(True)
    cuda_lib.reset_launch_counts()
    acc, lk = tkernel.blend_stream(r, torch.as_tensor(off), tx, ty,
                                   settings, 6, n_gates=3)
    assert acc.shape[-1] == 12 + 12
    dacc = torch.as_tensor(_dacc(tuple(acc.shape), 6, 3))
    (g,) = torch.autograd.grad(acc, r, dacc)
    want = tkernel.blend_backward_plain(r.detach(), torch.as_tensor(off), tx,
                                        ty, settings, acc.detach(), lk, dacc,
                                        6, 3)
    np.testing.assert_array_equal(g.numpy(), want.numpy())
    assert not any(cuda_lib.launch_counts.values())


@pytest.mark.parametrize("nq,error", [(5, "gated chains at nq"),
                                      (9, "gated chains at nq"),
                                      (6, "CUDA device"), (12, "CUDA device")])
def test_gated_k2_wrapper_refuses_unbuilt_widths(nq, error):
    """The gated K2 is built at nq 6 and 12 only (``GATED_NQ``): another
    width is refused before any check of the tensors, while 6 and 12 go on
    to the device check (CPU tensors here)."""
    assert tkernel.GATED_NQ == (6, 12)
    ch = tkernel.ch_for(nq) + 4 * 3
    acc = torch.zeros((1, 512, ch))
    with pytest.raises(ValueError, match=error):
        tkernel.blend_backward_cuda(
            torch.zeros((tkernel.rec_for(nq + 1), 8)),
            torch.zeros(2, dtype=torch.int32), 1, 1,
            RasterizeSettings(width=32, height=16), acc,
            torch.zeros((1, 512, 1), dtype=torch.int32), acc, nq, 3)


# ------------------------------------------------------------ rasterize

def _torch_args(scene):
    args, K, (W, H), gates = scene
    return (tuple(torch.as_tensor(a) for a in args), torch.eye(4),
            torch.as_tensor(K), RasterizeSettings(width=W, height=H))


def test_rasterize_gated_matches_jax(scenes):
    """``rasterize(class_gates=...)`` forward (class_dist and the main
    outputs) and the gradients of a loss on every output, against JAX."""
    scene = scenes["random"]
    args, K, (W, H), gates = scene
    G = 3
    jgates = jnp.asarray(gates[:, :G])
    tgates = torch.as_tensor(gates[:, :G])
    jst = JSettings(width=W, height=H)
    targs, w2c, tK, tst = _torch_args(scene)
    rng = np.random.default_rng(2)
    tgt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    wd = rng.uniform(0.5, 1.5, (H, W, G)).astype(np.float32)

    def jloss(*a):
        o = jrasterize(*a, jnp.eye(4), jnp.asarray(K), jst,
                       class_gates=jgates, interpret=True)
        return (jnp.sum((o.color - tgt) ** 2) + 0.3 * jnp.sum(o.distortion)
                + 0.5 * jnp.sum(wd * o.class_dist)), o

    (jl, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                        has_aux=True)(
        *(jnp.asarray(a) for a in args[:4]), jnp.asarray(args[4]))
    leaves = [t.clone().requires_grad_(True) for t in targs[:4]]
    out = rasterize(*leaves, targs[4], w2c, tK, tst, class_gates=tgates)
    tl = (((out.color - torch.as_tensor(tgt)) ** 2).sum()
          + 0.3 * out.distortion.sum()
          + 0.5 * (torch.as_tensor(wd) * out.class_dist).sum())
    tg = torch.autograd.grad(tl, leaves)
    assert out.class_dist.shape == (H, W, G)
    np.testing.assert_allclose(out.class_dist.detach().numpy(),
                               np.asarray(jout.class_dist), atol=5e-5)
    np.testing.assert_allclose(out.color.detach().numpy(),
                               np.asarray(jout.color), atol=5e-5)
    np.testing.assert_allclose(out.alpha.detach().numpy(),
                               np.asarray(jout.alpha), atol=2e-5)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    for name, a, b in zip(("means", "scales", "quats", "opacity"), tg, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=2e-4 * np.abs(b).max(),
                                   rtol=1e-3, err_msg=name)


def test_class_dist_parity(scenes):
    """The port's fused gated chains reproduce each class's separately
    gated render through the port's own path (opacity masked per class),
    forward and backward (``tests/test_kernel.py:124-165``)."""
    scene = scenes["random"]
    targs, w2c, K, st = _torch_args(scene)
    n = targs[0].shape[0]
    classes = np.random.default_rng(11).integers(0, 3, n)
    gates = torch.as_tensor(np.stack([classes == g for g in range(3)], 1))
    out = rasterize(*targs, w2c, K, st, class_gates=gates)
    for g in range(3):
        op_g = torch.where(gates[:, g], targs[3], torch.zeros_like(targs[3]))
        ref = rasterize(*targs[:3], op_g, targs[4], w2c, K, st)
        np.testing.assert_allclose(out.class_dist[..., g].numpy(),
                                   ref.distortion.numpy(), atol=5e-5)
    base = rasterize(*targs, w2c, K, st)
    np.testing.assert_allclose(out.color.numpy(), base.color.numpy(),
                               atol=5e-5)

    def grads(fused):
        leaves = [targs[0].clone().requires_grad_(True),
                  targs[1].clone().requires_grad_(True),
                  targs[3].clone().requires_grad_(True)]
        p, sc, op = leaves
        if fused:
            loss = rasterize(p, sc, targs[2], op, targs[4], w2c, K, st,
                             class_gates=gates).class_dist.sum()
        else:
            loss = sum(rasterize(p, sc, targs[2],
                                 torch.where(gates[:, g], op,
                                             torch.zeros_like(op)),
                                 targs[4], w2c, K, st).distortion.sum()
                       for g in range(3))
        return torch.autograd.grad(loss, leaves)

    for a, b in zip(grads(True), grads(False)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4,
                                   rtol=1e-3)
