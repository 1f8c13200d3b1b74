"""The rules of the redesigned blend kernels K1 and K2 that the host can
see, on the CPU (``csrc/blend_fwd_sm90.cuh``, ``csrc/blend_bwd_sm90.cuh``):

* The exact pair skips. K1, once a pixel's main chain is done, skips a
  duplicate whose classes' gated chains are all done; K2 evaluates a pair
  only where the main chain (index ≤ lk) or a chain of one of the
  duplicate's classes (index ≤ lk_g) still scans it. The plain versions
  with the rule applied (``skip_rule``: a skipped pair's α set to 0) give
  ``acc``, ``lk`` and the record gradients equal bit for bit to the plain
  versions without it, on the dense-occlusion gated stack and on the
  600-surfel miniature of the street (``tools/street.MINI``), and the rule
  skips a nonzero share of the pairs the first design evaluated.
* ``tiles.tile_order``: a permutation of the tiles, descending in
  duplicate count, stable on ties.
* K2's warp reduce-scatter: a numpy model over 32 lanes of random f32
  values gives each value's sum with the bits of the xor-butterfly
  all-reduce of the first design.

The kernels themselves are held bit for bit against the first design by
``chip_smoke.py`` on a card.
"""

import numpy as np
import pytest
import torch

from streetunveiler_torch.ops.rasterizer import kernel, tiles
from streetunveiler_torch.tools import bisect_bwd, street

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def streams():
    """Blend arguments: the dense stack and the miniature street, each
    with the late step's records (nq 12, G 5) and the photometric ones
    (nq 6, no gates)."""
    dense = street.dense_streams("cpu")
    mini = street.MINI
    state = street.street_state(mini["n"], device="cpu", scale=mini["scale"])
    cam = street.street_camera("cpu", mini["width"], mini["height"],
                               mini["focal"])
    return {("dense", 5): dense[5], ("dense", 0): dense[0],
            ("mini", 5): street.street_stream(state, cam, late=True,
                                              device="cpu"),
            ("mini", 0): street.street_stream(state, cam, device="cpu")}


@pytest.mark.parametrize("scene", ["dense", "mini"])
@pytest.mark.parametrize("gates", [5, 0])
def test_k1_skip_rule_is_exact(streams, scene, gates):
    args = streams[scene, gates]
    acc, lk, counts = kernel.blend_forward_plain(*args, count_pairs=True)
    acc_s, lk_s, counts_s = kernel.blend_forward_plain(
        *args, count_pairs=True, skip_rule=True)
    assert torch.equal(acc, acc_s) and torch.equal(lk, lk_s)
    assert counts_s == counts
    if gates:
        # the gated chains keep pixels live past their main chain, and
        # most of those pairs belong to no live chain
        assert 0 < counts["evaluated_skip_rule"] < counts["evaluated"]
        assert counts["gated_kept"] > 0
    else:
        # the ungated kernel stops a pixel at its chain's end already
        assert counts["evaluated_skip_rule"] == counts["evaluated"]


@pytest.mark.parametrize("scene", ["dense", "mini"])
@pytest.mark.parametrize("gates", [5, 0])
def test_k2_skip_rule_is_exact(streams, scene, gates):
    recT, off, tx, ty, settings, nq, n_gates = streams[scene, gates]
    acc, lk = kernel.blend_forward_plain(recT, off, tx, ty, settings, nq,
                                         n_gates)
    args = (recT, off, tx, ty, settings, acc, lk,
            bisect_bwd.cotangents(acc, nq, n_gates), nq, n_gates)
    d, counts = kernel.blend_backward_plain(*args, count_pairs=True)
    d_s, counts_s = kernel.blend_backward_plain(*args, count_pairs=True,
                                                skip_rule=True)
    assert torch.equal(d, d_s)
    assert counts_s == counts
    assert bool(d[:10 + nq].any())
    assert 0 < counts["any_kept"] <= counts["evaluated_skip_rule"]
    if gates:
        # pixels scan to their deepest chain, most pairs on the way belong
        # to no chain that keeps them
        assert counts["evaluated_skip_rule"] < counts["evaluated"]
    else:
        # without gates the scan already starts at each pixel's lk
        assert counts["evaluated_skip_rule"] == counts["evaluated"]


def _reference_order(lengths):
    return sorted(range(len(lengths)), key=lambda t: (-lengths[t], t))


def test_tile_order_is_stable_descending_permutation(streams):
    rng = np.random.default_rng(0)
    # ties on purpose: lengths from a small range, empty tiles included
    lengths = rng.integers(0, 6, 300)
    off = torch.as_tensor(np.concatenate([[0], np.cumsum(lengths)]),
                          dtype=torch.int32)
    order = tiles.tile_order(off)
    assert order.dtype == torch.int32 and order.shape == (300,)
    assert order.tolist() == _reference_order(lengths.tolist())
    for key in (("dense", 5), ("mini", 0)):
        off = streams[key][1]
        n = off.numel() - 1
        order = tiles.tile_order(off)
        lengths = (off[1:] - off[:-1]).tolist()
        assert sorted(order.tolist()) == list(range(n))
        assert order.tolist() == _reference_order(lengths)
        got = [lengths[t] for t in order.tolist()]
        assert got == sorted(got, reverse=True) and got[0] > got[-1]


def test_binning_carries_the_tile_order(streams):
    """``bin_surfels_stream`` computes the order once, for K1 and K2."""
    from streetunveiler_torch.ops.rasterizer.preprocess import \
        preprocess_surfels
    from streetunveiler_torch.ops.rasterizer.api import \
        default_duplicate_capacity
    mini = street.MINI
    pts, scales, quats, opac, cols, _ = street.build_scene(mini["n"])
    t = [torch.as_tensor(a) for a in (pts, scales * np.float32(mini["scale"]),
                                      quats, opac, cols)]
    cam = street.street_camera("cpu", mini["width"], mini["height"],
                               mini["focal"])
    from streetunveiler_torch.ops.rasterizer import RasterizeSettings
    st = RasterizeSettings(width=mini["width"], height=mini["height"])
    sur = preprocess_surfels(*t, cam.w2c, cam.K, st)
    b = tiles.bin_surfels_stream(
        sur.center2d, sur.ext, sur.depth, sur.valid, st.width, st.height,
        kernel.TILE_W, kernel.TILE_H,
        default_duplicate_capacity(mini["n"], st.width, st.height),
        cull=sur.cull)
    assert torch.equal(b.tile_order, tiles.tile_order(b.tile_offsets))


def test_tile_order_argument_is_checked():
    """The CUDA wrappers take only a contiguous int32 [T] order on the
    offsets' device; None (no binning's order) and every other order are
    refused before anything launches. An entry that names no tile is the
    kernels' own guard (``chip_smoke.py``'s ``tile_order_guard``)."""
    dev = torch.device("cpu")
    order = torch.tensor([2, 0, 1], dtype=torch.int32)
    kernel._check_order(order, 3, dev)
    for bad in (None, order.long(), order[:2], order.to("meta"),
                torch.tensor([0, 1, 2, 3, 4, 5], dtype=torch.int32)[::2]):
        with pytest.raises(ValueError, match="tile_order"):
            kernel._check_order(bad, 3, dev)


@pytest.mark.parametrize("variant, nq, n_gates, error", [
    ("full", 12, 0, "CUDA device"), ("floor", 12, 0, "built at"),
    ("full", 9, 0, "built at"), ("floor", 6, 0, "CUDA device")])
def test_t2_builds_full_alone_at_the_semantic_width(variant, nq, n_gates,
                                                    error):
    """The first design of K2 is built at (12, 0) too, for the semantic
    step's comparison, in the ``full`` variant only: another variant there
    is refused before any check of the tensors, ``full`` goes on to the
    device check (CPU tensors here)."""
    acc = torch.zeros((1, kernel.PIX, kernel.ch_for(nq)))
    with pytest.raises(ValueError, match=error):
        bisect_bwd.bisect_backward_cuda(
            variant, torch.zeros((kernel.rec_for(nq), 128)),
            torch.zeros(2, dtype=torch.int32), 1, 1,
            kernel.RasterizeSettings(width=32, height=16), acc,
            torch.zeros((1, kernel.PIX, 1), dtype=torch.int32), acc, nq,
            n_gates)


def test_gated_k1_wrapper_refuses_unbuilt_widths():
    """Gated K1 is built at nq 6 and 12, as gated K2: other widths raise
    before anything launches (here before the device check)."""
    r = torch.zeros((kernel.rec_for(10), 128))
    off = torch.zeros(2, dtype=torch.int32)
    settings = kernel.RasterizeSettings(width=32, height=16)
    with pytest.raises(ValueError, match="nq in"):
        kernel.blend_forward_cuda(r, off, 1, 1, settings, 9, 2)
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.blend_forward_cuda(r, off, 1, 1, settings, 6, 2)


def _butterfly(x):
    """The first design's all-reduce: each lane adds its xor partner's
    running sum, offsets 16, 8, 4, 2, 1; returns lane 0's sums [V]."""
    y = x.copy()
    for o in (16, 8, 4, 2, 1):
        y = (y + y[np.arange(32) ^ o]).astype(np.float32)
    return y[0]


def _reduce_scatter(x):
    """The redesign's reduce-scatter: each lane holds 32 values (zero past
    V); at offset o it keeps half its first 2o values (the upper half if
    lane bit o is set), sends the other half, and adds the partner's copy
    of the half it keeps. Returns [32]: lane i's value i."""
    lanes = np.arange(32)
    v = np.zeros((32, 32), np.float32)
    v[:, :x.shape[1]] = x
    for o in (16, 8, 4, 2, 1):
        hi = (lanes & o) != 0
        lo_half, hi_half = v[:, :o], v[:, o:2 * o]
        send = np.where(hi[:, None], lo_half, hi_half)
        mine = np.where(hi[:, None], hi_half, lo_half)
        v = v.copy()
        v[:, :o] = (mine + send[lanes ^ o]).astype(np.float32)
    return v[:, 0]


@pytest.mark.parametrize("n_values", [20, 26, 30])
def test_reduce_scatter_has_the_butterflys_bits(n_values):
    """V = 14 + nq values (20 at nq 6, 26 at nq 12) over 32 lanes of
    random f32 values with a wide range of magnitudes, so that the order
    of the additions shows in the last bits."""
    rng = np.random.default_rng(n_values)
    diff_from_serial = 0
    for _ in range(50):
        x = (rng.normal(size=(32, n_values))
             * 10.0 ** rng.integers(-6, 6, (32, n_values))).astype(
                 np.float32)
        x[rng.random((32, n_values)) < 0.3] = 0.0    # lanes that kept none
        want = _butterfly(x)
        got = _reduce_scatter(x)[:n_values]
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        serial = np.zeros(n_values, np.float32)
        for lane in range(32):
            serial = (serial + x[lane]).astype(np.float32)
        diff_from_serial += int((serial != want).sum())
    # another tree (a serial sum over the lanes) gives other bits
    assert diff_from_serial > 0
