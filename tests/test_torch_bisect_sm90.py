"""T2 on K2's H100 design: the plain versions of the bisection variants
with the redesign's batch of 64 and its exact pair skip
(``bisect_bwd.DESIGNS["sm90"]``).

* With the first design's settings (batch 32, no skip) every plain variant
  gives what it gave before the designs were told apart: the floor is held
  to a frozen copy of its earlier formula, bit for bit.
* The stand-ins act on kept pairs only, so every variant but the floor
  gives the same bits under both designs' settings; the pairs each design
  evaluates are the production plain K2's counts.
* The sm90 ``full`` equals the production plain K2 and the JAX tool's
  ``full`` (its Pallas kernel in interpret mode).
* On a small hand-built stack, the floor at batch 64 with the skip gives
  each pixel's own walk: a serial f32 loop of the kernel's per-pixel
  arithmetic (fl += opacity·U, U *= 0.999 over the pairs the pixel
  evaluates, slot p of a batch stored from pixel p).

The kernels themselves are held against these plain versions, and ``full``
against the production K2 bit for bit, on a card by ``chip_smoke.py``
(``bisect_bwd_sm90``).
"""

import os
import sys

import numpy as np
import pytest
import torch

from streetunveiler_torch import trace
from streetunveiler_torch.ops.rasterizer import (RasterizeSettings, kernel,
                                                 tiles)
from streetunveiler_torch.tools import bisect_bwd, street

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_bisect import _jax_bwd, interpret, stream  # noqa: E402,F401

torch.set_num_threads(1)

FIRST, SM90 = bisect_bwd.DESIGNS["first"], bisect_bwd.DESIGNS["sm90"]


def _floor_before(recT, off, top_all, nq):
    """The first design's floor as the plain version computed it before the
    designs were told apart (batch 32, every pixel alike)."""
    dev = recT.device
    n_tiles = off.numel() - 1
    starts = off[:-1]
    n_walk = (top_all - starts).clamp(min=0)
    drecT = torch.zeros(recT.shape, dtype=torch.float32, device=dev)
    total = int(n_walk.sum())
    if total:
        longest = int(n_walk.max())
        decay = torch.as_tensor(np.concatenate([[1.0], np.multiply.accumulate(
            np.full(longest - 1, 0.999, np.float32))]).astype(np.float32),
            device=dev)
        tile = torch.repeat_interleave(torch.arange(n_tiles, device=dev),
                                       n_walk)
        first = torch.cumsum(n_walk, 0) - n_walk
        k = torch.arange(total, device=dev) - first[tile]
        slot = top_all[tile] - 1 - k
        c = (recT[9, slot] * decay[k]).to(torch.float64)
        csum = torch.cumsum(c, 0)
        base = csum[first[tile]] - c[first[tile]]
        k_end = torch.minimum((k // 32 + 1) * 32, n_walk[tile]) - 1
        fl = (csum[first[tile] + k_end] - base).to(torch.float32)
        drecT[:kernel.Q_ROW0 + nq, slot] = (fl * 1e-30)[None, :]
    return drecT


@pytest.fixture(scope="module")
def port_streams():
    """The port's binning of the miniature street: photometric (nq 6) and
    late (nq 12, G 5) records, the production plain forward's acc and lk,
    and cotangents from a numpy seed."""
    mini = street.MINI
    state = street.street_state(mini["n"], device="cpu", scale=mini["scale"])
    cam = street.street_camera("cpu", mini["width"], mini["height"],
                               mini["focal"])
    out = {}
    for late in (False, True):
        s = street.street_stream(state, cam, late=late, device="cpu")
        acc, lk = kernel.blend_forward_plain(*s, tile_batch=8)
        nq, n_gates = s[5], s[6]
        out[n_gates] = s[:5] + (acc, lk, bisect_bwd.cotangents(
            acc, nq, n_gates), nq, n_gates)
    return out


@pytest.fixture(scope="module")
def plain(port_streams):
    """``bisect_backward_plain`` memoised on (variant, G, design)."""
    memo = {}

    def run(variant, n_gates, design):
        key = (variant, n_gates, design)
        if key not in memo:
            memo[key] = bisect_bwd.bisect_backward_plain(
                variant, *port_streams[n_gates], tile_batch=8,
                **bisect_bwd.DESIGNS[design])
        return memo[key]
    return run


@pytest.mark.parametrize("n_gates", [0, 5])
def test_first_design_floor_is_the_earlier_formula(port_streams, plain,
                                                   n_gates):
    a = port_streams[n_gates]
    off = a[1].to(torch.int64)
    top_all = bisect_bwd._tops(off, a[6], a[5], a[8], n_gates)[1]
    want = _floor_before(a[0], off, top_all, a[8])
    np.testing.assert_array_equal(plain("floor", n_gates, "first").numpy(),
                                  want.numpy())
    assert FIRST == dict(batch=bisect_bwd.BATCH, skip_rule=False)


@pytest.mark.parametrize("n_gates", [0, 5])
@pytest.mark.parametrize("variant", [v for v in bisect_bwd.VARIANTS
                                     if v != "floor"])
def test_stand_ins_are_the_same_under_both_designs(plain, variant, n_gates):
    np.testing.assert_array_equal(plain(variant, n_gates, "sm90").numpy(),
                                  plain(variant, n_gates, "first").numpy())


@pytest.mark.parametrize("n_gates", [0, 5])
def test_evaluated_pairs_follow_each_design(port_streams, n_gates):
    a = port_streams[n_gates]
    recT, off, acc, lk, nq = a[0], a[1], a[5], a[6], a[8]
    _, counts = kernel.blend_backward_plain(*a, tile_batch=8,
                                            count_pairs=True)
    for v in bisect_bwd.VARIANTS:
        assert bisect_bwd.evaluated_pairs(v, off, acc, lk, nq, n_gates, recT,
                                          True) \
            == counts["evaluated_skip_rule"]
    assert bisect_bwd.evaluated_pairs("full", off, acc, lk, nq, n_gates) \
        == counts["evaluated"]
    if n_gates:    # the skip drops pairs only where gated chains run
        assert counts["evaluated_skip_rule"] < counts["evaluated"]


@pytest.mark.parametrize("n_gates", [0, 5])
def test_sm90_full_equals_production_plain_k2(port_streams, plain, n_gates):
    want = kernel.blend_backward_plain(*port_streams[n_gates], tile_batch=8)
    got = plain("full", n_gates, "sm90")
    row = want.abs().amax(dim=1).clamp(min=1e-30)
    assert float(((got - want).abs().amax(dim=1) / row).max()) <= 1e-5


def test_sm90_full_matches_jax_tool(stream, interpret):
    want = _jax_bwd(stream, "full")[:, :stream["total"]]
    args = stream["port"] + (torch.as_tensor(np.array(stream["acc"])),
                             torch.as_tensor(np.array(stream["lk"])),
                             stream["dacc"], 6, 0)
    got = bisect_bwd.bisect_backward_plain("full", *args, tile_batch=2,
                                           **SM90).numpy()
    assert not got[:, stream["total"]:].any()
    scale = np.abs(want).max(axis=1)
    err = np.abs(got[:, :stream["total"]] - want).max(axis=1) / scale
    assert err.max() <= 1e-4, err.tolist()


def hand_stack(n_gates):
    """One 16x32 tile of 150 duplicates from stream slot 40 on (so that
    batches of 64 end inside the tile and a 128-slot chunk boundary falls
    inside it): opacities from a seed, random gate bits, and per pixel an
    lk and lk_g anywhere in the tile or before it."""
    rng = np.random.default_rng(7)
    nq, start, count = 6 + (6 if n_gates else 0), 40, 150
    rec = kernel.rec_for(nq) + 1
    cap = start + count + 10
    recT = np.zeros((rec, cap), np.float32)
    recT[9] = rng.uniform(0.05, 0.95, cap).astype(np.float32)
    if n_gates:
        recT[kernel.Q_ROW0 + nq] = rng.integers(0, 2 ** n_gates, cap)
    off = np.array([start, start + count], np.int32)
    ch = kernel.ch_for(nq) + 4 * n_gates
    acc = np.zeros((1, kernel.PIX, ch), np.float32)
    lk = rng.integers(start - 1, start + count - 20,
                      (1, kernel.PIX, 1)).astype(np.int32)
    lk[0, 20:30, 0] = start - 1         # pixels the main chain left
    for g in range(n_gates):
        acc[0, :, kernel.ch_for(nq) + 4 * g + 3] = rng.integers(
            start - 1, start + count, kernel.PIX)
    return recT, off, acc, lk, nq


def serial_floor(recT, off, acc, lk, nq, n_gates, batch):
    """The kernel's floor, pixel by pixel, in f32."""
    start, end = int(off[0]), int(off[1])
    ch = kernel.ch_for(nq)
    lkg = [acc[0, :, ch + 4 * g + 3].astype(np.int64) for g in range(n_gates)]
    tops = lk[0, :, 0].astype(np.int64)
    for g in range(n_gates):
        tops = np.maximum(tops, lkg[g])
    top_all = min(end, int(tops.max()) + 1)
    out = np.zeros_like(recT)
    fl = np.zeros(kernel.PIX, np.float32)
    u = np.ones(kernel.PIX, np.float32)
    top = top_all
    while top > start:
        base = max(start, top - batch)
        for idx in range(top - 1, base - 1, -1):
            need = idx <= lk[0, :, 0]
            bits = int(recT[kernel.Q_ROW0 + nq, idx]) if n_gates else 0
            for g in range(n_gates):
                need |= bool((bits >> g) & 1) & (idx <= lkg[g])
            fl = np.where(need, fl + recT[9, idx] * u, fl).astype(np.float32)
            u = np.where(need, u * np.float32(0.999), u).astype(np.float32)
        for p in range(top - base):
            out[:kernel.Q_ROW0 + nq, base + p] = np.float32(1e-30) * fl[p]
        top = base
    return out


@pytest.mark.parametrize("n_gates", [0, 5])
def test_sm90_floor_is_each_pixels_walk(n_gates):
    recT, off, acc, lk, nq = hand_stack(n_gates)
    want = serial_floor(recT, off, acc, lk, nq, n_gates, 64)
    a = (torch.as_tensor(recT), torch.as_tensor(off), 1, 1,
         RasterizeSettings(width=32, height=16), torch.as_tensor(acc),
         torch.as_tensor(lk), torch.zeros(acc.shape), nq, n_gates)
    got = bisect_bwd.bisect_backward_plain("floor", *a, **SM90).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    # pixels differ under the skip: the slots of a batch are not all alike
    walked = want[9] != 0
    assert len(np.unique(want[9][walked])) > 1
    # the first design walks every pair with one U for all pixels
    first = bisect_bwd.bisect_backward_plain("floor", *a, **FIRST).numpy()
    assert not np.array_equal(first, got)


def test_wrappers_take_a_design_and_never_fall_back(port_streams):
    a = port_streams[0]
    order = tiles.tile_order(a[1])
    trace.reset_launch_counts()
    for design, kw in (("sm90", dict(tile_order=order)), ("first", {})):
        with pytest.raises(ValueError):
            bisect_bwd.bisect_backward_cuda("full", *a, design=design, **kw)
    with pytest.raises(ValueError):
        bisect_bwd.bisect_backward_cuda("full", *a, design="second")
    with pytest.raises(ValueError):
        bisect_bwd.bisect_backward_cuda("full", *a, design="first",
                                        tile_order=order)
    with pytest.raises(ValueError):
        bisect_bwd.bisect_backward("full", *a, design="second")
    assert trace.launch_counts["bisect_bwd"] == 0
    got = bisect_bwd.bisect_backward("no_dq", *a, design="sm90")
    assert not got[kernel.Q_ROW0:].any()


def test_cli_takes_the_design(capsys):
    bisect_bwd.main(["floor", "--device", "cpu", "--design", "first"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert '"design": "first"' in lines[-1]
    with pytest.raises(SystemExit):
        bisect_bwd.main(["floor", "--device", "cpu", "--design", "second"])
