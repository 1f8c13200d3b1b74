"""K3's H100 design (``csrc/expand_sm90.cuh``): its partition, modelled
in numpy, and the plain K3 against the Pallas ``_expand_stream`` on
streams built for the partition's edge cases.

The model follows the kernel step by step: blocks of ``threads``
consecutive surfels (one a thread), each block's slot range written in
windows of ``window`` slots through shared memory and stored a group of 4
slots at a time, then the sentinel blocks, all handed to ``grid`` blocks
in a block-stride loop. It must write every slot of [0, capp) exactly
once, hold at most ``threads`` runs a block and ``window`` slots a window,
and give the plain version's bits, at the kernel's sizes and at small ones
that put the edge cases inside few blocks: no duplicate at all, overflow
(total > cap), a capacity that is no multiple of a block's slots, runs of
256 tiles (longer than a window at the small sizes, and a block of them
longer than a window at the kernel's) and long stretches of empty runs.
The CUDA kernel itself is held against its first design and its plain
version on a card by ``chip_smoke.py`` (``k3_redesign``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streetunveiler_tpu.ops.rasterizer import tiles as jtiles
from streetunveiler_torch import trace
from streetunveiler_torch.ops.rasterizer import tiles as ttiles

torch.set_num_threads(1)

THREADS, WINDOW, SENTINEL_SLOTS = 128, 1024, 1024   # expand_sm90.cuh
TILES_X, N_TILES = 60, 4800


def model_expand(tbl, dup_start, cap, tiles_x, sentinel, has_cull,
                 threads=THREADS, window=WINDOW,
                 sentinel_slots=SENTINEL_SLOTS, grid=None):
    """The kernel's partition and arithmetic in numpy: (tile_id, surf_id,
    writes per slot, slots of each window)."""
    n = tbl.shape[0]
    capp = -(-cap // ttiles.EXP_BLK) * ttiles.EXP_BLK
    tile_id = np.full(capp, -7, np.int64)
    surf_id = np.full(capp, -7, np.int64)
    writes = np.zeros(capp, np.int64)
    windows = []
    lim = min(int(dup_start[n]), cap)
    surfel_blocks = -(-n // threads)
    blocks = surfel_blocks + -(-(capp - lim) // sentinel_slots)
    most = surfel_blocks + -(-capp // sentinel_slots)
    grid = most if grid is None else min(grid, most)
    assert blocks <= most

    def store(lo, hi, values):
        """The block's coalesced stores of [lo, hi): groups of 4."""
        for g in range(lo >> 2, (hi + 3) >> 2):
            for s in range(4 * g, 4 * g + 4):
                if lo <= s < hi:
                    tile_id[s], surf_id[s] = values(s)
                    writes[s] += 1

    for b in range(grid):
        for vb in range(b, blocks, grid):
            if vb >= surfel_blocks:
                s0 = lim + (vb - surfel_blocks) * sentinel_slots
                store(s0, min(s0 + sentinel_slots, capp),
                      lambda s: (sentinel, n))
                continue
            first = vb * threads
            base = int(dup_start[first])
            end = min(int(dup_start[min(first + threads, n)]), lim)
            for lo in range(base, end, window):
                hi = min(lo + window, end)
                windows.append(hi - lo)
                s_tile = np.full(window, -9, np.int64)
                s_surf = np.full(window, -9, np.int64)
                for i in range(first, min(first + threads, n)):
                    x0, y0, nx, start, sid = (int(v) for v in tbl[i, :5])
                    stop = min(int(dup_start[i + 1]), lim)
                    for s in range(max(start, lo), min(stop, hi)):
                        k = s - start
                        if has_cull and tbl[i, 5] > 0:
                            kk = min(k, ttiles.CULL_KMAX - 1)
                            w = int(tbl[i, 6 if kk < 8 else 7]) & 0xFFFFFFFF
                            k = (w >> ((kk & 7) * 4)) & 15
                        q = k // nx
                        s_tile[s - lo] = (y0 + q) * tiles_x + x0 + (k - q * nx)
                        s_surf[s - lo] = sid
                store(lo, hi, lambda s: (s_tile[s - lo], s_surf[s - lo]))
    return tile_id, surf_id, writes, windows


def edge_stream(case, seed=0):
    """(tbl [n, 8] int32, dup_start [n + 1] int32, cap): a depth-ranked
    table whose run lengths are built for ``case``."""
    rng = np.random.default_rng(seed)
    if case == "no_duplicates":
        lengths = np.zeros(50, np.int64)
    elif case == "long_runs":         # 256-tile runs, 40 of them in a row
        lengths = rng.integers(0, 4, 600)
        lengths[300] = 256
        lengths[400:440] = 256
    elif case == "empty_stretches":   # culled and invalid surfels
        lengths = rng.integers(1, 14, 3000)
        lengths[rng.random(3000) < 0.4] = 0
        lengths[800:2100] = 0
        lengths[2600:] = 0
    else:                             # the street's shape: mean ~3.9
        lengths = rng.integers(0, 9, 2000)
        lengths[rng.random(2000) < 0.14] = 0
    n = lengths.size
    total = int(lengths.sum())
    cap = {"overflow": max(128, (total // 2) // 128 * 128),
           "no_duplicates": 128,
           "cap_not_multiple": -(-(total + 1) // 128) * 128 + 128}.get(
               case, -(-total // 128) * 128 + 256)
    nx = rng.integers(1, 5, n)
    small = (lengths <= ttiles.CULL_KMAX) & (rng.random(n) < 0.5)
    nib = rng.integers(0, 16, (n, 16))
    words = [(nib[:, 8 * h:8 * h + 8] << (4 * np.arange(8))).sum(1)
             for h in (0, 1)]
    words = [np.where(w >= 2 ** 31, w - 2 ** 32, w) for w in words]
    dup_start = np.concatenate([[0], np.cumsum(lengths)])
    tbl = np.stack([rng.integers(0, 50, n), rng.integers(0, 70, n), nx,
                    dup_start[:-1], rng.permutation(n), small.astype(int),
                    words[0], words[1]], 1)
    return tbl.astype(np.int32), dup_start.astype(np.int32), cap


CASES = ("street_like", "no_duplicates", "overflow", "cap_not_multiple",
         "long_runs", "empty_stretches")
SIZES = [(THREADS, WINDOW, SENTINEL_SLOTS, None), (16, 32, 64, None),
         (37, 100, 100, 3)]


def _plain(tbl, dup_start, cap, has_cull):
    tid, sid = ttiles.expand_duplicates_plain(
        torch.as_tensor(tbl), torch.as_tensor(dup_start), cap, TILES_X,
        N_TILES, has_cull)
    return tid.numpy(), sid.numpy()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("threads,window,sentinel_slots,grid", SIZES)
def test_partition_writes_every_slot_once_and_bounds_blocks(
        case, threads, window, sentinel_slots, grid):
    tbl, dup_start, cap = edge_stream(case)
    _, _, writes, windows = model_expand(tbl, dup_start, cap, TILES_X,
                                         N_TILES, True, threads, window,
                                         sentinel_slots, grid)
    assert (writes == 1).all(), case
    assert max(windows, default=0) <= window
    if case == "long_runs":   # some block needs more than one window
        assert len(windows) > -(-tbl.shape[0] // threads)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("has_cull", [True, False])
def test_model_gives_the_plain_bits(case, has_cull):
    tbl, dup_start, cap = edge_stream(case, seed=1)
    want_t, want_s = _plain(tbl, dup_start, cap, has_cull)
    for threads, window, sentinel_slots, grid in SIZES:
        tid, sid, _, _ = model_expand(tbl, dup_start, cap, TILES_X, N_TILES,
                                      has_cull, threads, window,
                                      sentinel_slots, grid)
        np.testing.assert_array_equal(tid, want_t, err_msg=case)
        np.testing.assert_array_equal(sid, want_s, err_msg=case)


def _pallas(tbl, dup_start, cap, use_cull):
    """tests/test_torch_binning.py's call of the TPU path: marks + cumsum
    rank, a clipped take of the rows, the Pallas kernel in interpret
    mode."""
    n = tbl.shape[0]
    capp = -(-cap // ttiles.EXP_BLK) * ttiles.EXP_BLK
    marks = np.zeros(capp, np.int32)
    pos = dup_start[1:-1]
    np.add.at(marks, pos[pos < capp], 1)
    g = tbl[np.minimum(np.cumsum(marks), n - 1)]
    total = min(int(dup_start[-1]), cap)
    jt, js = jtiles._expand_stream(jnp.asarray(g), jnp.int32(total), TILES_X,
                                   32, 16, n, N_TILES, use_cull,
                                   interpret=True)
    return np.asarray(jt), np.asarray(js)


@pytest.mark.parametrize("case", ["empty_stretches", "long_runs", "overflow",
                                  "cap_not_multiple"])
def test_plain_k3_matches_pallas_on_edge_streams(case):
    tbl, dup_start, cap = edge_stream(case, seed=2)
    want_t, want_s = _pallas(tbl, dup_start, cap, True)
    got_t, got_s = _plain(tbl, dup_start, cap, True)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_s, want_s)


def test_wrapper_takes_a_design_and_never_falls_back():
    tbl, dup_start, cap = edge_stream("street_like")
    t, d = torch.as_tensor(tbl), torch.as_tensor(dup_start)
    trace.reset_launch_counts()
    for design in ttiles.DESIGNS:
        with pytest.raises(ValueError):
            ttiles.expand_duplicates_cuda(t, d, cap, TILES_X, N_TILES, True,
                                          design=design)
    with pytest.raises(ValueError):
        ttiles.expand_duplicates_cuda(t, d, cap, TILES_X, N_TILES, True,
                                      design="second")
    assert trace.launch_counts["expand"] == 0
