"""The redesigned T3 (``csrc/micro_reduce_sm90.cuh``) and T9
(``csrc/mmt3_sm90.cuh``) kernels, on the CPU: what the host can see of
them.

* T3's warp mode sums a block's k lane values by a reduce-scatter that
  pairs lanes as the first design's xor butterfly does, each lane keeping
  its slots permuted: a numpy f32 model of both gives the butterfly's
  lane-0 sums bit for bit at k 4, 8 and 13.
* T3's work split: the thread blocks' (slice, row group) items, the
  thread mode's weight shares, the stage copies and the ring of stages
  take every (row, slice) exactly once, its blocks in order; every partial
  and every output is written exactly once.
* T9's warp and lane roles write every one of the 4 × 512 × 7 outputs
  exactly once.
* The wrappers' design selector launches or raises (CPU tensors and
  unknown designs are refused), and the entry points default to the card.

The kernels themselves are held bit for bit against their first design
by ``chip_smoke.py`` on a card (phase group 12).
"""

import os
import re
from collections import Counter

import numpy as np
import pytest
import torch

from streetunveiler_torch.ops.rasterizer import cuda_lib
from streetunveiler_torch.tools import micro_reduce, probe_mmt3

torch.set_num_threads(1)

LANES = np.arange(32)


def _header_ints(name):
    """The ``constexpr int`` constants of a header in ``csrc/``."""
    with open(os.path.join(cuda_lib.CSRC_DIR, name)) as f:
        text = f.read()
    return {k: int(v) for k, v in re.findall(r"\b(k\w+) = (\d+)\b", text)}


T3 = _header_ints("micro_reduce_sm90.cuh")
T9 = _header_ints("mmt3_sm90.cuh")
# T3's shapes: rows an item, stages, staged row stride (floats), threads
ROWS = {"pair": T3["kWarpRows"], "thread": T3["kThreadRows"],
        "warp": T3["kWarpRows"], "mma": T3["kMmaRows"]}
STAGES = {"pair": T3["kWarpStages"], "thread": T3["kThreadStages"],
          "warp": T3["kWarpStages"], "mma": T3["kMmaStages"]}
LD = {"pair": 128, "thread": 132, "warp": 128, "mma": 136}
PARTS = T3["kThreadParts"]
THREADS = {"thread": ROWS["thread"] * PARTS, "mma": ROWS["mma"] * 2,
           "pair": ROWS["pair"] * 32, "warp": ROWS["warp"] * 32}


@pytest.mark.parametrize("mode", ["pair", "thread", "warp", "mma"])
def test_t3_shapes_fit_the_card(mode):
    """Each item's rows divide the 512; a block's stages fit an H100
    block's 227 KB of shared memory and leave room for two blocks an SM
    (228 KB); a warp's threads share one weight share (thread mode)."""
    assert micro_reduce.P % ROWS[mode] == 0
    smem = 4 * STAGES[mode] * ROWS[mode] * LD[mode]
    assert 2 * smem <= 228 * 1024 and THREADS[mode] <= 1024
    if mode == "thread":
        assert ROWS[mode] % 32 == 0
    if mode == "mma":
        assert ROWS[mode] % 16 == 0


# ---- the warp mode's sums

def _weight(i):
    """1 + 0.01 i in double, rounded to f32, as the kernels take it."""
    return np.float32(1.0 + 0.01 * i)


def _block_term(f, c):
    """f.x·c + f.y·c + f.z·c + f.w·c in f32, left to right, per lane:
    f [32, 4], c [32, n] → [32, n]."""
    t = f[:, 0:1] * c
    for e in range(1, 4):
        t = (t + f[:, e:e + 1] * c).astype(np.float32)
    return t


def _butterfly(f, k):
    """The first design: lane l's k values, then five xor steps (16, 8,
    4, 2, 1), each lane adding its partner's running sum. Returns the sums
    lane 0 holds, [k]."""
    c = np.broadcast_to(np.array([_weight(i) for i in range(k)]), (32, k))
    y = _block_term(f, c)
    for o in (16, 8, 4, 2, 1):
        y = (y + y[LANES ^ o]).astype(np.float32)
    return y[0]


def _slots(k):
    """(N, H): the k sums padded to N = 2^H slots (one for the pair)."""
    n = 1
    while n < k:
        n *= 2
    return n, n.bit_length() - 1


def _reduce_scatter_sm90(f, k):
    """The redesign: the k values padded to N = 2^H slots, lane l's slot p
    holding sum p ^ m (m = l >> (5 − H), zero weight past k); H halving
    steps (xor 16 ..), each lane adding its partner's upper half to its
    lower half, then 5 − H butterfly steps on slot 0. Returns (slot 0 [32],
    m [32])."""
    n, h_steps = _slots(k)
    m = LANES >> (5 - h_steps)
    logical = np.arange(n)[None, :] ^ m[:, None]
    c = np.where(logical < k, np.array([_weight(i) for i in range(n)])[
        np.minimum(logical, n - 1)], np.float32(0)).astype(np.float32)
    v = _block_term(f, c)
    for s in range(h_steps):
        o, half = 16 >> s, n >> (s + 1)
        v = v.copy()
        v[:, :half] = (v[:, :half] + v[LANES ^ o, half:2 * half]).astype(
            np.float32)
    for s in range(h_steps, 5):
        v = v.copy()
        v[:, 0] = (v[:, 0] + v[LANES ^ (16 >> s), 0]).astype(np.float32)
    return v[:, 0], m


@pytest.mark.parametrize("k", [4, 8, 13])
def test_warp_reduce_scatter_has_the_butterflys_bits(k):
    """Random f32 blocks with magnitudes over 12 decades, so that the
    order of the additions shows in the last bits."""
    rng = np.random.default_rng(k)
    # the lanes that store: the first of each group holding one sum
    writers = (LANES & ((1 << (5 - _slots(k)[1])) - 1)) == 0
    other_tree = 0
    for _ in range(50):
        f = (rng.normal(size=(32, 4))
             * 10.0 ** rng.integers(-6, 6, (32, 4))).astype(np.float32)
        want = _butterfly(f, k)
        got, m = _reduce_scatter_sm90(f, k)
        for i in range(k):
            held = got[m == i]
            # every lane left with sum i holds the butterfly's bits
            np.testing.assert_array_equal(
                held.view(np.int32), np.full(held.shape, want[i]).astype(
                    np.float32).view(np.int32))
            assert int((writers & (m == i)).sum()) == 1   # one store
        # a serial sum over the lanes is another tree: other bits
        c = np.array([_weight(i) for i in range(k)], np.float32)
        terms = _block_term(f, np.broadcast_to(c, (32, k)))
        serial = np.zeros(k, np.float32)
        for lane in range(32):
            serial = (serial + terms[lane]).astype(np.float32)
        other_tree += int((serial != want).sum())
    assert other_tree > 0


@pytest.mark.parametrize("k", [4, 8, 13])
def test_warp_sums_take_16_or_fewer_shuffles(k):
    """N − 1 shuffles for the halving steps, 5 − H for the butterfly on
    the one sum left: 16 at k 13 against the first design's 5 k = 65."""
    n, h_steps = _slots(k)
    shuffles = sum(n >> (s + 1) for s in range(h_steps)) + 5 - h_steps
    assert shuffles == n - 1 + 5 - h_steps
    assert shuffles <= 16 and shuffles < 5 * k


# ---- T3's work split

def _ring(nblk, ns):
    """The ring of ``ring`` in csrc/micro_reduce_sm90.cuh: the blocks each
    iteration consumes, checking that a slot is refilled only after its
    block was consumed and read only once its block was loaded."""
    slot, consumed = [None] * ns, []
    for s in range(ns - 1):
        if s < nblk:
            slot[s] = ("loaded", s)
    for j in range(nblk):
        nxt = j + ns - 1
        if nxt < nblk:
            assert slot[nxt % ns] is None or slot[nxt % ns][0] == "used"
            slot[nxt % ns] = ("loaded", nxt)
        assert slot[j % ns] == ("loaded", j)
        slot[j % ns] = ("used", j)
        consumed.append(j)
    return consumed


def _stage_copies(rows, threads):
    """stage_rows: thread tid's n-th 16-byte copy is piece c = tid + n·NT,
    row c >> 5, piece c & 31; per (n, warp) the 32 lanes' copies."""
    assert rows * 32 % threads == 0
    per = rows * 32 // threads
    pieces = Counter()
    for n in range(per):
        for warp in range(threads // 32):
            cs = [warp * 32 + lane + n * threads for lane in range(32)]
            # a warp's copies are one row's 512 contiguous bytes
            assert len({c >> 5 for c in cs}) == 1
            assert sorted(c & 31 for c in cs) == list(range(32))
            pieces.update((c >> 5, c & 31) for c in cs)
    return pieces


def _partial_writes(mode, k, rows, parts):
    """The (row in the item, column) pairs of the [16]-wide partials an
    item's threads store."""
    writes = Counter()
    if mode == "thread":
        for tid in range(rows * parts):
            r, part = tid % rows, tid // rows
            lo, hi = part * k // parts, (part + 1) * k // parts
            writes.update((r, i) for i in range(lo, hi))
            if part == parts - 1:
                writes.update((r, i) for i in range(k, 16))
    elif mode in ("warp", "pair"):
        n, h_steps = _slots(k)
        for warp in range(rows):
            for lane in range(32):
                if lane & ((1 << (5 - h_steps)) - 1) == 0:
                    writes[warp, lane >> (5 - h_steps)] += 1
                if lane < 16 - n:
                    writes[warp, n + lane] += 1
    else:
        n_tiles = (k + 7) // 8
        for warp in range(rows // 16):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                cols = [nt * 8 + 2 * t + e for nt in range(n_tiles)
                        for e in (0, 1)]
                if n_tiles == 1:
                    cols += [8 + 2 * t, 9 + 2 * t]
                for row in (warp * 16 + g, warp * 16 + g + 8):
                    writes.update((row, c) for c in cols)
    return writes


@pytest.mark.parametrize("mode,k", micro_reduce.MODES)
@pytest.mark.parametrize("nv", [micro_reduce.NV, 8])
def test_t3_work_split_takes_every_row_slice_once(mode, k, nv):
    rows, threads = ROWS[mode], THREADS[mode]
    parts = PARTS if mode == "thread" else 1
    nsplit = micro_reduce.NSPLIT if nv % micro_reduce.NSPLIT == 0 else nv
    vps, groups = nv // nsplit, micro_reduce.P // rows
    # the items: every (slice, row) once
    items = Counter()
    for bid in range(nsplit * groups):
        split, row0 = bid // groups, bid % groups * rows
        items.update((split, row0 + r) for r in range(rows))
    assert set(items.values()) == {1} and len(items) == nsplit * 512
    # each item's ring consumes its slice's blocks once, in order
    assert _ring(vps, STAGES[mode]) == list(range(vps))
    # each stage holds every 16-byte piece of the item's rows once
    assert _stage_copies(rows, threads) == Counter(
        {(r, q): 1 for r in range(rows) for q in range(32)})
    # every partial column of every row of the item written once
    assert _partial_writes(mode, k, rows, parts) == Counter(
        {(r, c): 1 for r in range(rows) for c in range(16)})


def test_t3_fold_writes_every_output_once():
    """fold_partials: 64 blocks of 128 threads, thread (8·block + tid / 16,
    tid % 16) folds, the block's 8 rows' columns 16..127 zeroed."""
    out = Counter()
    for bid in range(512 // 8):
        for tid in range(128):
            out[bid * 8 + (tid >> 4), tid & 15] += 1
            for c in range(tid, 8 * 112, 128):
                out[bid * 8 + c // 112, 16 + c % 112] += 1
    assert out == Counter({(p, i): 1 for p in range(512)
                           for i in range(128)})


# ---- T9's roles

def test_t9_roles_write_every_output_once():
    """mmt3_sm90_kernel: warp w < 3 of block i stores way w's fragments
    (rows 16 i + g and + 8, columns 2t and 2t + 1 below 7); thread 96 + j
    (j < 112) the truth of row 16 i + j % 16, column j / 16."""
    rows = T9["kRows"]
    writes = Counter()
    for block in range(probe_mmt3.P // rows):
        row0 = block * rows
        for tid in range(T9["kThreads"]):
            warp, lane = tid >> 5, tid & 31
            if warp < 3:
                g, t = lane >> 2, lane & 3
                for r in range(4):
                    col = 2 * t + (r & 1)
                    if col < probe_mmt3.Q:
                        writes[warp, row0 + g + (8 if r >= 2 else 0),
                               col] += 1
            j = tid - 32 * T9["kWays"]
            if warp >= T9["kWays"] and j < rows * probe_mmt3.Q:
                writes[3, row0 + j % rows, j // rows] += 1
    assert writes == Counter({(o, p, q): 1 for o in range(4)
                              for p in range(probe_mmt3.P)
                              for q in range(probe_mmt3.Q)})


# ---- the wrappers

def test_design_selector_launches_or_raises():
    x = micro_reduce.make_input(8, device="cpu")
    w, b = probe_mmt3.make_inputs("cpu")
    for design in micro_reduce.DESIGNS:
        with pytest.raises(ValueError, match="CUDA"):
            micro_reduce.micro_reduce_cuda("warp", 13, x, design)
    for design in probe_mmt3.DESIGNS:
        with pytest.raises(ValueError, match="CUDA"):
            probe_mmt3.mmt3_cuda(w, b, design)
    with pytest.raises(ValueError, match="design"):
        micro_reduce.micro_reduce_cuda("warp", 13, x, "second")
    with pytest.raises(ValueError, match="design"):
        probe_mmt3.mmt3_cuda(w, b, "second")
    # on the CPU the design does not matter: the plain version runs
    assert torch.equal(micro_reduce.micro_reduce("warp", 13, x, "first"),
                       micro_reduce.micro_reduce_plain("warp", 13, x))
    assert all(torch.equal(g, p) for g, p in zip(
        probe_mmt3.mmt3(w, b, "first"), probe_mmt3.mmt3_plain(w, b)))


@pytest.mark.parametrize("tool", [micro_reduce, probe_mmt3])
@pytest.mark.parametrize("design", ["first", "redesign"])
def test_entry_points_default_to_the_card(tool, design):
    """Without ``--device cpu`` the tools' mains need a CUDA device,
    whichever design they are asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: main would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main(["--design", design])
