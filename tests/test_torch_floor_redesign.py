"""The redesigned T5/T6 (``csrc/micro_floor_sm90.cuh``), on the CPU: what
the host can see of it.

* Phase A's chunk sum: a numpy float32 model of its order (per lane rows
  0..23, each row's float4s in order, (x.x + x.y) + (x.z + x.w), then the
  xor shuffle tree 16..1, then * 1e-30), the same statements as the first
  design's ``floor_walk`` in both sources, at random chunks of the three
  widths: every lane ends with the same bits, within 1e-6 of the float64
  sum.
* Phase B's fold: a model of the kernel's walk (aligned windows of 32
  lanes × 16 positions, the positions outside the segment masked, a
  ballot of the lanes with work, their positions folded lowest lane
  first) against a serial fold in stream order, bit for bit: segments of
  only no-op steps, zeroings in mid segment, segments longer than a
  window, the empty segments of T6 at width 512, static_out's single
  segment, prefetch2's 9,291 repeated adds; and no-op steps skipped in
  bulk.
* The wrappers' ``design=`` routing: unknown designs refused, a CPU
  tensor refused by the ``*_cuda`` wrappers under both designs (no plain
  fallback), the plain version on a CPU tensor whatever the design; the
  redesign's CSR (the segments longest first) and scratch; a phase alone
  only on the caller's scratch.

The kernels themselves are held against the first design (bit for bit)
and their plain versions by ``chip_smoke.py`` on a card
(``micro_floor_redesign``).
"""

import os
import re

import numpy as np
import pytest
import torch

from streetunveiler_torch import trace
from streetunveiler_torch.ops.rasterizer import cuda_lib, tiles
from streetunveiler_torch.tools import micro_floor

torch.set_num_threads(1)


def _source(name):
    with open(os.path.join(cuda_lib.CSRC_DIR, name)) as f:
        return f.read()


SM90 = _source("micro_floor_sm90.cuh")
FIRST = _source("micro_floor.cu")
CONST = {k: int(v) for k, v in re.findall(r"\b(k\w+) = (\d+)\b", SM90)}
LANE_POS, WIN = CONST["kLanePos"], 32 * CONST["kLanePos"]
ZERO, ADD = CONST["kOpZero"], CONST["kOpAdd"]
f32 = np.float32


# ---- phase A
def phase_a_sum(chunk):
    """The kernel's chunk sum of a [24, W] f32 chunk, every lane's value
    after the xor tree ([32] f32)."""
    kvec = chunk.shape[1] // 128
    # element 4 (lane + 32 q) + c of a row is x[q, lane, c]
    x = chunk.reshape(24, kvec, 32, 4)
    s = np.zeros(32, f32)
    for r in range(24):
        for q in range(kvec):
            v = x[r, q]
            s = s + ((v[:, 0] + v[:, 1]) + (v[:, 2] + v[:, 3]))
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        s = s + s[lanes ^ o]
    assert s.dtype == f32
    return s


def _sum_statements(src, kernel):
    """The chunk-sum statements of ``kernel``'s body in ``src``."""
    body = src[src.index(kernel):]
    body = body[:body.index("* 1e-30f") + len("* 1e-30f")]
    return [re.sub(r"\s+", " ", m) for m in re.findall(
        r"for \(int r = 0; r < kRec; \+\+r\)|row\[lane \+ 32 \* q\]"
        r"|s \+= \(x\.x \+ x\.y\) \+ \(x\.z \+ x\.w\);"
        r"|for \(int \w+ = 16; \w+ > 0; \w+ >>= 1\)"
        r"|s \+= __shfl_xor_sync\(0xffffffffu, s, \w+\);"
        r"|\* 1e-30f", body)]


def test_phase_a_sums_in_the_first_designs_order():
    """Both kernels sum a chunk with the same statements in the same
    order (loop variables aside), ending in the separate multiply."""
    new = _sum_statements(SM90, "floor_terms(")
    old = _sum_statements(FIRST, "floor_walk(")
    norm = lambda xs: [re.sub(r"int \w+ = 16; \w+ > 0; \w+ >>= 1",
                              "int o = 16; o > 0; o >>= 1",
                              re.sub(r"s, \w+\);", "s, o);", x)) for x in xs]
    assert norm(new) == norm(old)
    assert len(new) == 6 and new[-1] == "* 1e-30f"


@pytest.mark.parametrize("width", micro_floor.SBLOCKS)
def test_phase_a_model_at_random_chunks(width):
    rng = np.random.default_rng(width)
    orders_differ = False
    for _ in range(4):
        chunk = rng.random((24, width), dtype=f32) * f32(2) - f32(0.5)
        s = phase_a_sum(chunk)
        assert (s.view(np.uint32) == s.view(np.uint32)[0]).all()
        want = chunk.astype(np.float64).sum()
        assert abs(float(s[0]) - want) <= 1e-6 * np.abs(chunk).sum()
        term = f32(s[0] * f32(1e-30))
        assert term == f32(f32(s[0]) * f32(1e-30)) and term.dtype == f32
        serial = f32(0)
        for v in chunk.reshape(-1):
            serial = f32(serial + v)
        orders_differ |= serial != s[0]
    # the model is sensitive to the order: a serial sum rounds elsewhere
    assert orders_differ


# ---- phase B
def phase_a_ops(variant, order, first):
    """The op byte of every CSR position, as floor_terms sets it."""
    has_first = variant not in ("prefetch2", "linear")
    ops = np.zeros(len(order), np.uint8)
    for i, v in enumerate(order):
        f = first[v] if has_first else 0
        ops[i] = ZERO | ADD if f > 0 else ADD if f == 0 else 0
    return ops


def phase_b_fold(term, ops, s, e, stats=None):
    """floor_fold's value of the segment [s, e) of the CSR: windows of 32
    lanes × 16 positions aligned to 16, positions outside [s, e) masked,
    the lanes with work (a ballot) folded lowest first, each lane's 16
    positions in order."""
    n = -(-len(ops) // 16) * 16 + WIN
    op = np.zeros(n, np.uint8)
    op[:len(ops)] = ops
    acc = f32(0)
    w0 = s & ~(LANE_POS - 1)
    while w0 < e:
        win = op[w0:w0 + WIN].copy()
        p = np.arange(w0, w0 + WIN)
        win[(p < s) | (p >= e)] = 0
        lanes = win.reshape(32, LANE_POS)
        for lane in np.flatnonzero(lanes.any(axis=1)):
            if stats is not None:
                stats["lanes"] += 1
            for k in range(LANE_POS):
                o = lanes[lane, k]
                if o & ZERO:
                    acc = f32(0)
                if o & ADD:
                    acc = f32(acc + term[w0 + lane * LANE_POS + k])
        if stats is not None:
            stats["windows"] += 1
        w0 += WIN
    return acc


def serial_fold(block, zero, add, term_of_step, n_blocks):
    """Each block's steps in stream order: zero, then add the step's
    term."""
    acc = np.zeros(n_blocks, f32)
    for v in range(len(block)):
        if zero[v]:
            acc[block[v]] = f32(0)
        if add[v]:
            acc[block[v]] = f32(acc[block[v]] + term_of_step[v])
    return acc


def fold_all(variant, block, first, term_of_step, n_blocks, keep=None):
    """Phase A's ops and terms, then phase B on every segment, over
    ``step_csr``'s CSR; returns the blocks' values and the fold's
    counts."""
    order, offsets, seg = (t.numpy() for t in micro_floor.step_csr(
        torch.as_tensor(block), n_blocks,
        None if keep is None else torch.as_tensor(keep),
        segment_order=True))
    ops = phase_a_ops(variant, order, first)
    term = np.full(len(order) + WIN, np.nan, f32)
    computed = (ops & ADD).astype(bool)
    term[:len(order)][computed] = term_of_step[order[computed]]
    stats = dict(lanes=0, windows=0, computed=int(computed.sum()))
    out = np.zeros(n_blocks, f32)
    for b in seg:
        out[b] = phase_b_fold(term, ops, offsets[b], offsets[b + 1], stats)
    return out, stats, seg


def _steps(variant, tile_of, first):
    block = np.zeros_like(tile_of) if variant == "static_out" else tile_of
    if variant in ("prefetch2", "linear"):
        return block, np.zeros(len(block), bool), np.ones(len(block), bool)
    return block, first > 0, first >= 0


@pytest.fixture(scope="module")
def stream():
    tile_of, chunk_of, first, n = micro_floor.make_visits(
        micro_floor.N_CHUNKS - 1, micro_floor.N_TILES, micro_floor.VCAP)
    chunk_term = np.random.default_rng(3).random(
        micro_floor.N_CHUNKS, dtype=f32) * f32(3e-27)
    return tile_of, chunk_of, first, n, chunk_term


@pytest.mark.parametrize("variant", ["base", "static_out", "prefetch2"])
def test_phase_b_fold_equals_a_serial_fold_on_the_tools_stream(stream,
                                                                variant):
    """The tool's stream (18,880 steps, tile 0 owning 9,293 of them):
    bit for bit; base's 9,291 padding steps skipped a window at a time;
    static_out's whole stream in one segment; prefetch2's 9,291 adds of
    one chunk, each summed."""
    tile_of, chunk_of, first, n_real, chunk_term = stream
    block, zero, add = _steps(variant, tile_of, first)
    want = serial_fold(block, zero, add, chunk_term[chunk_of],
                       micro_floor.N_TILES)
    got, stats, seg = fold_all(variant, block, first, chunk_term[chunk_of],
                               micro_floor.N_TILES)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert seg[0] == 0                          # the longest segment first
    if variant == "base":
        # 9,293 positions of tile 0, 2 with work: 19 windows, one lane
        assert (tile_of == 0).sum() == 9293
        assert stats["lanes"] < 2 * micro_floor.N_TILES
        assert stats["computed"] == n_real
    if variant == "static_out":
        assert (want[1:] == 0).all() and want[0] > 0
    if variant == "prefetch2":
        # the padding's 9,291 adds of the last chunk, each a term
        assert stats["computed"] == micro_floor.VCAP
        assert (first < 0).sum() == 9291
        assert (chunk_of[first < 0] == chunk_of[-1]).all()


def test_phase_b_edge_cases():
    """A segment of only no-op steps, zeroings in mid segment, a segment
    longer than a window starting off a 16-position boundary, random ops
    everywhere; bit for bit with the serial fold."""
    rng = np.random.default_rng(7)
    n_blocks = 6
    tile_of = np.concatenate([
        np.full(3, 1), np.full(5, 2), np.full(1200, 4),
        rng.choice([0, 3, 4, 5], 337)]).astype(np.int32)
    rng.shuffle(tile_of[8:])
    n = len(tile_of)
    first = rng.integers(-1, 2, n).astype(np.int32)
    first[tile_of == 2] = -1                    # only no-op steps
    t1 = np.flatnonzero(tile_of == 1)
    first[t1] = [0, 1, 0]                       # a zeroing in mid segment
    chunk_of = rng.integers(0, 50, n).astype(np.int32)
    chunk_term = rng.random(50, dtype=f32) - f32(0.5)
    for variant in ("one_out", "prefetch2"):
        block, zero, add = _steps(variant, tile_of, first)
        want = serial_fold(block, zero, add, chunk_term[chunk_of], n_blocks)
        got, stats, seg = fold_all(variant, block, first,
                                   chunk_term[chunk_of], n_blocks)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        if variant == "one_out":
            assert got[2] == 0
            a, b, c = chunk_term[chunk_of[t1]]
            assert got[1] == f32(b + c) != f32(f32(a + b) + c)
    # the long segment (tile 4) starts off a 16-position boundary and
    # spans four windows
    offsets = micro_floor.step_csr(torch.as_tensor(tile_of),
                                   n_blocks)[1].numpy()
    assert offsets[4] % 16 and offsets[5] - offsets[4] > 2 * WIN


def test_phase_b_only_the_kept_steps(stream):
    """The CSR without the padding's no-op steps (``real_only``) folds to
    the same values."""
    tile_of, chunk_of, first, _, chunk_term = stream
    block, zero, add = _steps("base", tile_of, first)
    want = serial_fold(block, zero, add, chunk_term[chunk_of],
                       micro_floor.N_TILES)
    got, stats, _ = fold_all("base", block, first, chunk_term[chunk_of],
                             micro_floor.N_TILES, keep=zero | add)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert stats["windows"] == micro_floor.N_TILES


def test_phase_b_empty_segments_of_the_linear_walk():
    """T6 at width 512: 3,520 lane blocks over 4,800 tiles leave 1,280
    tiles without a step, which phase B writes as zeros."""
    grid = micro_floor.N_CHUNKS * 128 // 512
    tile_map = micro_floor.linear_tile_map(grid,
                                           micro_floor.N_TILES).numpy()
    term = np.random.default_rng(5).random(grid, dtype=f32)
    ones = np.ones(grid, bool)
    want = serial_fold(tile_map, ~ones, ones, term, micro_floor.N_TILES)
    got, _, _ = fold_all("linear", tile_map, None, term,
                         micro_floor.N_TILES)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    empty = np.bincount(tile_map, minlength=micro_floor.N_TILES) == 0
    assert empty.sum() == 1280 and not got[empty].any()


# ---- the wrappers
def _small():
    rec = micro_floor.make_input(micro_floor.CPU_CHUNKS, device="cpu")
    tile_of, chunk_of, first, _ = micro_floor.visit_arrays(
        micro_floor.CPU_CHUNKS, micro_floor.CPU_TILES, micro_floor.CPU_VCAP,
        "cpu")
    return rec, tile_of, chunk_of, first


def test_design_routing_and_refusals():
    rec, tile_of, chunk_of, first = _small()
    n = micro_floor.CPU_TILES
    tile_map = micro_floor.linear_tile_map(rec.shape[1] // 128, n)
    trace.reset_launch_counts()
    for design in micro_floor.DESIGNS:
        # a CPU tensor takes the plain version whatever the design
        got = micro_floor.micro_floor_visit("base", rec, tile_of, chunk_of,
                                            first, n, design)
        want = micro_floor.micro_floor_visit_plain("base", rec, tile_of,
                                                   chunk_of, first, n)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert torch.equal(
            micro_floor.micro_floor_linear(128, rec, tile_map, n, design),
            micro_floor.micro_floor_linear_plain(128, rec, tile_map, n))
        # the *_cuda wrappers launch or raise: no plain fallback
        with pytest.raises(ValueError, match="CUDA"):
            micro_floor.micro_floor_visit_cuda("base", rec, tile_of,
                                               chunk_of, first, n,
                                               design=design)
        with pytest.raises(ValueError, match="CUDA"):
            micro_floor.micro_floor_linear_cuda(128, rec, tile_map, n,
                                                design=design)
    assert not any(trace.launch_counts.values())
    for bad in ("sm90", "", None):
        with pytest.raises(ValueError, match="design"):
            micro_floor.micro_floor_visit("base", rec, tile_of, chunk_of,
                                          first, n, bad)
        with pytest.raises(ValueError, match="design"):
            micro_floor.micro_floor_linear(128, rec, tile_map, n, bad)
        with pytest.raises(ValueError, match="design"):
            micro_floor.micro_floor_visit_cuda("base", rec, tile_of,
                                               chunk_of, first, n,
                                               design=bad)
        with pytest.raises(ValueError, match="design"):
            micro_floor.run(rec, (tile_of, chunk_of, first, 0), n, 0, bad)
    with pytest.raises(SystemExit):
        micro_floor.main(["--device", "cpu", "--design", "sm90"])


def test_the_redesigns_csr_and_scratch():
    """``segment_order`` adds tiles.tile_order of the offsets (the longest
    segment first; with ``real_only`` too); the scratch rounds up to 16
    positions."""
    rec, tile_of, chunk_of, first = _small()
    n = micro_floor.CPU_TILES
    for real_only in (False, True):
        two = micro_floor.visit_csr("base", rec, tile_of, chunk_of, first,
                                    n, real_only)
        three = micro_floor.visit_csr("base", rec, tile_of, chunk_of, first,
                                      n, real_only, segment_order=True)
        assert len(two) == 2 and len(three) == 3
        assert all(torch.equal(a, b) for a, b in zip(two, three))
        assert torch.equal(three[2], tiles.tile_order(three[1]))
        lengths = (three[1][1:] - three[1][:-1])[three[2].long()]
        assert (lengths[:-1] >= lengths[1:]).all()
        # tile 0 holds the padding: first unless the padding is left out
        assert (int(three[2][0]) == 0) != real_only
    for n_pos, size in ((0, 0), (1, 16), (16, 16), (18880, 18880),
                        (9589, 9600)):
        work = micro_floor.work_buffer(n_pos, "cpu")
        assert work.dtype == torch.uint8 and work.numel() == 5 * size
    # the C entry's layout: op bytes after the 16-rounded terms
    assert "4 * (size_t)((n_pos + 15) & ~15)" in FIRST
    # a phase alone runs only on the caller's scratch, and only a phase
    csr = micro_floor.visit_csr("base", rec, tile_of, chunk_of, first, n,
                                segment_order=True)
    with pytest.raises(ValueError, match="work_buffer"):
        micro_floor._redesign_phase("fold", "base", rec, csr, n, None,
                                    chunk_of, first)
    with pytest.raises(ValueError, match="phase"):
        micro_floor._redesign_phase("both", "base", rec, csr, n,
                                    micro_floor.work_buffer(64, "cpu"),
                                    chunk_of, first)
