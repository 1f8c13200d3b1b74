"""The redesigned T4 (``csrc/micro_prefix_sm90.cuh``), on the CPU: what
the host can see of it.

* The fragment maps: for mma.sync m16n8k16 (bf16) and m16n8k8 (tf32, with
  k permuted within each 8-lane half) the PTX ISA's A, B and D layouts,
  against the kernel's positions (i = 4r + e: pixel row g + 8r, lane
  2t + (e & 1) + 8(e >> 1)), its packing of A, its reading of D and its
  triangle: every (pixel, lane) of a 16x16 block in exactly one thread,
  each thread's D positions equal to its A positions.
* The two-level scan, emulated thread by thread through those maps (the
  in-block strict triangle as B, the carry as C, the new carry D + X at
  lane 15 from the row's thread t = 3): the exclusive prefix over 128
  lanes, exactly on small integers, within f32 on seeded values.
* The serial mode's instruction count from ``cuobjdump -sass`` on a
  hand-written loop.
* ``micro_prefix_cuda``'s design selector launches or raises (CPU tensors
  and unknown designs are refused); the entry point defaults to the card
  for both designs.

The kernels themselves are held against the first design (serial and
warpscan bit for bit) and the plain version by ``chip_smoke.py`` on a card
(``micro_prefix_redesign``).
"""

import os
import re

import numpy as np
import pytest
import torch

from streetunveiler_torch import trace
from streetunveiler_torch.ops.rasterizer import cuda_lib
from streetunveiler_torch.tools import micro_prefix

torch.set_num_threads(1)

LANES = range(32)


def _header_ints(name):
    """The ``constexpr int`` constants of a header in ``csrc/``."""
    with open(os.path.join(cuda_lib.CSRC_DIR, name)) as f:
        text = f.read()
    return {k: int(v) for k, v in re.findall(r"\b(k\w+) = (\d+)\b", text)}


T4 = _header_ints("micro_prefix_sm90.cuh")


def gt(lane):
    return lane >> 2, lane & 3


# ---- the PTX ISA's fragment layouts (row, column) per element
def isa_a_k16(lane):
    """m16n8k16 .bf16 A (16 x 16), elements a0..a7 (two a register)."""
    g, t = gt(lane)
    return [(g + (8 if k in (2, 3, 6, 7) else 0),
             2 * t + (k & 1) + (8 if k >= 4 else 0)) for k in range(8)]


def isa_b_k16(lane):
    """m16n8k16 .bf16 B (16 x 8), elements b0..b3 (two a register)."""
    g, t = gt(lane)
    return [(2 * t + (k & 1) + (8 if k >= 2 else 0), g) for k in range(4)]


def isa_a_k8(lane):
    """m16n8k8 .tf32 A (16 x 8), elements a0..a3."""
    g, t = gt(lane)
    return [(g + (8 if k in (1, 3) else 0), t + (4 if k >= 2 else 0))
            for k in range(4)]


def isa_b_k8(lane):
    """m16n8k8 .tf32 B (8 x 8), elements b0, b1."""
    g, t = gt(lane)
    return [(t + 4 * k, g) for k in range(2)]


def isa_d(lane):
    """m16n8 f32 C/D (16 x 8), elements c0..c3."""
    g, t = gt(lane)
    return [(g + (8 if k >= 2 else 0), 2 * t + (k & 1)) for k in range(4)]


# ---- the kernel's choices (csrc/micro_prefix_sm90.cuh)
def positions(lane):
    """The thread's 8 (pixel row, lane) positions, i = 4r + e."""
    g, t = gt(lane)
    return [(g + 8 * (i >> 2), 2 * t + (i & 1) + 8 * ((i & 3) >> 1))
            for i in range(8)]


# block_scan's bf16 A registers: pack_bf16(x[lo], x[hi])
PACK_BF16 = ((0, 1), (4, 5), (2, 3), (6, 7))
# block_scan's tf32 fragment of half h: a[k] = x[FRAG_TF32[h][k]]
FRAG_TF32 = ((0, 4, 1, 5), (2, 6, 3, 7))
HJ = ((0, 0), (0, 1), (1, 1))   # make_tri's (half, n-tile) of tf32


def at(i):
    """``at(d, i)``: (n-tile, D element) of position i."""
    return (i & 3) >> 1, 2 * (i >> 2) + (i & 1)


def k_lane(h, k):
    """tf32 A column / B row k of half h: lane 8h + 2k, or 8h + 2(k - 4)
    + 1 for k >= 4."""
    return 8 * h + (2 * k if k < 4 else 2 * (k - 4) + 1)


def tri_bf16(lane, j):
    """make_tri's bf16 B elements of n-tile j: [k < n] for rows 2t,
    2t + 1, 2t + 8, 2t + 9 of column g."""
    g, t = gt(lane)
    n = 8 * j + g
    return [float(k < n) for k in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)]


def tri_tf32(lane, m):
    g, t = gt(lane)
    h, j = HJ[m]
    n, k = 8 * j + g, 8 * h + 2 * t
    return [float(k < n), float(k + 1 < n)]


def test_positions_cover_the_block_once_and_match_d():
    seen = [p for lane in LANES for p in positions(lane)]
    assert sorted(seen) == [(r, c) for r in range(16) for c in range(16)]
    for lane in LANES:
        pos = positions(lane)
        d = isa_d(lane)
        for i in range(8):
            j, c = at(i)
            assert (d[c][0], 8 * j + d[c][1]) == pos[i]
        # the row's thread t = 3 holds lane 15 of rows g and g + 8
        if lane & 3 == 3:
            assert pos[3][1] == pos[7][1] == 15
            assert at(3) == (1, 1) and at(7) == (1, 3)


def test_bf16_fragments_are_the_positions():
    for lane in LANES:
        pos = positions(lane)
        for k, rc in enumerate(isa_a_k16(lane)):
            assert rc == pos[PACK_BF16[k // 2][k % 2]]
        for j in range(2):
            for k, (row, col) in enumerate(isa_b_k16(lane)):
                assert tri_bf16(lane, j)[k] == float(row < 8 * j + col)


def test_tf32_permuted_fragments_are_the_positions():
    for lane in LANES:
        pos = positions(lane)
        for h in range(2):
            for k, (row, col) in enumerate(isa_a_k8(lane)):
                assert (row, k_lane(h, col)) == pos[FRAG_TF32[h][k]]
        for m, (h, j) in enumerate(HJ):
            for k, (row, col) in enumerate(isa_b_k8(lane)):
                assert tri_tf32(lane, m)[k] == float(
                    k_lane(h, row) < 8 * j + col)
    # half 1 adds nothing to n-tile 0: every lane of it is >= 8 > n
    assert all(k_lane(1, k) >= 8 for k in range(8))
    assert sorted(k_lane(h, k) for k in range(8)) == list(range(8 * h,
                                                                8 * h + 8))


def mma(a_frags, b_frags, c, isa_a, isa_b, m, n, kdim):
    """D = C + A B for one warp, A and B assembled from each thread's
    fragment elements at the ISA's positions, D handed back per thread."""
    A = np.zeros((m, kdim), np.float32)
    B = np.zeros((kdim, n), np.float32)
    for lane in LANES:
        for k, (r, col) in enumerate(isa_a(lane)):
            A[r, col] = a_frags[lane][k]
        for k, (r, col) in enumerate(isa_b(lane)):
            B[r, col] = b_frags[lane][k]
    C = np.zeros((m, n), np.float32)
    for lane in LANES:
        for k, (r, col) in enumerate(isa_d(lane)):
            C[r, col] = c[lane][k]
    D = (C + A @ B).astype(np.float32)
    return [[D[r, col] for r, col in isa_d(lane)] for lane in LANES]


def two_level_scan(X, mode):
    """The kernel's exclusive prefix of X [16, 128] over its lanes, thread
    by thread: 8 diagonal blocks, carry in C, new carry from thread t=3."""
    out = np.zeros_like(X)
    carry = [[np.float32(0)] * 2 for _ in LANES]
    for b in range(8):
        x = [[X[r, 16 * b + col] for r, col in positions(lane)]
             for lane in LANES]
        c = [[carry[lane][0]] * 2 + [carry[lane][1]] * 2 for lane in LANES]
        if mode == "bf16":
            a = [[x[lane][PACK_BF16[k // 2][k % 2]] for k in range(8)]
                 for lane in LANES]
            d = [mma(a, [tri_bf16(lane, j) for lane in LANES], c,
                     isa_a_k16, isa_b_k16, 16, 8, 16) for j in range(2)]
        else:
            def a_half(h):
                return [[x[lane][FRAG_TF32[h][k]] for k in range(4)]
                        for lane in LANES]
            tri = [[tri_tf32(lane, m) for lane in LANES] for m in range(3)]
            # tf32 columns are the half's permuted lanes: the ISA's A
            # column k' stands for lane k_lane(h, k') of the block
            d0 = mma(a_half(0), tri[0], c, isa_a_k8, isa_b_k8, 16, 8, 8)
            d1 = mma(a_half(0), tri[1], c, isa_a_k8, isa_b_k8, 16, 8, 8)
            d1 = mma(a_half(1), tri[2], d1, isa_a_k8, isa_b_k8, 16, 8, 8)
            d = [d0, d1]
        for lane in LANES:
            for i, (r, col) in enumerate(positions(lane)):
                j, e = at(i)
                out[r, 16 * b + col] = d[j][lane][e]
        new = {}
        for lane in LANES:
            if lane & 3 == 3:
                new[lane >> 2] = [np.float32(d[1][lane][2 * r + 1]
                                             + x[lane][4 * r + 3])
                                  for r in range(2)]
        carry = [new[lane >> 2] for lane in LANES]
    return out


def excl(X):
    c = np.cumsum(X.astype(np.float64), axis=1)
    return np.concatenate([np.zeros((16, 1)), c[:, :-1]], axis=1)


@pytest.mark.parametrize("mode", ["bf16", "tf32"])
def test_two_level_scan_is_the_exclusive_prefix(mode):
    rng = np.random.default_rng(5)
    ints = rng.integers(-8, 9, (16, 128)).astype(np.float32)
    np.testing.assert_array_equal(two_level_scan(ints, mode), excl(ints))
    vals = rng.standard_normal((16, 128)).astype(np.float32)
    got = two_level_scan(vals, mode)
    want = excl(vals)
    scale = np.abs(vals).sum(axis=1, keepdims=True)
    assert float((np.abs(got - want) / scale).max()) <= 1e-6


def test_block_fits_the_card():
    assert T4["kMmaWarps"] * 2 == T4["kP"] // 16   # two m-tiles a warp
    # the staged rows fit a block's shared memory, two blocks an SM's
    assert 2 * 3 * T4["kCpt"] * T4["kS"] * 4 <= 233472 - 2 * 1024
    assert (T4["kCpt"] * T4["kS"]) % 4 == 0     # whole 16-byte pieces


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN11su_prefix9012_GLOBAL__N_113prefix_serialEPKfmPf
        /*0000*/                   MUFU.EX2 R0, R0 ;
        /*0010*/                   BRA 0x0 ;
\t\tFunction : _ZN11su_prefix9012_GLOBAL__N_118prefix_serial_sm90EPKfmPf
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   FADD R2, R2, R3 ;
        /*0020*/                   MUFU.EX2 R4, R4 ;
        /*0030*/                   FMUL R5, R4, R2 ;
        /*0040*/                   MUFU.EX2 R6, R6 ;
        /*0050*/                   FFMA R7, R6, R5, R2 ;
        /*0060*/                   MUFU.EX2 R4, R4 ;
        /*0070*/                   FSETP.GT.AND P0, PT, R4, 1, PT ;
        /*0080*/                   MUFU.EX2 R6, R6 ;
        /*0090*/                   MUFU.LG2 R8, R8 ;
        /*00a0*/              @!P0 BRA 0x10 ;
        /*00b0*/                   FADD R9, R9, R9 ;
        /*00c0*/                   BRA 0x0 ;
        /*00d0*/                   EXIT ;
"""


def test_sass_loop_counts():
    got = micro_prefix.sass_loop_counts(SASS)
    assert got["pairs_per_iteration"] == 2
    assert got["fp32_per_pair"] == 2.0          # FADD FMUL FFMA FSETP / 2
    assert got["mufu_per_pair"] == 2.5         # 4 EX2 and an LG2 / 2
    assert got["per_pair"]["BRA"] == 0.5
    with pytest.raises(ValueError):
        micro_prefix.sass_loop_counts(SASS, "prefix_warpscan_sm90")


def test_design_selector_launches_or_raises():
    rec = micro_prefix.make_input(66, device="cpu")
    trace.reset_launch_counts()
    for design in micro_prefix.DESIGNS:
        with pytest.raises(ValueError):       # a CPU tensor
            micro_prefix.micro_prefix_cuda("serial", rec, design)
    with pytest.raises(ValueError):
        micro_prefix.micro_prefix_cuda("serial", rec, "second")
    with pytest.raises(ValueError):
        micro_prefix.micro_prefix("serial", rec, "second")
    assert trace.launch_counts["micro_prefix"] == 0
    plain = micro_prefix.micro_prefix_plain("mma_bf16", rec)
    for design in micro_prefix.DESIGNS:
        np.testing.assert_array_equal(
            micro_prefix.micro_prefix("mma_bf16", rec, design).numpy(),
            plain.numpy())


def test_entry_point_defaults_to_the_card(capsys):
    micro_prefix.main(["--device", "cpu", "--chunks", "66", "--design",
                       "first"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(micro_prefix.MODES)
    with pytest.raises(SystemExit):
        micro_prefix.main(["--device", "cpu", "--design", "second"])
    if not torch.cuda.is_available():
        for design in micro_prefix.DESIGNS:
            with pytest.raises(RuntimeError, match="CUDA"):
                micro_prefix.main(["--design", design])
