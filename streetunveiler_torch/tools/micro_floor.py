"""Per-step floor probe (T5, T6): what one step of a walk over the record
stream costs when the body does almost nothing, timed on the card.

Counterpart of ``tools/micro_floor.py``: its visit-stream floor
(``build_visit`` :60, launched at :115) and its linear walk
(``build_linear`` :140, launched at :149), as the kernel
``csrc/micro_floor.cu``. The visit stream (``make_visits``) lists ~3.2
consecutive chunks per tile of 4,800 tiles, padded to 18,880 steps with
steps on tile 0, the last chunk and ``first`` −1.

The function. The TPU leaves the outputs' first values and some blocks
undefined; the port defines them as the Pallas interpreter runs them:
outputs (and scratch) start at zero, and a block that a step maps to but
does not write keeps its value. Step v in stream order, on its output
block (``tile_of[v]``; 0 for ``static_out``):

* ``first[v] > 0``: the block is zeroed, in every output;
* ``first[v] >= 0``: ``sum(rec[:, chunk_of[v]·128 : +128]) · 1e-30`` is
  added to each of the block's 512 × 12 elements.

``prefetch2`` has no ``first``: every one of the steps adds, so ~9,280
padding adds of the last chunk land on tile 0, after its real visits.
``static_out`` leaves in block 0 the sum of the last real tile's visits
and zeros elsewhere. ``base`` has a second output, zeroed only, so it is
zero everywhere. ``alldone`` gates the add on scratch column 1 > 1.5,
which only ever holds zeros: it computes ``one_out``'s function, as do
``no_scratch`` and ``base``'s first output. The linear walk (T6) adds
``sum(rec[:, v·sb : (v+1)·sb]) · 1e-30`` into block ``tile_map[v]`` for
every step v, into zeroed blocks. Each block holds one value: its terms
folded in f32, in stream order, after its last zeroing.

The kernel has two designs (``DESIGNS``): ``redesign`` (the default,
``csrc/micro_floor_sm90.cuh``: phase A sums each adding step's chunk,
a warp a position of the CSR across the card, phase B folds each output
block's terms in stream order, a warp a block, the longest segments
first, skipping no-op steps 512 at a time, then stores; bit for bit with
the first design) and ``first`` (``csrc/micro_floor.cu``'s
``floor_walk``: a thread block per output block walks its steps). The
redesign walks a CSR with the segment order
(``step_csr(..., segment_order=True)``); the private
``_redesign_phase`` runs one of its phases alone, to time them apart.

``micro_floor_visit``/``micro_floor_linear`` run the plain PyTorch
version on a CPU tensor and the kernel on a CUDA tensor. Run on the card:
``python -m streetunveiler_torch.tools.micro_floor [--device cuda]
[--design first]`` times every variant and width at the tool's sizes (rec
[24, 14,080·128] from a seed on the device) and prints ms and ns per
step; ``--device cpu`` runs the plain versions at 64 chunks, 16 tiles and
64 steps.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from streetunveiler_torch import trace
from streetunveiler_torch.ops.rasterizer import cuda_lib, tiles

REC, S, PIX, CH = 24, 128, 512, 12
N_CHUNKS, N_TILES, VCAP = 14080, 4800, 18880
CPU_CHUNKS, CPU_TILES, CPU_VCAP = 64, 16, 64    # ``--device cpu``'s sizes
SEED = 1
VARIANTS = ("base", "alldone", "one_out", "static_out", "no_scratch",
            "prefetch2")
SBLOCKS = (128, 256, 512)
_INDEX = {v: i for i, v in enumerate(VARIANTS)}
_LINEAR = len(VARIANTS)     # su_micro_floor's variant index of T6
DESIGNS = ("redesign", "first")
# the redesign's phases (csrc/micro_floor_sm90.cuh, su_floor::Phases)
_PHASES = {"terms": 1, "fold": 2, "both": 3}


def make_visits(n_dup_chunks, n_tiles, vcap):
    """The visit stream of ``tools/micro_floor.py:make_visits``: ~3.2
    visits per tile on consecutive chunks, from ``default_rng(0)``, padded
    to ``vcap`` steps. Returns (tile_of, chunk_of, first) int32 and the
    number of real visits."""
    rng = np.random.default_rng(0)
    tile_of, chunk_of, first = [], [], []
    c = 0
    for t in range(n_tiles):
        k = 1 + int(rng.random() < 0.5) + int(rng.random() < 0.5)
        for j in range(k):
            tile_of.append(t)
            chunk_of.append(min(c, n_dup_chunks - 1))
            first.append(1 if j == 0 else 0)
            if j < k - 1:
                c += 1
        c += 1
    n = len(tile_of)
    tile_of += [0] * (vcap - n)
    chunk_of += [n_dup_chunks - 1] * (vcap - n)
    first += [-1] * (vcap - n)
    return (np.asarray(tile_of, np.int32), np.asarray(chunk_of, np.int32),
            np.asarray(first, np.int32), n)


def linear_tile_map(grid, n_tiles, device="cpu"):
    """T6's block per step: min(v·n_tiles // grid, n_tiles − 1)."""
    v = torch.arange(grid, dtype=torch.int64, device=device)
    return torch.clamp(v * n_tiles // grid, max=n_tiles - 1).to(torch.int32)


def _check_variant(variant):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")


def _check_sblock(sblock):
    if sblock not in SBLOCKS:
        raise ValueError(f"sblock must be one of {SBLOCKS}, got {sblock!r}")


def _check_design(design):
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {DESIGNS}, got {design!r}")


def _check_rec(recT, width):
    if recT.dtype != torch.float32 or recT.dim() != 2 \
            or recT.shape[0] != REC or recT.shape[1] % width \
            or not recT.is_contiguous():
        raise ValueError(f"recT must be contiguous float32 [{REC}, "
                         f"k·{width}], got {tuple(recT.shape)} {recT.dtype}")


def _block_sums(recT, width):
    """sum(rec[:, i·width : (i+1)·width]) · 1e-30 for every lane block i,
    f32."""
    return recT.view(REC, -1, width).sum(dim=(0, 2)) * 1e-30


def _visit_steps(variant, tile_of, first):
    """(block, zero, add) per step of a T5 variant."""
    block = torch.zeros_like(tile_of) if variant == "static_out" else tile_of
    if variant == "prefetch2":
        return block, torch.zeros_like(first, dtype=torch.bool), \
            torch.ones_like(first, dtype=torch.bool)
    return block, first > 0, first >= 0


def _fold(block, term, zero, add, n_blocks):
    """Each block's value: its steps applied in stream order in f32 (zero,
    then add ``term``). Steps of one rank within their block are applied
    together; steps that neither zero nor add are left out."""
    keep = torch.nonzero(zero | add).flatten()
    block, term, zero, add = block[keep], term[keep], zero[keep], add[keep]
    order = torch.sort(block, stable=True).indices
    counts = torch.bincount(block, minlength=n_blocks)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device) \
        - start[block[order]]
    by_rank = torch.sort(rank, stable=True).indices
    acc = torch.zeros(n_blocks, dtype=torch.float32, device=term.device)
    i = 0
    for n in torch.bincount(rank).tolist():
        idx = by_rank[i:i + n]
        i += n
        b = block[idx]
        a = torch.where(zero[idx], torch.zeros_like(acc[b]), acc[b])
        acc[b] = torch.where(add[idx], a + term[idx], a)
    return acc


def _broadcast(acc):
    return acc[:, None, None].expand(-1, PIX, CH).contiguous()


def _check_visits(recT, tile_of, chunk_of, first, n_tiles):
    """Raise unless the visit arrays are int32 [vcap] on recT's device and
    index within rec and the tiles (one host sync)."""
    _check_rec(recT, S)
    arrs = (tile_of, chunk_of, first)
    if any(a.dtype != torch.int32 or a.shape != tile_of.shape
           or a.dim() != 1 or a.device != recT.device for a in arrs):
        raise ValueError("tile_of, chunk_of and first must be int32 [vcap] "
                         "on rec's device")
    lo = torch.stack([tile_of.min(), chunk_of.min()]).tolist()
    hi = torch.stack([tile_of.max(), chunk_of.max()]).tolist()
    if min(lo) < 0 or hi[0] >= n_tiles or hi[1] >= recT.shape[1] // S:
        raise ValueError("tile_of or chunk_of out of range")


def micro_floor_visit_plain(variant, recT, tile_of, chunk_of, first,
                            n_tiles):
    """Plain PyTorch version of T5: a tuple of the variant's outputs
    (two for ``base``), each [n_tiles, 512, 12] f32."""
    _check_variant(variant)
    _check_visits(recT, tile_of, chunk_of, first, n_tiles)
    block, zero, add = _visit_steps(variant, tile_of, first)
    term = _block_sums(recT, S)[chunk_of.long()]
    out = _broadcast(_fold(block.long(), term, zero, add, n_tiles))
    return (out, torch.zeros_like(out)) if variant == "base" else (out,)


def micro_floor_linear_plain(sblock, recT, tile_map, n_tiles):
    """Plain PyTorch version of T6: [n_tiles, 512, 12] f32."""
    _check_sblock(sblock)
    _check_rec(recT, sblock)
    term = _block_sums(recT, sblock)
    if tile_map.shape != term.shape:
        raise ValueError(f"tile_map must be [{term.numel()}]")
    n = tile_map.numel()
    ones = torch.ones(n, dtype=torch.bool, device=recT.device)
    return _broadcast(_fold(tile_map.long(), term, ~ones, ones, n_tiles))


def step_csr(block, n_blocks, keep=None, segment_order=False):
    """The steps listed by output block in stream order (a stable sort, as
    the binning's CSR for K1): (order [steps], offsets [n_blocks + 1]),
    int32. With ``keep`` (bool [steps]) only the kept steps are listed.
    With ``segment_order`` a third entry, the output blocks longest
    segment first (``tiles.tile_order``), which the redesign walks."""
    steps = None
    if keep is not None:
        steps = torch.nonzero(keep).flatten()
        block = block[steps]
    s, order = torch.sort(block, stable=True)
    if steps is not None:
        order = steps[order]
    offsets = torch.searchsorted(
        s, torch.arange(n_blocks + 1, dtype=block.dtype,
                        device=block.device), side="left").to(torch.int32)
    if segment_order:
        return order.to(torch.int32), offsets, tiles.tile_order(offsets)
    return order.to(torch.int32), offsets


def visit_csr(variant, recT, tile_of, chunk_of, first, n_tiles,
              real_only=False, segment_order=False):
    """Check the visit arrays and build the CSR a T5 variant walks: every
    step, or with ``real_only`` only the steps that zero or add (the
    padding's no-op steps, all on tile 0, left out; the outputs are the
    same); with ``segment_order`` as ``step_csr``'s."""
    _check_variant(variant)
    _check_visits(recT, tile_of, chunk_of, first, n_tiles)
    block, zero, add = _visit_steps(variant, tile_of, first)
    return step_csr(block, n_tiles, (zero | add) if real_only else None,
                    segment_order)


def work_buffer(n_pos, device):
    """The redesign's scratch for a CSR of ``n_pos`` positions: uint8, the
    terms (f32) then the op bytes, each rounded up to 16 positions (phase B
    reads 16 a lane)."""
    return torch.empty(5 * (-(-n_pos // 16) * 16), dtype=torch.uint8,
                       device=device)


def _launch(variant_index, sblock, recT, csr, n_blocks, chunk_of, first,
            two_out, design, phase="both", work=None):
    _check_design(design)
    if recT.device.type != "cuda":
        raise ValueError(f"recT must be a CUDA tensor, got {recT.device}")
    if design == "redesign" and len(csr) != 3:
        raise ValueError("the redesign walks a CSR with its segment order: "
                         "step_csr(..., segment_order=True)")
    order, offsets = csr[:2]
    if offsets.shape != (n_blocks + 1,) or any(
            t.dtype != torch.int32 or t.device != recT.device
            or not t.is_contiguous() for t in csr) or (
            design == "redesign" and csr[2].shape != (n_blocks,)):
        raise ValueError("csr must be int32 (order, offsets [n_blocks + 1]"
                         "[, segment order [n_blocks]]) on rec's device")
    lib = cuda_lib.load_library()
    out0 = torch.empty((n_blocks, PIX, CH), dtype=torch.float32,
                       device=recT.device)
    out1 = torch.empty_like(out0) if two_out else None
    index = recT.device.index if recT.device.index is not None \
        else torch.cuda.current_device()
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(recT.device).cuda_stream
    if design == "first":
        rc = lib.su_micro_floor_first(
            variant_index, sblock, recT.data_ptr(), recT.shape[1],
            order.data_ptr(), offsets.data_ptr(), n_blocks, ptr(chunk_of),
            ptr(first), out0.data_ptr(), ptr(out1), index, stream)
    else:
        n_pos = order.numel()
        if work is None:
            work = work_buffer(n_pos, recT.device)
        elif (work.dtype != torch.uint8 or work.device != recT.device
              or work.numel() < 5 * (-(-n_pos // 16) * 16)):
            raise ValueError("work must be work_buffer(n_pos) on rec's "
                             "device")
        rc = lib.su_micro_floor(
            variant_index, sblock, recT.data_ptr(), recT.shape[1],
            order.data_ptr(), offsets.data_ptr(), csr[2].data_ptr(),
            n_blocks, n_pos, ptr(chunk_of), ptr(first), work.data_ptr(),
            out0.data_ptr(), ptr(out1), _PHASES[phase], index, stream)
    cuda_lib.check(rc, f"micro_floor launch ({design})")
    return (out0, out1) if two_out else (out0,)


def micro_floor_visit_cuda(variant, recT, tile_of, chunk_of, first,
                           n_tiles, csr=None, design="redesign"):
    """Launch the T5 kernel on the current stream: its ``redesign``
    (``csrc/micro_floor_sm90.cuh``) or its ``first`` design
    (``csrc/micro_floor.cu``). ``csr`` is ``visit_csr``'s result (the
    redesign's with ``segment_order``), built here when None."""
    _check_variant(variant)
    _check_design(design)
    if csr is None:
        csr = visit_csr(variant, recT, tile_of, chunk_of, first, n_tiles,
                        segment_order=design == "redesign")
    out = _launch(_INDEX[variant], S, recT, csr, n_tiles, chunk_of,
                  first, variant == "base", design)
    trace.launch_counts["micro_floor_visit"] += 1
    return out


def micro_floor_linear_cuda(sblock, recT, tile_map, n_tiles, csr=None,
                            design="redesign"):
    """Launch the T6 kernel on the current stream, by ``design`` as
    ``micro_floor_visit_cuda``. ``csr`` is ``step_csr(tile_map, n_tiles)``
    (with ``segment_order`` for the redesign), built here when None."""
    _check_sblock(sblock)
    _check_design(design)
    _check_rec(recT, sblock)
    if tile_map.shape != (recT.shape[1] // sblock,) \
            or tile_map.dtype != torch.int32:
        raise ValueError(f"tile_map must be int32 [{recT.shape[1] // sblock}]")
    if csr is None:
        lo, hi = torch.stack([tile_map.min(), tile_map.max()]).tolist()
        if lo < 0 or hi >= n_tiles:
            raise ValueError("tile_map out of range")
        csr = step_csr(tile_map, n_tiles, segment_order=design == "redesign")
    (out,) = _launch(_LINEAR, sblock, recT, csr, n_tiles, None, None, False,
                     design)
    trace.launch_counts["micro_floor_linear"] += 1
    return out


def _redesign_phase(phase, variant, recT, csr, n_blocks, work,
                    chunk_of=None, first=None, sblock=S):
    """One phase of the redesign alone, to time the phases apart:
    ``terms`` (phase A: the CSR's terms and op bytes into ``work``) or
    ``fold`` (phase B on what phase A left in ``work``; returns the
    outputs, which ``terms`` leaves unwritten and does not return).
    ``variant`` is a T5 variant or ``linear`` (T6 at width ``sblock``);
    ``csr`` has the segment order; ``work`` is ``work_buffer``'s,
    allocated by the caller."""
    if phase not in ("terms", "fold"):
        raise ValueError(f"phase must be 'terms' or 'fold', got {phase!r}")
    if work is None:
        raise ValueError("a phase alone needs the caller's work_buffer")
    if variant == "linear":
        _check_sblock(sblock)
        _check_rec(recT, sblock)
        index, key = _LINEAR, "micro_floor_linear"
    else:
        _check_variant(variant)
        _check_rec(recT, S)
        index, key, sblock = _INDEX[variant], "micro_floor_visit", S
    out = _launch(index, sblock, recT, csr, n_blocks, chunk_of, first,
                  variant == "base", "redesign", phase, work)
    trace.launch_counts[key] += 1
    return out if phase == "fold" else None


def micro_floor_visit(variant, recT, tile_of, chunk_of, first, n_tiles,
                      design="redesign"):
    """The kernel (``design``) on a CUDA tensor, the plain version on a CPU
    tensor."""
    _check_design(design)
    if recT.device.type == "cpu":
        return micro_floor_visit_plain(variant, recT, tile_of, chunk_of,
                                       first, n_tiles)
    return micro_floor_visit_cuda(variant, recT, tile_of, chunk_of, first,
                                  n_tiles, design=design)


def micro_floor_linear(sblock, recT, tile_map, n_tiles, design="redesign"):
    """The kernel (``design``) on a CUDA tensor, the plain version on a CPU
    tensor."""
    _check_design(design)
    if recT.device.type == "cpu":
        return micro_floor_linear_plain(sblock, recT, tile_map, n_tiles)
    return micro_floor_linear_cuda(sblock, recT, tile_map, n_tiles,
                                   design=design)


def make_input(n_chunks=N_CHUNKS, device="cuda"):
    """rec [24, n_chunks·128] uniform in [0, 1) from ``SEED``, drawn on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    return torch.rand((REC, n_chunks * S), generator=gen, device=device)


def visit_arrays(n_chunks=N_CHUNKS, n_tiles=N_TILES, vcap=VCAP,
                 device="cuda"):
    """The tool's visit stream as int32 tensors on ``device``, and its
    number of real visits."""
    tile_of, chunk_of, first, n = make_visits(n_chunks - 1, n_tiles, vcap)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (tile_of, chunk_of, first)) + (n,)


def run(recT, visits, n_tiles, reps=10, design="redesign"):
    """Every variant and width once through the dispatching entry points,
    then, on the card and with ``reps`` > 0, each timed by ``design`` with
    its CSR built beforehand (median of ``reps`` CUDA-event times): ``ms``
    walks every step, ``ms_real_steps`` a CSR without the padding's no-op
    steps (which the first design's block of tile 0 walks alone, after the
    others), and ``csr_ms`` is the CSR's build. Returns one dict per
    variant and width."""
    from streetunveiler_torch.tools import timing
    _check_design(design)
    tile_of, chunk_of, first, n_real = visits
    vcap = tile_of.numel()
    cuda = recT.device.type == "cuda" and reps > 0
    ordered = design == "redesign"
    lines = []
    for variant in VARIANTS:
        out = micro_floor_visit(variant, recT, tile_of, chunk_of, first,
                                n_tiles, design)
        line = dict(variant=variant, steps=vcap, real_visits=n_real,
                    checksum=float(sum(o.double().sum() for o in out)))
        if cuda:
            def csr_of(real_only=False):
                return visit_csr(variant, recT, tile_of, chunk_of, first,
                                 n_tiles, real_only, ordered)
            csr, real = csr_of(), csr_of(True)
            ms = timing.median_ms(lambda: micro_floor_visit_cuda(
                variant, recT, tile_of, chunk_of, first, n_tiles, csr,
                design), reps)
            line.update(ms=ms, ns_per_step=ms * 1e6 / vcap,
                        real_steps=int(real[1][-1]),
                        ms_real_steps=timing.median_ms(
                            lambda: micro_floor_visit_cuda(
                                variant, recT, tile_of, chunk_of, first,
                                n_tiles, real, design), reps),
                        csr_ms=timing.median_ms(csr_of, reps))
        lines.append(line)
    for sb in SBLOCKS:
        grid = recT.shape[1] // sb
        tile_map = linear_tile_map(grid, n_tiles, recT.device)
        out = micro_floor_linear(sb, recT, tile_map, n_tiles, design)
        line = dict(variant=f"linear_sb{sb}", steps=grid,
                    checksum=float(out.double().sum()))
        if cuda:
            csr = step_csr(tile_map, n_tiles, segment_order=ordered)
            ms = timing.median_ms(lambda: micro_floor_linear_cuda(
                sb, recT, tile_map, n_tiles, csr, design), reps)
            line.update(ms=ms, ns_per_step=ms * 1e6 / grid)
        lines.append(line)
    if cuda:
        for line in lines:
            line["design"] = design
    return lines


def main(argv=None):
    from streetunveiler_torch.tools import timing
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--design", choices=DESIGNS, default="redesign",
                    help="the kernel's design on the card")
    args = ap.parse_args(argv)
    cpu = torch.device(args.device).type == "cpu"
    if not cpu:
        timing.require_cuda(args.device)
        print(timing.card(), flush=True)
    n_chunks, n_tiles, vcap = (CPU_CHUNKS, CPU_TILES, CPU_VCAP) if cpu \
        else (N_CHUNKS, N_TILES, VCAP)
    recT = make_input(n_chunks, device=args.device)
    visits = visit_arrays(n_chunks, n_tiles, vcap, args.device)
    for line in run(recT, visits, n_tiles, args.reps, args.design):
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
