"""Bisect the blend forward's time on the real binned stream (T1).

Counterpart of ``tools/bisect_fwd.py`` (its Pallas kernel, ``make_kernel``
:40, is launched by ``build_call`` at :281): variants of kernel K1
(``csrc/blend_fwd.cuh``, instantiated by ``csrc/bisect_fwd.cu`` at G = 0
and ``csrc/bisect_fwd_g5.cu`` at G = 5) that differ only in the body,
timed on the same grid and records, so that the differences from ``full``
show where the kernel's time goes.

Variants, each named after its TPU counterpart, and what it swaps out of
the CUDA K1 ("stream chunk": the TPU tool's visit, the 128 slots
[128c, 128c + 128) of one tile):

* ``full``: the production kernel.
* ``floor``: staging and the CSR walk; per pair fl += opacity·T,
  T *= 0.999; every channel is 1e-30·fl and lk −1. No pixel terminates, so
  the whole tile is walked.
* ``floor_noalldone``: ``floor`` without the ``__syncthreads_count`` exit.
* ``floor_nolk``: ``floor`` without the lk store (lk is None).
* ``full_nopair``: the pair math replaced by α = rec₀·1e-6 + px·1e-8,
  t = rec₁₁ + py·0, a pair contributing when α > 0.
* ``full_noexp``: the pair's exp(x) replaced by the linear 1 + x. (The
  TPU's ``full_noexp`` linearised the exp of its log-space transmittance
  prefix; the CUDA K1 keeps a running product, so its one exp is the
  pair's.)
* ``full_noprefix``: no transmittance product: T is frozen within a stream
  chunk (w = α·T), times 0.999 at its end, and a trigger freezes the pixel
  at the chunk's end.
* ``full_notrigger``: no early termination: a trigger drops the rest of
  its stream chunk only, and no pixel freezes.
* ``full_nosums``: the payload, α, depth and moment sums replaced by one
  slot's weight: payload channel k takes the pair at chunk lane k, the
  others the pair at lane 0.
* ``full_nomed``: no median (channel nq+5 stays 0).
* ``full_nolkmax``: no last-index tracking: lk starts at 0 (the TPU
  tool's first visit) and takes max(lk, T > 2) per pair, so lk = 0.

Five TPU variants compute ``full``'s output by another TPU formulation,
and a Hopper thread's sequential loop has no second form of them
(``TPU_ONLY``): ``full_kogge`` and ``full_suffmm`` (prefix scans: their
question is T4's, ``micro_prefix``), ``full_mxsums`` (sums as one matmul:
T3's, ``micro_reduce``), ``full_f32max`` and ``full_f32all`` (f32 instead
of int maxima; a thread's max is one instruction either way).

``bisect_forward`` runs a variant's plain PyTorch version on a CPU tensor
and its kernel on a CUDA tensor (raising if it cannot launch). Run on the
card: ``python -m streetunveiler_torch.tools.bisect_fwd [variant ...]
[--gates 5] [--device cuda]`` bins the 300k-surfel street at 1920x1280 as
the main path does (``--gates 5``: the late step's stream, nq 12) and
prints each variant's median ms (CUDA events), its evaluated pairs and its
difference from ``full``; ``--device cpu`` runs the plain versions on the
600-surfel miniature instead and prints no device time.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import time

import numpy as np
import torch

from streetunveiler_torch.ops.rasterizer import cuda_lib, kernel
from streetunveiler_torch.ops.rasterizer.blendmath import (map_depth,
                                                           pair_alpha_depth)
from streetunveiler_torch.ops.rasterizer.types import MEDIAN_T

VARIANTS = ("full", "floor", "floor_noalldone", "floor_nolk", "full_nopair",
            "full_noexp", "full_noprefix", "full_notrigger", "full_nosums",
            "full_nomed", "full_nolkmax")   # index = the kernel's variant
FLOORS = ("floor", "floor_noalldone", "floor_nolk")
TPU_ONLY = ("full_kogge", "full_suffmm", "full_mxsums", "full_f32max",
            "full_f32all")   # compute full's output: no CUDA form
GATES = (0, 5)         # gated chains the variants are built for
CHUNK = 128            # the TPU tool's visit: 128 stream slots
DECAY = 0.999          # T's stand-in factor: per pair (floors), per chunk
STANDIN = 1e-30


def _linear_exp(x):
    return 1.0 + x


def _pairs(variant, chunk, inr, px, py, settings, nq):
    """(α, t) of a chunk's pairs [Tb, S, P] for ``variant``, α zeroed for
    pairs that do not contribute."""
    if variant == "full_nopair":
        a = chunk[0] * 1e-6 + px * 1e-8
        t = chunk[kernel.Q_ROW0 + 1] + py * 0.0
        keep = inr[..., None] & (a > 0.0)
        return torch.where(keep, a, torch.zeros_like(a)), t
    opac = torch.where(inr[..., None], chunk[9], torch.zeros_like(chunk[9]))
    c2dx, c2dy, z = chunk[6], chunk[7], chunk[8]
    m_rows = (chunk[0], chunk[3], c2dx * z, chunk[1], chunk[4], c2dy * z,
              chunk[2], chunk[5], z)
    return pair_alpha_depth(
        m_rows, (c2dx, c2dy), z, opac, opac > 0.0, px, py, settings.znear,
        exp=_linear_exp if variant == "full_noexp" else torch.exp)


def _chain(variant, a, t_carry, done, t_eps, visited):
    """One stream chunk of a chain (main or gated) under ``variant``:
    (w, t_excl, keep, live, t_carry, done). ``visited`` [Tb]: the chunk
    holds slots of the tile (a TPU visit)."""
    if variant == "full_noprefix":
        t_excl = t_carry[:, None, :].expand_as(a)
        trig = (a > 0.0) & (t_excl * (1.0 - a) < t_eps)
        keep = (a > 0.0) & ~trig & ~done[:, None, :]
        w = torch.where(keep, a * t_excl, torch.zeros_like(a))
        live = (~done)[:, None, :].expand_as(a)
        t_out = torch.where(visited[:, None], t_carry * DECAY, t_carry)
        return w, t_excl, keep, live, t_out, done | trig.any(dim=1)
    if variant == "full_notrigger":
        one_minus = 1.0 - a
        cum = torch.cumprod(one_minus, dim=1)
        t_excl = t_carry[:, None] * torch.cat(
            [torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
        keep = (a > 0.0) & (t_carry[:, None] * cum >= t_eps)
        w = torch.where(keep, a * t_excl, torch.zeros_like(a))
        t_out = t_carry * torch.prod(
            torch.where(keep, one_minus, torch.ones_like(one_minus)), dim=1)
        return w, t_excl, keep, torch.ones_like(keep), t_out, done
    return kernel._chain_weights(a, t_carry, done, t_eps)


def _floor_plain(variant, recT, off, n_tiles, ch, count_pairs):
    """The floors: per tile fl = Σ_j opacity_j·0.999^j over its whole range
    (the running product in f32, as the kernel rounds it)."""
    dev = recT.device
    counts = (off[1:] - off[:-1]).cpu()
    longest = int(counts.max()) if n_tiles else 0
    decay = np.concatenate([[1.0], np.multiply.accumulate(
        np.full(max(longest - 1, 0), DECAY, np.float32))]).astype(
            np.float32)
    decay = torch.as_tensor(decay, device=dev)
    fl = torch.zeros(n_tiles, dtype=torch.float32, device=dev)
    idx = torch.arange(int(off[-1]), device=dev)
    tile = torch.repeat_interleave(torch.arange(n_tiles, device=dev),
                                   (off[1:] - off[:-1]))
    if idx.numel():
        fl.index_add_(0, tile, recT[9, idx] * decay[idx - off[tile]])
    acc = (fl * STANDIN)[:, None, None].expand(n_tiles, kernel.PIX,
                                               ch).contiguous()
    lk = None if variant == "floor_nolk" else torch.full(
        (n_tiles, kernel.PIX, 1), -1, dtype=torch.int32, device=dev)
    if count_pairs:
        return acc, lk, {"evaluated": int(off[-1]) * kernel.PIX}
    return acc, lk


def bisect_forward_plain(variant, recT, tile_offsets, tiles_x: int,
                         tiles_y: int, settings, nq: int = kernel.NQ,
                         n_gates: int = 0, tile_batch: int = 64,
                         count_pairs: bool = False):
    """Plain PyTorch version of a T1 variant, walking each tile's range in
    the TPU tool's stream chunks (vectorized over ``tile_batch`` tiles).
    Returns (acc [T, PIX, nq+6+4G], lk [T, PIX, 1] int32, or None for
    ``floor_nolk``); with ``count_pairs`` also {"evaluated": pairs a live
    chain reached}."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    dev = recT.device
    n_tiles = tiles_x * tiles_y
    ch = kernel.ch_for(nq)
    G = n_gates
    off = tile_offsets.to(torch.int64)
    if variant in FLOORS:
        return _floor_plain(variant, recT, off, n_tiles, ch + 4 * G,
                            count_pairs)
    t_eps = settings.t_eps
    acc = torch.zeros((n_tiles, kernel.PIX, ch + 4 * G), device=dev)
    for g in range(G):
        acc[..., ch + 4 * g + 3] = -1.0
    lk = torch.full((n_tiles, kernel.PIX, 1), -1, dtype=torch.int32,
                    device=dev)
    evaluated = torch.zeros((), dtype=torch.int64, device=dev)
    starts, ends = off[:-1], off[1:]
    first = starts // CHUNK
    n_chunks = torch.where(ends > starts, (ends - 1) // CHUNK - first + 1,
                           torch.zeros_like(first))
    n_chunks_host = n_chunks.cpu()
    sub = torch.arange(kernel.PIX, device=dev)
    sub_x = (sub % kernel.TILE_W).to(torch.float32)
    sub_y = (sub // kernel.TILE_W).to(torch.float32)
    lane = torch.arange(CHUNK, device=dev)

    for t0 in range(0, n_tiles, tile_batch):
        t1 = min(t0 + tile_batch, n_tiles)
        length = int(n_chunks_host[t0:t1].max())
        if length == 0:
            continue
        tb = torch.arange(t0, t1, device=dev)
        nb = t1 - t0
        ty = tb // tiles_x
        tx = tb - ty * tiles_x
        px = ((tx * kernel.TILE_W).to(torch.float32)[:, None] + sub_x
              + 0.5)[:, None]
        py = ((ty * kernel.TILE_H).to(torch.float32)[:, None] + sub_y
              + 0.5)[:, None]
        zeros = lambda: torch.zeros((nb, kernel.PIX), device=dev)
        t_carry = torch.ones((nb, kernel.PIX), device=dev)
        done = torch.zeros((nb, kernel.PIX), dtype=torch.bool, device=dev)
        payload = torch.zeros((nb, kernel.PIX, nq), device=dev)
        alpha, deptha, m1, m2, med = (zeros() for _ in range(5))
        lk_b = torch.full((nb, kernel.PIX), -1, dtype=torch.int64, device=dev)
        tg = [torch.ones((nb, kernel.PIX), device=dev) for _ in range(G)]
        done_g = [torch.zeros((nb, kernel.PIX), dtype=torch.bool, device=dev)
                  for _ in range(G)]
        sums_g = torch.zeros((G, 3, nb, kernel.PIX), device=dev)
        lk_g = torch.full((G, nb, kernel.PIX), -1.0, device=dev)
        for k in range(length):
            slot = (first[t0:t1, None] + k) * CHUNK + lane[None, :]  # [Tb,S]
            inr = (slot >= starts[t0:t1, None]) & (slot < ends[t0:t1, None])
            visited = inr.any(dim=1)
            gidx = torch.where(inr, slot, torch.zeros_like(slot))
            chunk = recT[:, gidx][..., None]                 # [rec, Tb, S, 1]
            a, tdep = _pairs(variant, chunk, inr, px, py, settings, nq)
            m = map_depth(tdep, settings.znear, settings.zfar)
            idx = lane[None, :, None].expand_as(a)
            none = torch.full_like(idx, -1)

            w, t_excl, keep, live, t_carry, done = _chain(
                variant, a, t_carry, done, t_eps, visited)
            gates = kernel.gate_bits(chunk[kernel.Q_ROW0 + nq], G) if G \
                else None
            for g in range(G):
                ag = torch.where(gates[g], a, torch.zeros_like(a))
                wg, _, keep_g, live_g, tg[g], done_g[g] = _chain(
                    variant, ag, tg[g], done_g[g], t_eps, visited)
                wgm = wg * m
                sums_g[g] += torch.stack([wg.sum(1), wgm.sum(1),
                                          (wgm * m).sum(1)])
                last_g = torch.where(keep_g, idx, none).max(dim=1).values
                lk_new = torch.gather(gidx, 1, last_g.clamp(min=0))
                lk_g[g] = torch.where(last_g >= 0, lk_new.to(torch.float32),
                                      lk_g[g])
                live = live | live_g
            evaluated += (inr[..., None] & live).sum()

            wm = w * m
            if variant == "full_nosums":
                payload[..., :min(nq, CHUNK)] += w[:, :nq].transpose(1, 2)
                alpha = alpha + w[:, 0]
                deptha = deptha + (w * tdep)[:, 0]
                m1 = m1 + wm[:, 0]
                m2 = m2 + (wm * m)[:, 0]
            else:
                q = chunk[kernel.Q_ROW0:kernel.Q_ROW0 + nq, ..., 0]
                payload = payload + (w[..., None]
                                     * q.permute(1, 2, 0)[:, :, None, :]
                                     ).sum(1)
                alpha = alpha + w.sum(1)
                deptha = deptha + (w * tdep).sum(1)
                m1 = m1 + wm.sum(1)
                m2 = m2 + (wm * m).sum(1)
            if variant != "full_nomed":
                cand = (w > 0.0) & (t_excl > MEDIAN_T)
                best = torch.where(cand, idx, none).max(dim=1).values
                t_best = torch.gather(tdep, 1, best.clamp(min=0)[:, None])[:, 0]
                med = torch.where(best >= 0, t_best, med)
            if variant != "full_nolkmax":
                lastk = torch.where(keep, idx, none).max(dim=1).values
                lk_new = torch.gather(gidx, 1, lastk.clamp(min=0))
                lk_b = torch.where(lastk >= 0, lk_new, lk_b)

        acc[t0:t1, :, :ch] = torch.cat(
            [payload, alpha[..., None], deptha[..., None],
             torch.zeros_like(alpha)[..., None], m1[..., None],
             m2[..., None], med[..., None]], dim=-1)
        if G:
            acc[t0:t1, :, ch:] = torch.cat(
                [sums_g, lk_g[:, None]], dim=1).permute(2, 3, 0, 1).reshape(
                    nb, kernel.PIX, 4 * G)
        lk[t0:t1, :, 0] = lk_b.to(torch.int32)
    if variant == "full_nolkmax":
        lk.zero_()
    if count_pairs:
        return acc, lk, {"evaluated": int(evaluated)}
    return acc, lk


def bisect_forward_cuda(variant, recT, tile_offsets, tiles_x: int,
                        tiles_y: int, settings, nq: int = kernel.NQ,
                        n_gates: int = 0):
    """Launch a T1 variant (``csrc/bisect_fwd.cu``) on the current stream."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if n_gates not in GATES:
        raise ValueError(f"the variants are built at G in {GATES}, "
                         f"got {n_gates}")
    n_tiles = tiles_x * tiles_y
    kernel._check_blend_args("bisect_forward_cuda", recT, tile_offsets,
                             n_tiles, nq, n_gates)
    lib = cuda_lib.load_library()
    dev = recT.device
    acc = torch.empty((n_tiles, kernel.PIX, kernel.ch_for(nq) + 4 * n_gates),
                      dtype=torch.float32, device=dev)
    lk = torch.empty((n_tiles, kernel.PIX, 1), dtype=torch.int32, device=dev)
    znear, zfar, index, stream = kernel._launch_args(settings, dev)
    rc = lib.su_bisect_fwd(
        VARIANTS.index(variant), recT.data_ptr(), recT.shape[0],
        recT.shape[1], nq, n_gates, kernel.Q_ROW0 + nq,
        tile_offsets.data_ptr(), n_tiles, tiles_x, znear, zfar,
        ctypes.c_float(settings.t_eps), acc.data_ptr(), lk.data_ptr(),
        index, stream)
    cuda_lib.check(rc, f"bisect_fwd {variant} launch")
    cuda_lib.launch_counts["bisect_fwd"] += 1
    return acc, None if variant == "floor_nolk" else lk


def bisect_forward(variant, recT, tile_offsets, tiles_x: int, tiles_y: int,
                   settings, nq: int = kernel.NQ, n_gates: int = 0):
    """A T1 variant: its kernel on a CUDA tensor, its plain version on a
    CPU tensor."""
    fn = bisect_forward_plain if recT.device.type == "cpu" \
        else bisect_forward_cuda
    return fn(variant, recT, tile_offsets, tiles_x, tiles_y, settings, nq,
              n_gates)


def main(argv=None):
    from streetunveiler_torch.tools import street, timing
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--gates", type=int, default=0, choices=GATES,
                    help="0: the photometric stream (nq 6); 5: the late "
                         "step's (nq 12, 5 gated chains)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    for v in args.variants:
        if v not in VARIANTS:
            raise SystemExit(f"unknown variant {v!r}: one of {VARIANTS}; "
                             f"{TPU_ONLY} have no CUDA form")
    cpu = torch.device(args.device).type == "cpu"
    if cpu:
        mini = street.MINI
        state = street.street_state(mini["n"], device="cpu",
                                    scale=mini["scale"])
        cam = street.street_camera("cpu", mini["width"], mini["height"],
                                   mini["focal"])
    else:
        timing.require_cuda(args.device)
        print(timing.card(), flush=True)
        state = street.street_state(device=args.device)
        cam = street.street_camera(args.device)
    stream = street.street_stream(state, cam, late=args.gates == 5,
                                  device=args.device)
    full = bisect_forward("full", *stream)
    ms_of = lambda v: timing.median_ms(
        lambda: bisect_forward_cuda(v, *stream), args.reps)
    full_ms = None if cpu else ms_of("full")
    for v in args.variants:
        t0 = time.perf_counter()
        acc, lk = bisect_forward(v, *stream)
        host = (time.perf_counter() - t0) * 1e3
        pairs = bisect_forward_plain(v, *stream, count_pairs=True)[2] \
            if cpu or v not in ("full_nosums", "full_nomed", "full_nolkmax") \
            else None
        line = dict(variant=v, n_gates=args.gates, nq=stream[5],
                    evaluated_pairs=None if pairs is None
                    else pairs["evaluated"],
                    max_abs_diff_from_full=float((acc - full[0]).abs().max()))
        if cpu:
            line["host_ms_cpu_plain"] = host
        else:
            line["ms"] = ms_of(v)
            line["ms_minus_full"] = line["ms"] - full_ms
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
