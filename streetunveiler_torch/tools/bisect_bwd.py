"""Bisect the blend backward's time on the real binned stream (T2).

Counterpart of ``tools/bisect_bwd.py`` (its Pallas kernel, ``make_kernel``
:36, is launched at :199): variants of kernel K2 that differ only in the
body, timed on the same records, forward residuals and cotangents, so
that the differences from ``full`` show where the kernel's time goes. Two
designs of K2 carry them (``DESIGNS``):

* ``sm90`` (the default): the production K2, ``csrc/blend_bwd_sm90.cuh``,
  instantiated on each variant by ``csrc/bisect_bwd_sm90.cu`` at
  (nq, G) = (6, 0) and ``csrc/bisect_bwd_sm90_g5.cu`` at (12, 5);
  ``full`` also at (12, 0), and ``full`` is the production kernel. It
  stages batches of 64 duplicates and evaluates a pair only where a chain
  still keeps it (index ≤ lk, or gate bit g set and index ≤ lk_g);
* ``first``: K2's first design, ``csrc/blend_bwd.cuh``
  (``csrc/bisect_bwd.cu``, ``bisect_bwd_g5.cu``, the same (nq, G)):
  batches of 32, every pair up to the pixel's deepest lk or lk_g.

Variants, each named after its TPU counterpart, and what it swaps out of
the CUDA K2 ("stream chunk": the TPU tool's visit, the 128 slots
[128c, 128c + 128) of one tile):

* ``full``: the production kernel.
* ``floor``: the staging and the walk from the tile's deepest lk down; per
  pair the pixel evaluates, fl += opacity·U, U *= 0.999 (U from 1); after
  each batch, slot p of the batch gets 1e-30·fl of pixel p in rows
  0..9+nq (the first design evaluates every pair of the walk, so its
  pixels' fl are all alike).
* ``no_vjp``: the per-pair VJP replaced by summed values 1e-30·dα (even
  indices) and 1e-30·dt (odd) of the 14; the chain through the cross
  products and the payload gradients stay.
* ``no_dq``: no payload gradients gq·w and no sums of them (those rows 0).
* ``no_gqqc``: Ω's gq·q replaced by 1e-6·w.
* ``no_suffmm``: no suffix updates: T_excl = U frozen within a stream
  chunk, S_pair = S + 1e-6·w·Ω; at the chunk's end U *= 0.999 and S += the
  chunk's Σ w·Ω (every chain).
* ``no_exp``: the division rebuild T = U/(1−α) replaced by the multiply
  T = U·(1+α) (every chain): the TPU's ``no_exp`` linearised the exp of its
  log-space suffix, whose counterpart here is that division.

The stand-ins act on kept pairs only, so the two designs' exact pair
skip changes only ``floor`` and the pairs each evaluates; the plain
versions take the design's ``batch`` and ``skip_rule``.

``bisect_backward`` runs a variant's plain PyTorch version on a CPU tensor
and its kernel on a CUDA tensor (raising if it cannot launch). Run on the
card: ``python -m streetunveiler_torch.tools.bisect_bwd [variant ...]
[--gates 5] [--design first] [--device cuda]`` bins the 300k-surfel
street at 1920x1280,
runs the production forward for acc and lk, draws cotangents from a
numpy seed and prints each variant's median ms (CUDA events, dgrad
zeroed once outside the timed launches) and its difference from
``full``'s; ``--device cpu`` runs the plain versions on the 600-surfel
miniature and prints no device time.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from streetunveiler_torch import trace
from streetunveiler_torch.ops.rasterizer import cuda_lib, kernel, tiles
from streetunveiler_torch.ops.rasterizer.blendmath import (map_depth,
                                                           pair_alpha_depth)

VARIANTS = ("full", "floor", "no_vjp", "no_dq", "no_gqqc", "no_suffmm",
            "no_exp")                       # index = the kernel's variant
BUILT = ((6, 0), (12, 5))                   # (nq, G) the variants are built at
FULL_BUILT = BUILT + ((12, 0),)             # and `full` alone (the semantic
#                                             step's first design of K2)
CHUNK = 128                                 # the TPU tool's visit
# each design's duplicates per staged batch and whether it skips the pairs
# no chain keeps (its exact pair skip)
DESIGNS = {"sm90": dict(batch=64, skip_rule=True),
           "first": dict(batch=32, skip_rule=False)}
BATCH = DESIGNS["first"]["batch"]
SKIP_SLOTS = 1 << 16    # walked slots a skip-rule pair count takes at once
DECAY = 0.999
STANDIN = 1e-30


def _reverse(variant, a, keep, u, s, omega_fn, visited):
    """One stream chunk of a chain's reverse scan along dim 1 under
    ``variant``: (w, dα, U, S) with U and S carried past the chunk;
    ``omega_fn(w)`` gives Ω."""
    if variant == "no_suffmm":
        t_excl = u[:, None, :].expand_as(a)
    else:
        step = 1.0 + a if variant == "no_exp" else 1.0 - a
        f = torch.where(keep, step, torch.ones_like(a))
        suffix = torch.flip(torch.cumprod(torch.flip(f, [1]), dim=1), [1])
        t_excl = u[:, None, :] * suffix if variant == "no_exp" \
            else u[:, None, :] / suffix
    w = torch.where(keep, a * t_excl, torch.zeros_like(a))
    omega = omega_fn(w)
    womega = w * omega
    zero = torch.zeros_like(a)
    if variant == "no_suffmm":
        da = torch.where(keep, t_excl * omega
                         - (s[:, None, :] + womega * 1e-6) / (1.0 - a), zero)
        u_out = torch.where(visited[:, None], u * DECAY, u)
        return w, da, u_out, s + womega.sum(1)
    s_incl = torch.flip(torch.cumsum(torch.flip(womega, [1]), dim=1), [1])
    s_after = s[:, None, :] + s_incl - womega
    da = torch.where(keep, t_excl * omega - s_after / (1.0 - a), zero)
    u_out = u * suffix[:, 0, :] if variant == "no_exp" \
        else u / suffix[:, 0, :]
    return w, da, u_out, s + s_incl[:, 0, :]


def chain_rows(r, s):
    """The per-duplicate end of K2's pair VJP (``blend_bwd.cuh``, one
    thread per duplicate): the 14 pixel-summed values ``s`` [14, ...]
    chained through the cross products onto record rows 0-9, from the raw
    rows ``r`` [10, ...]."""
    r1x, r2x, r3x, r1y, r2y, r3y, c2dx, c2dy, z = r[:9]
    r1z, r2z, r3z = c2dx * z, c2dy * z, z
    ax = r1y * r2z - r1z * r2y
    ay = r1z * r2x - r1x * r2z
    az = r1x * r2y - r1y * r2x
    ddet = s[9]
    gax, gay, gaz = s[0] + ddet * r3x, s[1] + ddet * r3y, s[2] + ddet * r3z
    gbx, gby, gbz = s[3], s[4], s[5]
    gcx, gcy, gcz = s[6], s[7], s[8]
    d1x = (r2y * gaz - r2z * gay) + (gcy * r3z - gcz * r3y)
    d1y = (r2z * gax - r2x * gaz) + (gcz * r3x - gcx * r3z)
    d1z = (r2x * gay - r2y * gax) + (gcx * r3y - gcy * r3x)
    d2x = (gay * r1z - gaz * r1y) + (r3y * gbz - r3z * gby)
    d2y = (gaz * r1x - gax * r1z) + (r3z * gbx - r3x * gbz)
    d2z = (gax * r1y - gay * r1x) + (r3x * gby - r3y * gbx)
    d3x = ddet * ax + (gby * r2z - gbz * r2y) + (r1y * gcz - r1z * gcy)
    d3y = ddet * ay + (gbz * r2x - gbx * r2z) + (r1z * gcx - r1x * gcz)
    d3z = ddet * az + (gbx * r2y - gby * r2x) + (r1x * gcy - r1y * gcx)
    return torch.stack([d1x, d2x, d3x, d1y, d2y, d3y, s[10] + d1z * z,
                        s[11] + d2z * z, s[12] + d1z * c2dx + d2z * c2dy + d3z,
                        s[13]])


def _tops(off, lk, acc, nq, n_gates):
    """Per pixel the deepest index a chain kept, and per tile the end of
    the walk: min(end, deepest + 1)."""
    ch = kernel.ch_for(nq)
    top = lk[..., 0].to(torch.int64)
    for g in range(n_gates):
        top = torch.maximum(top, acc[..., ch + 4 * g + 3].to(torch.int64))
    return top, torch.minimum(off[1:], top.amax(dim=1) + 1)


def _walk(off, top_all):
    """The tiles' walks from their tops down, flat: (tile, walk index k,
    slot, flat index of each tile's k = 0, walk lengths)."""
    dev = off.device
    n_walk = (top_all - off[:-1]).clamp(min=0)
    tile = torch.repeat_interleave(torch.arange(off.numel() - 1, device=dev),
                                   n_walk)
    first = torch.cumsum(n_walk, 0) - n_walk        # flat index of k = 0
    k = torch.arange(tile.numel(), device=dev) - first[tile]
    return tile, k, top_all[tile] - 1 - k, first, n_walk


def _needed(recT, slot, tile, lk, acc, nq, n_gates, pixels):
    """Per walked slot and pixel of ``pixels``, whether the pixel
    evaluates the pair under the exact pair skip: slot ≤ lk, or the
    slot's gate bit g set and slot ≤ lk_g for some g. [E, len(pixels)]."""
    ch = kernel.ch_for(nq)
    s = slot[:, None]
    need = s <= lk[:, pixels, 0][tile].to(torch.int64)
    if n_gates:
        bits = kernel.gate_bits(recT[kernel.Q_ROW0 + nq, slot], n_gates)
        for g in range(n_gates):
            lkg = acc[:, pixels, ch + 4 * g + 3][tile].to(torch.int64)
            need = need | (bits[g][:, None] & (s <= lkg))
    return need


def evaluated_pairs(variant, tile_offsets, acc, lk, nq: int = kernel.NQ,
                    n_gates: int = 0, recT=None,
                    skip_rule: bool = False) -> int:
    """The (duplicate, pixel) pairs a variant evaluates. Without the skip
    rule (the first design): per pixel its tile's duplicates up to its
    deepest lk or lk_g, and ``floor`` walks every pixel from the tile's
    deepest one down. With it (``recT`` given for the gate row): the
    pairs some chain still keeps, for every variant; counted SKIP_SLOTS
    walked slots at a time."""
    off = tile_offsets.to(torch.int64)
    top, top_all = _tops(off, lk, acc, nq, n_gates)
    if skip_rule:
        tile, _, slot, _, _ = _walk(off, top_all)
        pixels = torch.arange(kernel.PIX, device=off.device)
        return sum(int(_needed(recT, slot[i:i + SKIP_SLOTS],
                               tile[i:i + SKIP_SLOTS], lk, acc, nq,
                               n_gates, pixels).sum())
                   for i in range(0, slot.numel(), SKIP_SLOTS))
    if variant == "floor":
        return int((top_all - off[:-1]).clamp(min=0).sum()) * kernel.PIX
    return int(torch.where(top >= 0, top - off[:-1, None] + 1,
                           torch.zeros_like(top)).sum())


def _floor_plain(recT, off, top_all, nq, batch, skip_rule, lk, acc,
                 n_gates):
    """The floor: the walk from each tile's top down, fl = Σ opacity·U in
    walk order over the pairs the pixel evaluates (U = 0.999^(pairs before
    it)), written per batch of ``batch`` duplicates: slot p of a batch
    takes pixel p's fl. Without the skip rule every pixel evaluates every
    pair of the walk, so one fl serves them all."""
    dev = recT.device
    drecT = torch.zeros(recT.shape, dtype=torch.float32, device=dev)
    tile, k, slot, first, n_walk = _walk(off, top_all)
    if tile.numel():
        longest = int(n_walk.max())
        decay = torch.as_tensor(np.concatenate([[1.0], np.multiply.accumulate(
            np.full(longest - 1, DECAY, np.float32))]).astype(np.float32),
            device=dev)
        k_end = torch.minimum((k // batch + 1) * batch, n_walk[tile]) - 1
        col = torch.zeros_like(k)
        if skip_rule:
            # slot p of its batch; the batch's lowest slot is top - 1 - k_end
            col = slot - (top_all[tile] - 1 - k_end)
            need = _needed(recT, slot, tile, lk, acc, nq, n_gates,
                           torch.arange(min(batch, kernel.PIX), device=dev))
            ahead = torch.cumsum(need.to(torch.int64), 0)
            before = ahead - need.to(torch.int64)
            before = before - (ahead[first] - need[first].to(torch.int64))[
                tile]                                # evaluated pairs before
            c = torch.where(need, recT[9, slot][:, None] * decay[before],
                            torch.zeros_like(before, dtype=torch.float32))
        else:
            c = (recT[9, slot] * decay[k])[:, None]
        c = c.to(torch.float64)
        # prefix sums in walk order, per tile
        csum = torch.cumsum(c, 0)
        base = csum[first[tile]] - c[first[tile]]
        fl = (csum[first[tile] + k_end, col] - base[torch.arange(
            k.numel(), device=dev), col]).to(torch.float32)
        drecT[:kernel.Q_ROW0 + nq, slot] = (fl * STANDIN)[None, :]
    return drecT


def bisect_backward_plain(variant, recT, tile_offsets, tiles_x: int,
                          tiles_y: int, settings, acc, lk, dacc,
                          nq: int = kernel.NQ, n_gates: int = 0,
                          tile_batch: int = 64, count_pairs: bool = False,
                          batch: int = BATCH, skip_rule: bool = False):
    """Plain PyTorch version of a T2 variant, walking each tile's range
    back to front in the TPU tool's stream chunks (vectorized over
    ``tile_batch`` tiles); the pair VJP is ``torch.autograd.grad`` of
    ``pair_alpha_depth`` as in ``kernel.blend_backward_plain``. ``batch``
    and ``skip_rule`` are the design's (``DESIGNS``): the floor publishes
    per ``batch`` duplicates, and under the skip rule walks only the pairs
    some chain keeps; every other variant acts on kept pairs only and is
    the same under both. Returns drecT [rec, cap]; with ``count_pairs``
    also {"evaluated": ``evaluated_pairs``}."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    dev = recT.device
    n_tiles = tiles_x * tiles_y
    G = n_gates
    ch = kernel.ch_for(nq)
    znear, zfar = settings.znear, settings.zfar
    dmdt_num = zfar * znear / (zfar - znear)
    off = tile_offsets.to(torch.int64)
    recT, acc, dacc = recT.detach(), acc.detach(), dacc.detach()
    top, top_all = _tops(off, lk, acc, nq, G)
    count = {"evaluated": evaluated_pairs(variant, off, acc, lk, nq, G, recT,
                                          skip_rule)} if count_pairs else None
    if variant == "floor":
        drecT = _floor_plain(recT, off, top_all, nq, batch, skip_rule, lk,
                             acc, G)
        return (drecT, count) if count_pairs else drecT
    drecT = torch.zeros(recT.shape, dtype=torch.float32, device=dev)
    starts = off[:-1]
    lk64 = lk[..., 0].to(torch.int64)
    lkg64 = [acc[..., ch + 4 * g + 3].to(torch.int64) for g in range(G)]
    c_hi = (top_all - 1).div(CHUNK, rounding_mode="floor")
    n_chunks = torch.where(top_all > starts, c_hi - starts // CHUNK + 1,
                           torch.zeros_like(starts))
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
        ty = tb // tiles_x
        tx = tb - ty * tiles_x
        px = ((tx * kernel.TILE_W).to(torch.float32)[:, None] + sub_x
              + 0.5)[:, None]
        py = ((ty * kernel.TILE_H).to(torch.float32)[:, None] + sub_y
              + 0.5)[:, None]
        d = dacc[t0:t1]
        gq = d[..., :nq]
        g_alpha, g_depth = d[:, None, :, nq], d[:, None, :, nq + 1]
        g_m1, g_m2 = d[:, None, :, nq + 3], d[:, None, :, nq + 4]
        lk_b = lk64[t0:t1, None, :]
        u = 1.0 - acc[t0:t1, :, nq]
        s = torch.zeros_like(u)
        u_g = [1.0 - acc[t0:t1, :, ch + 4 * g] for g in range(G)]
        s_g = [torch.zeros_like(u) for _ in range(G)]

        for k in range(length):                      # top chunk first
            cid = c_hi[t0:t1, None] - k
            slot = cid * CHUNK + lane[None, :]                      # [Tb, S]
            inr = ((slot >= starts[t0:t1, None])
                   & (slot < top_all[t0:t1, None])
                   & (k < n_chunks[t0:t1, None]))
            visited = inr.any(dim=1)
            gidx = torch.where(inr, slot, torch.zeros_like(slot))
            geo = recT[:kernel.Q_ROW0, gidx][..., None]
            if variant != "no_vjp":
                geo = geo.requires_grad_(True)
            q = recT[kernel.Q_ROW0:kernel.Q_ROW0 + nq, gidx]      # [nq, Tb, S]
            with torch.enable_grad():
                opac = torch.where(inr[..., None], geo[9],
                                   torch.zeros_like(geo[9]))
                c2dx, c2dy, z = geo[6], geo[7], geo[8]
                m_rows = (geo[0], geo[3], c2dx * z, geo[1], geo[4],
                          c2dy * z, geo[2], geo[5], z)
                a, tdep = pair_alpha_depth(m_rows, (c2dx, c2dy), z, opac,
                                           opac > 0.0, px, py, znear)
            ad, td = a.detach(), tdep.detach()               # [Tb, S, P]
            keep = (ad > 0.0) & (gidx[..., None] <= lk_b)
            m = map_depth(td, znear, zfar)
            dmdt = dmdt_num / torch.clamp(td * td, min=1e-12)

            def omega_main(w):
                if variant == "no_gqqc":
                    gqq = w * 1e-6
                else:
                    gqq = sum(q[c][..., None] * gq[:, None, :, c]
                              for c in range(nq))
                return gqq + g_alpha + g_depth * td + g_m1 * m + g_m2 * m * m

            w, da, u, s = _reverse(variant, ad, keep, u, s, omega_main,
                                   visited)
            dt = w * (g_depth + (g_m1 + 2.0 * m * g_m2) * dmdt)
            gates = kernel.gate_bits(recT[kernel.Q_ROW0 + nq, gidx], G)[
                ..., None] if G else None
            for g in range(G):
                c0g = ch + 4 * g
                ga, gm1g, gm2g = (d[:, None, :, c0g + c] for c in range(3))
                ag = torch.where(gates[g], ad, torch.zeros_like(ad))
                keep_g = (ag > 0.0) & (gidx[..., None]
                                       <= lkg64[g][t0:t1, None, :])
                wg, dag, u_g[g], s_g[g] = _reverse(
                    variant, ag, keep_g, u_g[g], s_g[g],
                    lambda _: ga + gm1g * m + gm2g * m * m, visited)
                da = da + dag
                dt = dt + wg * (gm1g + 2.0 * m * gm2g) * dmdt

            if variant == "no_vjp":
                even = STANDIN * da.sum(-1)
                odd = STANDIN * dt.sum(-1)
                dgeo = chain_rows(geo[..., 0], torch.stack(
                    [even if i % 2 == 0 else odd for i in range(14)]))
            else:
                (dgeo,) = torch.autograd.grad((a, tdep), geo, (da, dt))
                dgeo = dgeo[..., 0]
            if variant == "no_dq":
                dq = torch.zeros((nq,) + gidx.shape, device=dev)
            else:
                dq = torch.stack([(gq[:, None, :, c] * w).sum(-1)
                                  for c in range(nq)])       # [nq, Tb, S]
            contrib = torch.cat([dgeo, dq], dim=0)
            drecT[:kernel.Q_ROW0 + nq, gidx[inr]] = contrib[:, inr]
    if count_pairs:
        return drecT, count
    return drecT


def bisect_backward_cuda(variant, recT, tile_offsets, tiles_x: int,
                         tiles_y: int, settings, acc, lk, dacc,
                         nq: int = kernel.NQ, n_gates: int = 0, out=None,
                         design: str = "sm90", tile_order=None):
    """Launch a T2 variant of ``design`` on the current stream: ``sm90``
    (``csrc/bisect_bwd_sm90.cu``, the production K2's design) runs its
    blocks on the tiles in ``tile_order`` (``StreamBinning.tile_order``,
    required), ``first`` (``csrc/bisect_bwd.cu``) in tile order and takes
    none. The kernel stores only the slots it walks, so the rest of dgrad
    must be zero: a fresh zeroed one by default, or ``out``, a zeroed
    [rec, cap] float32 buffer that repeated launches on the same inputs
    and variant may share (each stores the same values), keeping the
    memset out of a timed launch."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if design not in DESIGNS:
        raise ValueError(f"unknown design {design!r}; one of "
                         f"{tuple(DESIGNS)}")
    if design == "first" and tile_order is not None:
        raise ValueError("the first design runs the tiles in order and "
                         "takes no tile_order")
    if (nq, n_gates) not in (FULL_BUILT if variant == "full" else BUILT):
        raise ValueError(f"the variants are built at (nq, G) in {BUILT}, "
                         f"full also at {FULL_BUILT[len(BUILT):]}, got "
                         f"({nq}, {n_gates})")
    n_tiles = tiles_x * tiles_y
    kernel._check_blend_args("bisect_backward_cuda", recT, tile_offsets,
                             n_tiles, nq, n_gates, (acc, lk, dacc))
    chn = kernel.ch_for(nq) + 4 * n_gates
    if (acc.shape != (n_tiles, kernel.PIX, chn) or dacc.shape != acc.shape
            or lk.shape != (n_tiles, kernel.PIX, 1)
            or acc.dtype != torch.float32 or dacc.dtype != torch.float32
            or lk.dtype != torch.int32):
        raise ValueError(f"acc/dacc must be [{n_tiles}, {kernel.PIX}, {chn}]"
                         f" float32 and lk [{n_tiles}, {kernel.PIX}, 1] int32")
    dev = recT.device
    if design == "sm90":
        kernel._check_order(tile_order, n_tiles, dev)
    lib = cuda_lib.load_library()
    if out is None:
        dgrad = torch.zeros(recT.shape, dtype=torch.float32, device=dev)
    elif (out.shape != recT.shape or out.dtype != torch.float32
          or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 "
                         f"{tuple(recT.shape)} tensor on {dev}")
    else:
        dgrad = out
    znear, zfar, index, stream = kernel._launch_args(settings, dev)
    head = (VARIANTS.index(variant), recT.data_ptr(), recT.shape[0],
            recT.shape[1], nq, n_gates, kernel.Q_ROW0 + nq,
            tile_offsets.data_ptr())
    tail = (n_tiles, tiles_x, znear, zfar, acc.data_ptr(), lk.data_ptr(),
            dacc.data_ptr(), dgrad.data_ptr(), index, stream)
    if design == "sm90":
        rc = lib.su_bisect_bwd_sm90(*head, tile_order.data_ptr(), *tail)
    else:
        rc = lib.su_bisect_bwd(*head, *tail)
    cuda_lib.check(rc, f"bisect_bwd {variant} ({design}) launch")
    trace.launch_counts["bisect_bwd"] += 1
    return dgrad


def bisect_backward(variant, recT, tile_offsets, tiles_x: int, tiles_y: int,
                    settings, acc, lk, dacc, nq: int = kernel.NQ,
                    n_gates: int = 0, design: str = "sm90", tile_order=None):
    """A T2 variant of ``design``: its kernel on a CUDA tensor (``sm90``
    with ``tile_order``), its plain version with the design's batch and
    skip rule on a CPU tensor."""
    a = (variant, recT, tile_offsets, tiles_x, tiles_y, settings, acc, lk,
         dacc, nq, n_gates)
    if design not in DESIGNS:
        raise ValueError(f"unknown design {design!r}; one of "
                         f"{tuple(DESIGNS)}")
    if recT.device.type == "cpu":
        return bisect_backward_plain(*a, **DESIGNS[design])
    return bisect_backward_cuda(*a, design=design, tile_order=tile_order)


def cotangents(acc, nq: int, n_gates: int, seed: int = 3):
    """N(0, 1) cotangents from a numpy seed on every channel K2 reads (the
    spare, median and lk_g channels carry none)."""
    d = np.random.default_rng(seed).normal(size=tuple(acc.shape)).astype(
        np.float32)
    ch = kernel.ch_for(nq)
    d[..., nq + 2] = 0.0
    d[..., nq + 5] = 0.0
    for g in range(n_gates):
        d[..., ch + 4 * g + 3] = 0.0
    return torch.as_tensor(d, device=acc.device)


def main(argv=None):
    from streetunveiler_torch.tools import street, timing
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--gates", type=int, default=0, choices=(0, 5),
                    help="0: the photometric stream (nq 6); 5: the late "
                         "step's (nq 12, 5 gated chains)")
    ap.add_argument("--design", default="sm90", choices=tuple(DESIGNS),
                    help="sm90: the variants of the production K2 "
                         "(csrc/blend_bwd_sm90.cuh); first: of its first "
                         "design (csrc/blend_bwd.cuh)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    for v in args.variants:
        if v not in VARIANTS:
            raise SystemExit(f"unknown variant {v!r}: one of {VARIANTS}")
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
    recT, off, tx, ty, settings, nq, n_gates = street.street_stream(
        state, cam, late=args.gates == 5, device=args.device)
    order = tiles.tile_order(off)
    acc, lk = kernel.blend_forward(recT, off, tx, ty, settings, nq, n_gates,
                                   tile_order=order)
    a = (recT, off, tx, ty, settings, acc, lk,
         cotangents(acc, nq, n_gates), nq, n_gates)
    kw = dict(design=args.design,
              tile_order=order if args.design == "sm90" else None)
    full = bisect_backward("full", *a, **kw)

    def ms_of(v):
        buf = torch.zeros_like(full)
        return timing.median_ms(
            lambda: bisect_backward_cuda(v, *a, out=buf, **kw), args.reps)
    full_ms = None if cpu else ms_of("full")
    for v in args.variants:
        t0 = time.perf_counter()
        got = bisect_backward(v, *a, **kw)
        host = (time.perf_counter() - t0) * 1e3
        line = dict(variant=v, design=args.design, nq=nq, n_gates=n_gates,
                    max_abs_diff_from_full=float((got - full).abs().max()))
        if cpu:
            line["host_ms_cpu_plain"] = host
        else:
            line["ms"] = ms_of(v)
            line["ms_minus_full"] = line["ms"] - full_ms
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
