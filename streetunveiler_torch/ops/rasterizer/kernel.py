"""Blend forward over the tile-grouped duplicate stream: kernel K1 and its
plain PyTorch version (counterpart of ``streetunveiler_tpu/ops/
rasterizer/kernel.py``).

Packed per-duplicate record rows (REC=16 at the default NQ; must match
``pack_geometry_T``): 0-2 M's first column (K'a), 3-5 M's second column
(K'b), 6-7 projected center, 8 center depth, 9 opacity (0 ⇒ invalid — the
valid flag is folded in), 10.. payload (color, view normal, extra). M's
third column is (c2d_x·z, c2d_y·z, z) and is rebuilt from rows 6-8.

Channel layout of the per-tile accumulator [PIX, nq+6]: 0..nq-1 payload,
nq alpha, nq+1 expected-depth accumulator, nq+2 spare (zero; the
distortion α·m2 − m1² is computed by the caller), nq+3 m1 (Σωm), nq+4 m2
(Σωm²), nq+5 median depth.

``blend_stream`` is the entry: on a CUDA tensor it launches the CUDA
kernel ``csrc/blend_fwd.cu`` (or raises), on a CPU tensor it runs
``blend_forward_plain``. It is an ``autograd.Function`` whose backward —
kernel K2 — lands with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .blendmath import map_depth, pair_alpha_depth
from .types import MEDIAN_T, RasterizeSettings

TILE_H = 16
TILE_W = 32
PIX = TILE_H * TILE_W          # 512 pixels per tile, one CUDA thread each
S_CHUNK = 128                  # duplicates per chunk of the plain version
#                                and per stream chunk (capacity alignment)
Q_ROW0 = 10                    # first payload row (color) within the record
NQ = 6                         # default payload channels (3 color + 3 normal)
REC = 16                       # record rows at the default NQ
CH = 12                        # accumulator channels at the default NQ
MAX_NQ = 16                    # payload channels the CUDA kernel carries


def rec_for(nq: int) -> int:
    """Packed record rows for an nq-channel payload (8-row aligned)."""
    return -(-(Q_ROW0 + nq) // 8) * 8


def ch_for(nq: int) -> int:
    """Accumulator channels: nq payload + alpha, expected-depth, spare,
    m1, m2, median (same tail layout at every nq)."""
    return nq + 6


def pack_geometry_T(sur, n_surfels: int, extra_payload=None,
                    pad_column: bool = True):
    """SurfelScreen → packed per-surfel records, lane-major [rec, N+1].

    Column N is the zero record that stream-pad slots reference (opacity
    0 → never contributes). ``extra_payload`` [N, E] appends E payload
    rows after color+normal (nq = 6 + E). The result is the transpose of
    a row-major [N+1, rec] tensor."""
    validf = sur.valid.to(torch.float32)
    cols = [sur.M[:, :, 0], sur.M[:, :, 1], sur.center2d,
            sur.depth[:, None], (sur.opacity * validf)[:, None],
            sur.color, sur.normal]
    nq = NQ
    if extra_payload is not None:
        cols.append(extra_payload)
        nq = NQ + extra_payload.shape[1]
    rec_rows = rec_for(nq)
    rec = torch.cat(cols, dim=1)
    pad = rec_rows - rec.shape[1]
    dev = rec.device
    rec = torch.cat([rec, torch.zeros((n_surfels, pad), device=dev)], dim=1)
    if pad_column:
        rec = torch.cat([rec, torch.zeros((1, rec_rows), device=dev)], dim=0)
    return rec.T


def blend_forward_plain(recT, tile_offsets, tiles_x: int, tiles_y: int,
                        settings: RasterizeSettings, nq: int = NQ,
                        tile_batch: int = 64, count_pairs: bool = False):
    """Plain PyTorch version of kernel K1, vectorized over batches of
    ``tile_batch`` tiles: each tile's duplicates in chunks of S_CHUNK with
    a carried transmittance and done flag (``blendmath.chunk_weights``
    written out, plus the median and ``lk`` rules).

    recT [rec, cap] f32 lane-major records in stream order; tile_offsets
    [T+1] int32 CSR offsets. Returns (acc [T, PIX, nq+6], lk [T, PIX, 1]
    int32), and with ``count_pairs`` also the number of (duplicate, pixel)
    pairs the blend needs: per pixel, its tile's duplicates up to and
    including the one that froze it.
    """
    dev = recT.device
    n_tiles = tiles_x * tiles_y
    ch = ch_for(nq)
    t_eps = settings.t_eps
    acc = torch.zeros((n_tiles, PIX, ch), dtype=torch.float32, device=dev)
    lk = torch.full((n_tiles, PIX, 1), -1, dtype=torch.int32, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    off = tile_offsets.to(torch.int64)
    counts = off[1:] - off[:-1]
    counts_host = counts.cpu()
    sub = torch.arange(PIX, device=dev)
    sub_x = (sub % TILE_W).to(torch.float32)
    sub_y = (sub // TILE_W).to(torch.float32)
    lane = torch.arange(S_CHUNK, device=dev)

    for t0 in range(0, n_tiles, tile_batch):
        t1 = min(t0 + tile_batch, n_tiles)
        length = int(counts_host[t0:t1].max())
        if length == 0:
            continue
        tb = torch.arange(t0, t1, device=dev)
        nb = t1 - t0
        ty = tb // tiles_x
        tx = tb - ty * tiles_x
        px = ((tx * TILE_W).to(torch.float32)[:, None] + sub_x + 0.5)[:, None]
        py = ((ty * TILE_H).to(torch.float32)[:, None] + sub_y + 0.5)[:, None]

        t_carry = torch.ones((nb, PIX), device=dev)
        done = torch.zeros((nb, PIX), dtype=torch.bool, device=dev)
        payload = torch.zeros((nb, PIX, nq), device=dev)
        alpha, deptha, m1, m2, med = (torch.zeros((nb, PIX), device=dev)
                                      for _ in range(5))
        lk_b = torch.full((nb, PIX), -1, dtype=torch.int64, device=dev)
        for c0 in range(0, length, S_CHUNK):
            j = c0 + lane                                     # [S]
            inr = j[None, :] < counts[t0:t1, None]            # [Tb, S]
            gidx = torch.where(inr, off[t0:t1, None] + j[None, :], 0)
            chunk = recT[:, gidx][..., None]                  # [rec, Tb, S, 1]
            opac = torch.where(inr[..., None], chunk[9],
                               torch.zeros_like(chunk[9]))
            c2dx, c2dy, z = chunk[6], chunk[7], chunk[8]
            m_rows = (chunk[0], chunk[3], c2dx * z, chunk[1], chunk[4],
                      c2dy * z, chunk[2], chunk[5], z)
            a, tdep = pair_alpha_depth(m_rows, (c2dx, c2dy), z, opac,
                                       opac > 0.0, px, py, settings.znear)

            # chunk_weights along the duplicate axis (dim 1), written out
            # so that ``keep`` (which sets lk) is at hand
            one_minus = 1.0 - a
            cum_incl = torch.cumprod(one_minus, dim=1)
            t_excl = t_carry[:, None] * torch.cat(
                [torch.ones_like(cum_incl[:, :1]), cum_incl[:, :-1]], dim=1)
            t_after = t_carry[:, None] * cum_incl
            trigger = (a > 0.0) & (t_after < t_eps)
            n_trig = torch.cumsum(trigger.to(torch.int32), dim=1)
            dead = (n_trig > 0) | done[:, None]
            keep = (a > 0.0) & ~dead
            w = torch.where(keep, a * t_excl, torch.zeros_like(a))
            if count_pairs:
                before = (n_trig - trigger.to(torch.int32) > 0) | done[:, None]
                pairs = pairs + (inr[..., None] & ~before).sum()
            t_carry = t_carry * torch.prod(
                torch.where(keep, one_minus, torch.ones_like(one_minus)),
                dim=1)
            done = done | torch.any(trigger, dim=1)

            q = chunk[Q_ROW0:Q_ROW0 + nq, ..., 0]             # [nq, Tb, S]
            payload = payload + (w[..., None]
                                 * q.permute(1, 2, 0)[:, :, None, :]).sum(1)
            alpha = alpha + w.sum(1)
            deptha = deptha + (w * tdep).sum(1)
            m = map_depth(tdep, settings.znear, settings.zfar)
            wm = w * m
            m1 = m1 + wm.sum(1)
            m2 = m2 + (wm * m).sum(1)

            idx = lane[None, :, None].expand_as(w)
            none = torch.full_like(idx, -1)
            cand = (w > 0.0) & (t_excl > MEDIAN_T)
            best = torch.where(cand, idx, none).max(dim=1).values
            t_best = torch.gather(tdep, 1, best.clamp(min=0)[:, None])[:, 0]
            med = torch.where(best >= 0, t_best, med)
            lastk = torch.where(keep, idx, none).max(dim=1).values
            lk_new = torch.gather(gidx, 1, lastk.clamp(min=0))
            lk_b = torch.where(lastk >= 0, lk_new, lk_b)

        acc[t0:t1] = torch.cat(
            [payload, alpha[..., None], deptha[..., None],
             torch.zeros_like(alpha)[..., None], m1[..., None],
             m2[..., None], med[..., None]], dim=-1)
        lk[t0:t1, :, 0] = lk_b.to(torch.int32)
    if count_pairs:
        return acc, lk, int(pairs)
    return acc, lk


def blend_forward_cuda(recT, tile_offsets, tiles_x: int, tiles_y: int,
                       settings: RasterizeSettings, nq: int = NQ):
    """Launch kernel K1 (``csrc/blend_fwd.cu``) on the current stream."""
    n_tiles = tiles_x * tiles_y
    dev = recT.device
    if dev.type != "cuda" or tile_offsets.device != dev:
        raise ValueError("blend_forward_cuda needs recT and tile_offsets "
                         "on one CUDA device")
    if recT.dtype != torch.float32 or tile_offsets.dtype != torch.int32:
        raise TypeError("recT must be float32 and tile_offsets int32")
    if recT.dim() != 2 or recT.shape[0] < Q_ROW0 + nq:
        raise ValueError(f"recT must be [>= {Q_ROW0 + nq}, cap], "
                         f"got {tuple(recT.shape)}")
    if tile_offsets.shape != (n_tiles + 1,):
        raise ValueError(f"tile_offsets must be [{n_tiles + 1}], "
                         f"got {tuple(tile_offsets.shape)}")
    if not (recT.is_contiguous() and tile_offsets.is_contiguous()):
        raise ValueError("recT and tile_offsets must be contiguous")
    if not 1 <= nq <= MAX_NQ:
        raise ValueError(f"the CUDA blend carries 1..{MAX_NQ} payload "
                         f"channels, got {nq}")
    lib = cuda_lib.load_library()
    acc = torch.empty((n_tiles, PIX, ch_for(nq)), dtype=torch.float32,
                      device=dev)
    lk = torch.empty((n_tiles, PIX, 1), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.su_blend_fwd(
        recT.data_ptr(), recT.shape[0], recT.shape[1], nq,
        tile_offsets.data_ptr(), n_tiles, tiles_x,
        ctypes.c_float(settings.znear), ctypes.c_float(settings.zfar),
        ctypes.c_float(settings.t_eps), acc.data_ptr(), lk.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream)
    cuda_lib.check(rc, "blend_fwd launch")
    cuda_lib.launch_counts["blend_fwd"] += 1
    return acc, lk


def blend_forward(recT, tile_offsets, tiles_x: int, tiles_y: int,
                  settings: RasterizeSettings, nq: int = NQ):
    """K1 on a CUDA tensor, its plain version on a CPU tensor."""
    if recT.device.type == "cpu":
        return blend_forward_plain(recT, tile_offsets, tiles_x, tiles_y,
                                   settings, nq)
    return blend_forward_cuda(recT, tile_offsets, tiles_x, tiles_y,
                              settings, nq)


class _BlendStream(torch.autograd.Function):
    @staticmethod
    def forward(ctx, recT, tile_offsets, tiles_x, tiles_y, settings, nq):
        acc, lk = blend_forward(recT, tile_offsets, tiles_x, tiles_y,
                                settings, nq)
        ctx.mark_non_differentiable(lk)
        return acc, lk

    @staticmethod
    def backward(ctx, dacc, dlk):
        raise NotImplementedError(
            "the blend backward (kernel K2, the TPU `_bwd_kernel`) is not "
            "ported yet: it lands with the training slice")


def blend_stream(recT, tile_offsets, tiles_x: int, tiles_y: int,
                 settings: RasterizeSettings, nq: int = NQ,
                 n_gates: int = 0):
    """Blend over the compact sorted duplicate stream.

    recT [rec, cap] f32 lane-major records in stream order
    (``api._gather_records``); tile_offsets [T+1] int32 from
    ``tiles.bin_surfels_stream``. Returns (acc [T, PIX, nq+6],
    lk [T, PIX, 1] int32). Every tile is written, empty ones as zeros
    with lk −1.
    """
    if n_gates:
        raise NotImplementedError(
            "gated per-class chains (n_gates > 0) are not ported yet: they "
            "come with the late-phase semantic slice")
    return _BlendStream.apply(recT, tile_offsets, tiles_x, tiles_y,
                              settings, nq)
