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

``blend_stream`` is the entry: an ``autograd.Function`` whose forward
launches kernel K1 (``csrc/blend_fwd.cu``) on a CUDA tensor and runs
``blend_forward_plain`` on a CPU tensor, and whose backward launches
kernel K2 (``csrc/blend_bwd.cu``) or runs ``blend_backward_plain`` the
same way. On a CUDA tensor a kernel that fails to build or launch raises;
nothing falls back to the plain versions.
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
    _check_blend_args("blend_forward_cuda", recT, tile_offsets, n_tiles, nq)
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


def blend_backward_plain(recT, tile_offsets, tiles_x: int, tiles_y: int,
                         settings: RasterizeSettings, acc, lk, dacc,
                         nq: int = NQ, tile_batch: int = 64,
                         count_pairs: bool = False):
    """Plain PyTorch version of kernel K2, the blend backward, vectorized
    over batches of ``tile_batch`` tiles.

    Each tile's duplicates are walked back to front in chunks of S_CHUNK,
    from the deepest one any of its pixels kept (``lk``), with a carried
    suffix transmittance U (from 1 − α_final) and suffix Σ w·Ω. Per kept
    pair (α > 0, index ≤ lk): T_excl = U/Π_{kept i≥j}(1−α_i),
    w = α·T_excl, Ω = gq·q + gα + g_depth·t + g_m1·m + g_m2·m²,
    dα = T_excl·Ω − S_{>j}/(1−α), dt = w·(g_depth + (g_m1 + 2m·g_m2)·dm/dt);
    the pair VJP onto record rows 0-9 is ``torch.autograd.grad`` of
    ``pair_alpha_depth`` with cotangents (dα, dt), and the payload rows get
    dq = Σ_p gq·w.

    recT [rec, cap], tile_offsets [T+1] int32, acc/dacc [T, PIX, nq+6],
    lk [T, PIX, 1] int32 → drecT [rec, cap] f32: per-duplicate record
    gradients in stream order (zero outside every tile's range and in the
    rows past Q_ROW0 + nq); with ``count_pairs`` also the number of kept
    (duplicate, pixel) pairs, those that pass the α and depth gates at or
    before the pixel's ``lk``.
    """
    dev = recT.device
    n_tiles = tiles_x * tiles_y
    znear, zfar = settings.znear, settings.zfar
    dmdt_num = zfar * znear / (zfar - znear)
    drecT = torch.zeros(recT.shape, dtype=torch.float32, device=dev)
    kept = torch.zeros((), dtype=torch.int64, device=dev)
    off = tile_offsets.to(torch.int64)
    counts = off[1:] - off[:-1]
    lk64 = lk[..., 0].to(torch.int64)                        # [T, PIX]
    # duplicates each tile walks: up to the deepest one a pixel kept
    depth = torch.where(lk64 >= 0, lk64 - off[:-1, None] + 1,
                        torch.zeros_like(lk64)).amax(dim=1)
    depth_host = depth.cpu()
    sub = torch.arange(PIX, device=dev)
    sub_x = (sub % TILE_W).to(torch.float32)
    sub_y = (sub // TILE_W).to(torch.float32)
    lane = torch.arange(S_CHUNK, device=dev)
    recT, acc, dacc = recT.detach(), acc.detach(), dacc.detach()

    for t0 in range(0, n_tiles, tile_batch):
        t1 = min(t0 + tile_batch, n_tiles)
        length = int(depth_host[t0:t1].max())
        if length == 0:
            continue
        tb = torch.arange(t0, t1, device=dev)
        ty = tb // tiles_x
        tx = tb - ty * tiles_x
        px = ((tx * TILE_W).to(torch.float32)[:, None] + sub_x + 0.5)[:, None]
        py = ((ty * TILE_H).to(torch.float32)[:, None] + sub_y + 0.5)[:, None]
        d = dacc[t0:t1]                                      # [Tb, P, ch]
        gq = d[..., :nq]
        g_alpha, g_depth = d[:, None, :, nq], d[:, None, :, nq + 1]
        g_m1, g_m2 = d[:, None, :, nq + 3], d[:, None, :, nq + 4]
        lk_b = lk64[t0:t1, None, :]                          # [Tb, 1, P]
        u = 1.0 - acc[t0:t1, :, nq]                          # [Tb, P]
        s = torch.zeros_like(u)

        for c0 in reversed(range(0, length, S_CHUNK)):
            j = c0 + lane                                    # [S]
            inr = j[None, :] < counts[t0:t1, None]           # [Tb, S]
            gidx = torch.where(inr, off[t0:t1, None] + j[None, :], 0)
            geo = recT[:Q_ROW0, gidx][..., None].requires_grad_(True)
            q = recT[Q_ROW0:Q_ROW0 + nq, gidx]               # [nq, Tb, S]
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
            if count_pairs:
                kept = kept + keep.sum()
            f = torch.where(keep, 1.0 - ad, torch.ones_like(ad))
            suffix = torch.flip(torch.cumprod(torch.flip(f, [1]), dim=1),
                                [1])
            t_excl = u[:, None, :] / suffix
            w = torch.where(keep, ad * t_excl, torch.zeros_like(ad))
            m = map_depth(td, znear, zfar)
            dmdt = dmdt_num / torch.clamp(td * td, min=1e-12)
            gqq = sum(q[k][..., None] * gq[:, None, :, k] for k in range(nq))
            omega = (gqq + g_alpha + g_depth * td + g_m1 * m
                     + g_m2 * m * m)
            womega = w * omega
            s_incl = torch.flip(torch.cumsum(torch.flip(womega, [1]), dim=1),
                                [1])
            s_after = s[:, None, :] + s_incl - womega         # strict suffix
            da = torch.where(keep, t_excl * omega - s_after / (1.0 - ad),
                             torch.zeros_like(ad))
            dt = w * (g_depth + (g_m1 + 2.0 * m * g_m2) * dmdt)
            u = u / suffix[:, 0, :]
            s = s + s_incl[:, 0, :]

            (dgeo,) = torch.autograd.grad((a, tdep), geo, (da, dt))
            dq = torch.stack([(gq[:, None, :, k] * w).sum(-1)
                              for k in range(nq)])           # [nq, Tb, S]
            contrib = torch.cat([dgeo[..., 0], dq], dim=0)
            drecT[:Q_ROW0 + nq, gidx[inr]] = contrib[:, inr]
    if count_pairs:
        return drecT, int(kept)
    return drecT


def _check_blend_args(name, recT, tile_offsets, n_tiles, nq, tensors=()):
    dev = recT.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (tile_offsets, *tensors)):
        raise ValueError(f"{name} needs every tensor on one CUDA device")
    if recT.dtype != torch.float32 or tile_offsets.dtype != torch.int32:
        raise TypeError("recT must be float32 and tile_offsets int32")
    if recT.dim() != 2 or recT.shape[0] < Q_ROW0 + nq:
        raise ValueError(f"recT must be [>= {Q_ROW0 + nq}, cap], "
                         f"got {tuple(recT.shape)}")
    if tile_offsets.shape != (n_tiles + 1,):
        raise ValueError(f"tile_offsets must be [{n_tiles + 1}], "
                         f"got {tuple(tile_offsets.shape)}")
    if not all(t.is_contiguous() for t in (recT, tile_offsets, *tensors)):
        raise ValueError(f"{name} needs contiguous tensors")
    if not 1 <= nq <= MAX_NQ:
        raise ValueError(f"the CUDA blend carries 1..{MAX_NQ} payload "
                         f"channels, got {nq}")


def blend_backward_cuda(recT, tile_offsets, tiles_x: int, tiles_y: int,
                        settings: RasterizeSettings, acc, lk, dacc,
                        nq: int = NQ):
    """Launch kernel K2 (``csrc/blend_bwd.cu``) on the current stream."""
    n_tiles = tiles_x * tiles_y
    _check_blend_args("blend_backward_cuda", recT, tile_offsets, n_tiles, nq,
                      (acc, lk, dacc))
    ch = ch_for(nq)
    if (acc.shape != (n_tiles, PIX, ch) or dacc.shape != acc.shape
            or lk.shape != (n_tiles, PIX, 1)):
        raise ValueError(f"acc/dacc must be [{n_tiles}, {PIX}, {ch}] and lk "
                         f"[{n_tiles}, {PIX}, 1]")
    if (acc.dtype != torch.float32 or dacc.dtype != torch.float32
            or lk.dtype != torch.int32):
        raise TypeError("acc and dacc must be float32 and lk int32")
    lib = cuda_lib.load_library()
    dev = recT.device
    dgrad = torch.zeros(recT.shape, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.su_blend_bwd(
        recT.data_ptr(), recT.shape[0], recT.shape[1], nq,
        tile_offsets.data_ptr(), n_tiles, tiles_x,
        ctypes.c_float(settings.znear), ctypes.c_float(settings.zfar),
        acc.data_ptr(), lk.data_ptr(), dacc.data_ptr(), dgrad.data_ptr(),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream)
    cuda_lib.check(rc, "blend_bwd launch")
    cuda_lib.launch_counts["blend_bwd"] += 1
    return dgrad


def blend_backward(recT, tile_offsets, tiles_x: int, tiles_y: int,
                   settings: RasterizeSettings, acc, lk, dacc, nq: int = NQ):
    """K2 on a CUDA tensor, its plain version on a CPU tensor."""
    if recT.device.type == "cpu":
        return blend_backward_plain(recT, tile_offsets, tiles_x, tiles_y,
                                    settings, acc, lk, dacc, nq)
    return blend_backward_cuda(recT, tile_offsets, tiles_x, tiles_y,
                               settings, acc, lk, dacc, nq)


class _BlendStream(torch.autograd.Function):
    @staticmethod
    def forward(ctx, recT, tile_offsets, tiles_x, tiles_y, settings, nq):
        acc, lk = blend_forward(recT, tile_offsets, tiles_x, tiles_y,
                                settings, nq)
        ctx.mark_non_differentiable(lk)
        ctx.save_for_backward(recT, tile_offsets, acc, lk)
        ctx.blend = (tiles_x, tiles_y, settings, nq)
        return acc, lk

    @staticmethod
    def backward(ctx, dacc, dlk):
        recT, tile_offsets, acc, lk = ctx.saved_tensors
        tiles_x, tiles_y, settings, nq = ctx.blend
        drecT = blend_backward(recT, tile_offsets, tiles_x, tiles_y,
                               settings, acc, lk, dacc.contiguous(), nq)
        return drecT, None, None, None, None, None


def blend_stream(recT, tile_offsets, tiles_x: int, tiles_y: int,
                 settings: RasterizeSettings, nq: int = NQ,
                 n_gates: int = 0):
    """Blend over the compact sorted duplicate stream.

    recT [rec, cap] f32 lane-major records in stream order
    (``api._gather_records``); tile_offsets [T+1] int32 from
    ``tiles.bin_surfels_stream``. Returns (acc [T, PIX, nq+6],
    lk [T, PIX, 1] int32). Every tile is written, empty ones as zeros
    with lk −1. Differentiable in ``recT``: the backward returns the
    per-duplicate record gradients [rec, cap] (kernel K2).
    """
    if n_gates:
        raise NotImplementedError(
            "gated per-class chains (n_gates > 0) are not ported yet: they "
            "come with the late-phase semantic slice")
    return _BlendStream.apply(recT, tile_offsets, tiles_x, tiles_y,
                              settings, nq)
