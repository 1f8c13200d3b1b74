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

Gated per-class chains (``n_gates=G``): record row Q_ROW0 + nq, after the
payload (``api.encode_extra``), holds each surfel's class bitmask as an
exact float (bit g: the surfel belongs to
class g). Each class g runs its own transmittance chain over the main
chain's α gated by bit g, with its own early termination, and 4 channels
per class append after the main layout: α_g, m1_g, m2_g and lk_g (the
stream index of the class's last composited duplicate, as a float,
−1 if none; exact below 2^24). The main chain's channels and ``lk`` do not
depend on the gates.

``blend_stream`` is the entry: an ``autograd.Function`` whose forward
launches kernel K1 (``csrc/blend_fwd_sm90.cuh``, instantiated in
``blend_fwd.cu`` and ``blend_fwd_gated.cu``) on a CUDA tensor and runs
``blend_forward_plain`` on a CPU tensor, and whose backward launches
kernel K2 (``csrc/blend_bwd_sm90.cuh``, instantiated in ``blend_bwd.cu``
and ``blend_bwd_gated.cu``) or runs ``blend_backward_plain`` the same
way. The kernels start the tiles longest first, in the binning's
``StreamBinning.tile_order``; the plain versions' results do not depend
on the order. On a CUDA tensor a kernel that fails to build or launch
raises; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from ... import trace
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
MAX_GATES = 6                  # gated chains the CUDA kernels carry
GATED_NQ = (6, 12)             # payload widths gated K1/K2 are built for
MAX_STREAM = 1 << 24           # lk_g is a float: exact below 2^24


def rec_for(nq: int) -> int:
    """Packed record rows for an nq-channel payload (8-row aligned)."""
    return -(-(Q_ROW0 + nq) // 8) * 8


def ch_for(nq: int) -> int:
    """Accumulator channels: nq payload + alpha, expected-depth, spare,
    m1, m2, median (same tail layout at every nq)."""
    return nq + 6


def gate_bits(row, n_gates: int):
    """The G gates [G, ...] (bool) of a bitmask row of exact small floats:
    bit g of the integer the float holds (what the CUDA kernels compute
    as ``((int)row >> g) & 1``)."""
    bits = row.to(torch.int64)
    return torch.stack([((bits >> g) & 1).bool() for g in range(n_gates)])


def _chain_weights(a, t_carry, done, t_eps):
    """One chunk of a front-to-back chain along dim 1 (``blendmath.
    chunk_weights`` written out, with what the median, ``lk`` and the
    pair counts need). Returns (w, t_excl, keep, live_before, t_out,
    done_out); ``live_before``: the chain was not frozen before the pair."""
    one_minus = 1.0 - a
    cum_incl = torch.cumprod(one_minus, dim=1)
    t_excl = t_carry[:, None] * torch.cat(
        [torch.ones_like(cum_incl[:, :1]), cum_incl[:, :-1]], dim=1)
    t_after = t_carry[:, None] * cum_incl
    trigger = (a > 0.0) & (t_after < t_eps)
    n_trig = torch.cumsum(trigger.to(torch.int32), dim=1)
    keep = (a > 0.0) & ~((n_trig > 0) | done[:, None])
    live_before = ~((n_trig - trigger.to(torch.int32) > 0) | done[:, None])
    w = torch.where(keep, a * t_excl, torch.zeros_like(a))
    t_out = t_carry * torch.prod(
        torch.where(keep, one_minus, torch.ones_like(one_minus)), dim=1)
    return w, t_excl, keep, live_before, t_out, done | torch.any(trigger,
                                                                 dim=1)


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
                        n_gates: int = 0, tile_batch: int = 64,
                        count_pairs: bool = False, skip_rule: bool = False):
    """Plain PyTorch version of kernel K1, vectorized over batches of
    ``tile_batch`` tiles: each tile's duplicates in chunks of S_CHUNK with
    a carried transmittance and done flag per chain (``blendmath.
    chunk_weights`` written out, plus the median and ``lk`` rules).

    recT [rec, cap] f32 lane-major records in stream order; tile_offsets
    [T+1] int32 CSR offsets. Returns (acc [T, PIX, nq+6+4G], lk [T, PIX, 1]
    int32). With ``count_pairs`` also
    a dict of (duplicate, pixel) pair counts: ``evaluated``, the pairs the
    blend needs (per pixel, its tile's duplicates up to and including the
    last one a live chain reached), ``evaluated_skip_rule``, those of them
    the kernel evaluates (it skips a pair once the main chain is done and
    so is every chain of the duplicate's classes), ``kept`` (composited by
    the main chain) and ``gated_kept`` (composited by a gated chain,
    summed over the chains). ``skip_rule`` applies that skip: a skipped
    pair's α is set to 0 before the chains run, which leaves every output
    as it is exactly when the rule is exact.
    """
    dev = recT.device
    n_tiles = tiles_x * tiles_y
    ch = ch_for(nq)
    G = n_gates
    t_eps = settings.t_eps
    acc = torch.zeros((n_tiles, PIX, ch + 4 * G), dtype=torch.float32,
                      device=dev)
    for g in range(G):
        acc[..., ch + 4 * g + 3] = -1.0
    lk = torch.full((n_tiles, PIX, 1), -1, dtype=torch.int32, device=dev)
    tally = {k: torch.zeros((), dtype=torch.int64, device=dev)
             for k in ("evaluated", "evaluated_skip_rule", "kept",
                       "gated_kept")}
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
        tg_carry = [torch.ones((nb, PIX), device=dev) for _ in range(G)]
        done_g = [torch.zeros((nb, PIX), dtype=torch.bool, device=dev)
                  for _ in range(G)]
        sums_g = torch.zeros((G, 3, nb, PIX), device=dev)  # α_g, m1_g, m2_g
        lk_g = torch.full((G, nb, PIX), -1.0, device=dev)
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
            m = map_depth(tdep, settings.znear, settings.zfar)
            idx = lane[None, :, None].expand_as(a)
            none = torch.full_like(idx, -1)
            gates = gate_bits(chunk[Q_ROW0 + nq], G) if G else None
            carried = (t_carry, done, list(tg_carry), list(done_g))

            def chains(a):
                """The main and gated chains over this chunk from the
                carried state: (main, [per gate], live, needed), where
                ``needed`` marks the pairs a live chain of the pair's own
                classes reaches (the kernel's skip rule keeps them)."""
                main = _chain_weights(a, carried[0], carried[1], t_eps)
                per_g, live, needed = [], main[3], main[3]
                for g in range(G):                            # [G, Tb, S, 1]
                    ag = torch.where(gates[g], a, torch.zeros_like(a))
                    per_g.append(_chain_weights(ag, carried[2][g],
                                                carried[3][g], t_eps))
                    live = live | per_g[g][3]
                    needed = needed | (gates[g] & per_g[g][3])
                return main, per_g, live, needed

            main, per_g, live, needed = chains(a)
            if skip_rule and G:
                a = torch.where(needed, a, torch.zeros_like(a))
                main, per_g, _, _ = chains(a)
            w, t_excl, keep, _, t_carry, done = main
            for g in range(G):
                wg, _, keep_g, _, tg_carry[g], done_g[g] = per_g[g]
                wgm = wg * m
                sums_g[g] += torch.stack([wg.sum(1), wgm.sum(1),
                                          (wgm * m).sum(1)])
                last_g = torch.where(keep_g, idx, none).max(dim=1).values
                lk_new = torch.gather(gidx, 1, last_g.clamp(min=0))
                lk_g[g] = torch.where(last_g >= 0, lk_new.to(torch.float32),
                                      lk_g[g])
                if count_pairs:
                    tally["gated_kept"] += keep_g.sum()
            if count_pairs:
                tally["evaluated"] += (inr[..., None] & live).sum()
                tally["evaluated_skip_rule"] += (inr[..., None] & live
                                                 & needed).sum()
                tally["kept"] += keep.sum()

            q = chunk[Q_ROW0:Q_ROW0 + nq, ..., 0]             # [nq, Tb, S]
            payload = payload + (w[..., None]
                                 * q.permute(1, 2, 0)[:, :, None, :]).sum(1)
            alpha = alpha + w.sum(1)
            deptha = deptha + (w * tdep).sum(1)
            wm = w * m
            m1 = m1 + wm.sum(1)
            m2 = m2 + (wm * m).sum(1)

            cand = (w > 0.0) & (t_excl > MEDIAN_T)
            best = torch.where(cand, idx, none).max(dim=1).values
            t_best = torch.gather(tdep, 1, best.clamp(min=0)[:, None])[:, 0]
            med = torch.where(best >= 0, t_best, med)
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
                    nb, PIX, 4 * G)
        lk[t0:t1, :, 0] = lk_b.to(torch.int32)
    if count_pairs:
        return acc, lk, {k: int(v) for k, v in tally.items()}
    return acc, lk


def _launch_args(settings, dev):
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return (ctypes.c_float(settings.znear), ctypes.c_float(settings.zfar),
            index, torch.cuda.current_stream(dev).cuda_stream)


def _refuse_unbuilt(nq, n_gates):
    if n_gates and nq not in GATED_NQ:
        raise ValueError(f"the CUDA blend carries gated chains at nq in "
                         f"{GATED_NQ} (colour + normal, and with the "
                         f"semantic payload), got nq={nq}")


def _check_order(tile_order, n_tiles, dev):
    """The kernels take the binning's tile order
    (``StreamBinning.tile_order``, ``tiles.tile_order`` of the offsets):
    a permutation of the tiles. A block whose entry names no tile leaves
    it unwritten."""
    if (tile_order is None or tile_order.shape != (n_tiles,)
            or tile_order.dtype != torch.int32 or tile_order.device != dev
            or not tile_order.is_contiguous()):
        raise ValueError(f"the CUDA blend needs the binning's tile_order: "
                         f"a contiguous int32 [{n_tiles}] on {dev}")


def blend_forward_cuda(recT, tile_offsets, tiles_x: int, tiles_y: int,
                       settings: RasterizeSettings, nq: int = NQ,
                       n_gates: int = 0, tile_order=None):
    """Launch kernel K1 (``csrc/blend_fwd_sm90.cuh``) on the current
    stream, its blocks on the tiles in ``tile_order``
    (``StreamBinning.tile_order``)."""
    n_tiles = tiles_x * tiles_y
    dev = recT.device
    _refuse_unbuilt(nq, n_gates)
    _check_blend_args("blend_forward_cuda", recT, tile_offsets, n_tiles, nq,
                      n_gates)
    _check_order(tile_order, n_tiles, dev)
    lib = cuda_lib.load_library()
    acc = torch.empty((n_tiles, PIX, ch_for(nq) + 4 * n_gates),
                      dtype=torch.float32, device=dev)
    lk = torch.empty((n_tiles, PIX, 1), dtype=torch.int32, device=dev)
    znear, zfar, index, stream = _launch_args(settings, dev)
    rc = lib.su_blend_fwd(
        recT.data_ptr(), recT.shape[0], recT.shape[1], nq, n_gates,
        Q_ROW0 + nq, tile_offsets.data_ptr(), tile_order.data_ptr(),
        n_tiles, tiles_x, znear, zfar,
        ctypes.c_float(settings.t_eps), acc.data_ptr(), lk.data_ptr(), index,
        stream)
    cuda_lib.check(rc, "blend_fwd launch")
    trace.launch_counts["blend_fwd_gated" if n_gates else "blend_fwd"] += 1
    return acc, lk


def blend_forward(recT, tile_offsets, tiles_x: int, tiles_y: int,
                  settings: RasterizeSettings, nq: int = NQ,
                  n_gates: int = 0, tile_order=None):
    """K1 on a CUDA tensor, its plain version on a CPU tensor."""
    if recT.device.type == "cpu":
        return blend_forward_plain(recT, tile_offsets, tiles_x, tiles_y,
                                   settings, nq, n_gates)
    return blend_forward_cuda(recT, tile_offsets, tiles_x, tiles_y,
                              settings, nq, n_gates, tile_order)


def blend_backward_plain(recT, tile_offsets, tiles_x: int, tiles_y: int,
                         settings: RasterizeSettings, acc, lk, dacc,
                         nq: int = NQ, n_gates: int = 0,
                         tile_batch: int = 64, count_pairs: bool = False,
                         skip_rule: bool = False):
    """Plain PyTorch version of kernel K2, the blend backward, vectorized
    over batches of ``tile_batch`` tiles.

    Each tile's duplicates are walked back to front in chunks of S_CHUNK,
    from the deepest one any of its pixels kept on any chain, with a
    carried suffix transmittance U (from 1 − α_final) and suffix Σ w·Ω per
    chain. Per pair kept by the main chain (α > 0, index ≤ lk):
    T_excl = U/Π_{kept i≥j}(1−α_i), w = α·T_excl,
    Ω = gq·q + gα + g_depth·t + g_m1·m + g_m2·m²,
    dα = T_excl·Ω − S_{>j}/(1−α), dt = w·(g_depth + (g_m1 + 2m·g_m2)·dm/dt).
    Per pair kept by gated chain g (α·gate_g > 0, index ≤ lk_g), the same
    with U_g from 1 − α_g, Ω_g = gα_g + gm1_g·m + gm2_g·m² and
    dt_g = w_g·(gm1_g + 2m·gm2_g)·dm/dt, added to (dα, dt). The pair VJP
    onto record rows 0-9 is ``torch.autograd.grad`` of
    ``pair_alpha_depth`` with cotangents (dα, dt), and the payload rows get
    dq = Σ_p gq·w (main chain).

    recT [rec, cap], tile_offsets [T+1] int32, acc/dacc [T, PIX, nq+6+4G],
    lk [T, PIX, 1] int32 → drecT [rec, cap] f32: per-duplicate record
    gradients in stream order (zero outside every tile's range and in the
    rows past Q_ROW0 + nq, the gate row included); with ``count_pairs``
    also a dict of pair counts: ``evaluated`` (per pixel, its tile's
    duplicates up to its deepest lk or lk_g), ``evaluated_skip_rule``
    (those the kernel evaluates: index ≤ lk, or bit g set and index ≤
    lk_g for some g), ``kept`` (main chain), ``gated_kept`` (summed over
    the gated chains) and ``any_kept`` (pairs that reach the pair VJP:
    kept by some chain). ``skip_rule`` sets the α of every other pair to
    0 before the chains run, which leaves the gradient as it is exactly
    when the rule is exact.
    """
    dev = recT.device
    n_tiles = tiles_x * tiles_y
    G = n_gates
    ch = ch_for(nq)
    znear, zfar = settings.znear, settings.zfar
    dmdt_num = zfar * znear / (zfar - znear)
    drecT = torch.zeros(recT.shape, dtype=torch.float32, device=dev)
    tally = {k: torch.zeros((), dtype=torch.int64, device=dev)
             for k in ("evaluated", "evaluated_skip_rule", "kept",
                       "gated_kept", "any_kept")}
    off = tile_offsets.to(torch.int64)
    counts = off[1:] - off[:-1]
    lk64 = lk[..., 0].to(torch.int64)                        # [T, PIX]
    lkg64 = torch.stack([acc[..., ch + 4 * g + 3].to(torch.int64)
                         for g in range(G)]) if G else None  # [G, T, PIX]
    top = lk64 if not G else torch.maximum(lk64, lkg64.amax(dim=0))
    # duplicates each pixel needs: up to the deepest one a chain kept
    need = torch.where(top >= 0, top - off[:-1, None] + 1,
                       torch.zeros_like(top))
    if count_pairs:
        tally["evaluated"] += need.sum()
    depth_host = need.amax(dim=1).cpu()
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
        u_g = [1.0 - acc[t0:t1, :, ch + 4 * g] for g in range(G)]
        s_g = [torch.zeros_like(u) for _ in range(G)]

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
            gates = gate_bits(recT[Q_ROW0 + nq, gidx], G)[..., None] if G \
                else None
            # the pairs the kernel evaluates: a chain of the pair's own
            # classes still scans it
            needed = gidx[..., None] <= lk_b
            for g in range(G):
                needed = needed | (gates[g] & (gidx[..., None]
                                               <= lkg64[g, t0:t1, None, :]))
            if skip_rule:
                with torch.enable_grad():
                    a = torch.where(needed, a, torch.zeros_like(a))
            if count_pairs:
                tally["evaluated_skip_rule"] += (inr[..., None] & needed).sum()
            ad, td = a.detach(), tdep.detach()               # [Tb, S, P]
            keep = (ad > 0.0) & (gidx[..., None] <= lk_b)
            m = map_depth(td, znear, zfar)
            dmdt = dmdt_num / torch.clamp(td * td, min=1e-12)
            gqq = sum(q[k][..., None] * gq[:, None, :, k] for k in range(nq))
            omega = (gqq + g_alpha + g_depth * td + g_m1 * m
                     + g_m2 * m * m)
            w, da, u, s = _reverse_chain(ad, keep, u, s, omega)
            dt = w * (g_depth + (g_m1 + 2.0 * m * g_m2) * dmdt)

            any_kept = keep
            for g in range(G):
                c0g = ch + 4 * g
                ga, gm1g, gm2g = (d[:, None, :, c0g + k] for k in range(3))
                ag = torch.where(gates[g], ad, torch.zeros_like(ad))
                keep_g = (ag > 0.0) & (gidx[..., None]
                                       <= lkg64[g, t0:t1, None, :])
                omg = ga + gm1g * m + gm2g * m * m
                wg, dag, u_g[g], s_g[g] = _reverse_chain(ag, keep_g, u_g[g],
                                                         s_g[g], omg)
                da = da + dag
                dt = dt + wg * (gm1g + 2.0 * m * gm2g) * dmdt
                any_kept = any_kept | keep_g
                if count_pairs:
                    tally["gated_kept"] += keep_g.sum()
            if count_pairs:
                tally["kept"] += keep.sum()
                tally["any_kept"] += any_kept.sum()

            (dgeo,) = torch.autograd.grad((a, tdep), geo, (da, dt))
            dq = torch.stack([(gq[:, None, :, k] * w).sum(-1)
                              for k in range(nq)])           # [nq, Tb, S]
            contrib = torch.cat([dgeo[..., 0], dq], dim=0)
            drecT[:Q_ROW0 + nq, gidx[inr]] = contrib[:, inr]
    if count_pairs:
        return drecT, {k: int(v) for k, v in tally.items()}
    return drecT


def _reverse_chain(a, keep, u, s, omega):
    """One chunk of a chain's reverse scan along dim 1 (duplicates), for
    the kept pairs: T_excl = U/Π_{kept i≥j}(1−α_i), w = α·T_excl and
    dα = T_excl·Ω − S_{>j}/(1−α). Returns (w, dα, U, S) with U and S
    carried past the chunk."""
    f = torch.where(keep, 1.0 - a, torch.ones_like(a))
    suffix = torch.flip(torch.cumprod(torch.flip(f, [1]), dim=1), [1])
    t_excl = u[:, None, :] / suffix
    w = torch.where(keep, a * t_excl, torch.zeros_like(a))
    womega = w * omega
    s_incl = torch.flip(torch.cumsum(torch.flip(womega, [1]), dim=1), [1])
    s_after = s[:, None, :] + s_incl - womega             # strict suffix
    da = torch.where(keep, t_excl * omega - s_after / (1.0 - a),
                     torch.zeros_like(a))
    return w, da, u / suffix[:, 0, :], s + s_incl[:, 0, :]


def _check_blend_args(name, recT, tile_offsets, n_tiles, nq, n_gates,
                      tensors=()):
    dev = recT.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (tile_offsets, *tensors)):
        raise ValueError(f"{name} needs every tensor on one CUDA device")
    if recT.dtype != torch.float32 or tile_offsets.dtype != torch.int32:
        raise TypeError("recT must be float32 and tile_offsets int32")
    rows = Q_ROW0 + nq + (1 if n_gates else 0)
    if recT.dim() != 2 or recT.shape[0] < rows:
        raise ValueError(f"recT must be [>= {rows}, cap], "
                         f"got {tuple(recT.shape)}")
    if not 0 <= n_gates <= MAX_GATES:
        raise ValueError(f"the CUDA blend carries 0..{MAX_GATES} gated "
                         f"chains, got {n_gates}")
    if n_gates and recT.shape[1] >= MAX_STREAM:
        raise ValueError(f"gated chains need a stream below 2^24 slots "
                         f"(lk_g is a float), got {recT.shape[1]}")
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
                        nq: int = NQ, n_gates: int = 0, tile_order=None):
    """Launch kernel K2 (``csrc/blend_bwd_sm90.cuh``) on the current
    stream, its blocks on the tiles in ``tile_order``
    (``StreamBinning.tile_order``)."""
    n_tiles = tiles_x * tiles_y
    _refuse_unbuilt(nq, n_gates)
    _check_blend_args("blend_backward_cuda", recT, tile_offsets, n_tiles, nq,
                      n_gates, (acc, lk, dacc))
    ch = ch_for(nq) + 4 * n_gates
    if (acc.shape != (n_tiles, PIX, ch) or dacc.shape != acc.shape
            or lk.shape != (n_tiles, PIX, 1)):
        raise ValueError(f"acc/dacc must be [{n_tiles}, {PIX}, {ch}] and lk "
                         f"[{n_tiles}, {PIX}, 1]")
    if (acc.dtype != torch.float32 or dacc.dtype != torch.float32
            or lk.dtype != torch.int32):
        raise TypeError("acc and dacc must be float32 and lk int32")
    dev = recT.device
    _check_order(tile_order, n_tiles, dev)
    lib = cuda_lib.load_library()
    dgrad = torch.zeros(recT.shape, dtype=torch.float32, device=dev)
    znear, zfar, index, stream = _launch_args(settings, dev)
    rc = lib.su_blend_bwd(
        recT.data_ptr(), recT.shape[0], recT.shape[1], nq, n_gates,
        Q_ROW0 + nq, tile_offsets.data_ptr(), tile_order.data_ptr(),
        n_tiles, tiles_x, znear, zfar,
        acc.data_ptr(), lk.data_ptr(), dacc.data_ptr(), dgrad.data_ptr(),
        index, stream)
    cuda_lib.check(rc, "blend_bwd launch")
    trace.launch_counts["blend_bwd_gated" if n_gates else "blend_bwd"] += 1
    return dgrad


def blend_backward(recT, tile_offsets, tiles_x: int, tiles_y: int,
                   settings: RasterizeSettings, acc, lk, dacc, nq: int = NQ,
                   n_gates: int = 0, tile_order=None):
    """K2 on a CUDA tensor, its plain version on a CPU tensor."""
    if recT.device.type == "cpu":
        return blend_backward_plain(recT, tile_offsets, tiles_x, tiles_y,
                                    settings, acc, lk, dacc, nq, n_gates)
    return blend_backward_cuda(recT, tile_offsets, tiles_x, tiles_y,
                               settings, acc, lk, dacc, nq, n_gates,
                               tile_order)


class _BlendStream(torch.autograd.Function):
    @staticmethod
    def forward(ctx, recT, tile_offsets, tiles_x, tiles_y, settings, nq,
                n_gates, tile_order):
        with trace.span("raster.blend_fwd"):
            acc, lk = blend_forward(recT, tile_offsets, tiles_x, tiles_y,
                                    settings, nq, n_gates, tile_order)
        ctx.mark_non_differentiable(lk)
        ctx.save_for_backward(recT, tile_offsets, acc, lk)
        ctx.blend = (tiles_x, tiles_y, settings, nq, n_gates, tile_order)
        return acc, lk

    @staticmethod
    def backward(ctx, dacc, dlk):
        recT, tile_offsets, acc, lk = ctx.saved_tensors
        tiles_x, tiles_y, settings, nq, n_gates, tile_order = ctx.blend
        with trace.span("raster.blend_bwd"):
            drecT = blend_backward(recT, tile_offsets, tiles_x, tiles_y,
                                   settings, acc, lk, dacc.contiguous(), nq,
                                   n_gates, tile_order=tile_order)
        return (drecT,) + (None,) * 7


def blend_stream(recT, tile_offsets, tiles_x: int, tiles_y: int,
                 settings: RasterizeSettings, nq: int = NQ,
                 n_gates: int = 0, tile_order=None):
    """Blend over the compact sorted duplicate stream.

    recT [rec, cap] f32 lane-major records in stream order
    (``api._gather_records``); tile_offsets [T+1] int32 from
    ``tiles.bin_surfels_stream``. ``n_gates`` > 0 runs that many gated
    per-class chains in the same pass, their class bitmask in record row
    Q_ROW0 + nq. Returns (acc [T, PIX, nq+6+4G],
    lk [T, PIX, 1] int32). Every tile is written, empty ones as zeros
    with lk and every lk_g −1. Differentiable in ``recT``: the backward
    returns the per-duplicate record gradients [rec, cap] (kernel K2),
    zero on the gate row. ``tile_order`` [T] int32: the order in which
    the kernels start the tiles, ``StreamBinning.tile_order`` (needed on
    the card; the plain versions on the CPU take none).
    """
    return _BlendStream.apply(recT, tile_offsets, tiles_x, tiles_y,
                              settings, nq, n_gates, tile_order)
