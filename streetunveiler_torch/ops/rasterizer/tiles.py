"""Tile binning: surfels → a compact depth-sorted, tile-grouped duplicate
stream with per-tile CSR offsets (counterpart of
``streetunveiler_tpu/ops/rasterizer/tiles.py``).

1. Per-surfel tile rectangles; for surfels spanning at most CULL_KMAX
   tiles, the exact conic tile test drops the rectangle's tiles the
   contribution region misses before expansion, and the passing tiles'
   rect positions are packed as 4-bit nibbles into two words. On the card
   one kernel (``csrc/cull_sm90.cuh``) writes the per-surfel table; on the
   CPU its plain version ``cull_rects_plain``.
2. A stable depth argsort, one gather of the per-surfel table into depth
   rank, a cumsum of the per-surfel tile counts (``dup_start``).
3. The duplicate expansion — kernel K3 (``csrc/expand_sm90.cuh``, blocks
   of consecutive surfels storing their slots coalesced) on the card,
   ``expand_duplicates_plain`` on the CPU — then a stable sort by tile
   (depth order within each tile is preserved) and ``searchsorted`` for
   the CSR offsets. On overflow the farthest surfels' duplicates drop.
4. ``tile_order``: the tiles by descending duplicate count, the order in
   which the blend kernels K1 and K2 start them (longest first).

The TPU visit schedule (tile_of_visit … lane_hi) was a workaround for the
TPU's gather cost; the GPU blend walks each tile's CSR range instead.
"""

from __future__ import annotations

import dataclasses

import torch

from ... import trace
from . import cuda_lib

S_CHUNK = 128   # the stream capacity is a multiple of this
CULL_KMAX = 16  # AABB tile-span up to which the conic cull runs before
#                 duplicate expansion; wider surfels keep their rectangle
EXP_BLK = 1024  # the expansion's output length is cap rounded up to this


@dataclasses.dataclass(frozen=True)
class StreamBinning:
    """Compact sorted duplicate stream with per-tile CSR offsets."""

    sorted_surfel: torch.Tensor  # [cap] i32 surfel per duplicate; n = pad
    tile_offsets: torch.Tensor   # [T+1] i32 CSR offsets into the stream
    overflow: torch.Tensor       # [] bool — capacity exceeded
    demand: torch.Tensor         # [] i32 — uncapped duplicate total
    #                              (overflow ⟺ demand > capacity)
    tile_order: torch.Tensor     # [T] i32 ``tile_order(tile_offsets)``
    tiles_x: int = 0
    tiles_y: int = 0


def _divmod_small(k, d):
    """(q, r) = divmod(k, d) for non-negative int32 (floor division)."""
    q = torch.div(k, d, rounding_mode="floor")
    return q, k - q * d


def _tile_can_contribute(coefs, tx, ty, tile_w: int, tile_h: int):
    """Exact tile test against a surfel's contribution region.

    coefs: 13 tensors broadcastable against tx/ty —
    (ax,ay,az, bx,by,bz, cx,cy,cz, rho_max, d2max, c2dx, c2dy) from
    ``SurfelScreen.cull`` and the projected center, with
    k(p) = A + px·B + py·C. A (surfel, tile) pair survives iff some pixel
    center of the tile satisfies ρ2d ≤ ρ_max (disc) or ρ3d ≤ ρ_max
    (conic); the conic part checks ρ3d at every candidate minimum of the
    quadratic Q = kx²+ky²−ρ_max·kz² over the rect (4 corners, 4 edge
    criticals, the interior stationary point), so the test is exact."""
    ax, ay, az, bx, by, bz, cx, cy, cz, rho_max, d2max, c2dx, c2dy = coefs
    txf = tx.to(torch.float32)
    tyf = ty.to(torch.float32)
    xlo, xhi = txf * tile_w + 0.5, txf * tile_w + (tile_w - 0.5)
    ylo, yhi = tyf * tile_h + 0.5, tyf * tile_h + (tile_h - 0.5)

    # low-pass disc vs rect (exact)
    dx = torch.clamp(c2dx, xlo, xhi) - c2dx
    dy = torch.clamp(c2dy, ylo, yhi) - c2dy
    hit = dx * dx + dy * dy <= d2max

    # conic: quadratic coefficients of Q in (px, py)
    A = bx * bx + by * by - rho_max * bz * bz
    C = cx * cx + cy * cy - rho_max * cz * cz
    B = 2.0 * (bx * cx + by * cy - rho_max * bz * cz)
    D = 2.0 * (ax * bx + ay * by - rho_max * az * bz)
    E = 2.0 * (ax * cx + ay * cy - rho_max * az * cz)
    thresh = rho_max * 1.001 + 1e-6      # keep marginal pairs (f32 slack)

    def rho_at(px, py):
        kx = ax + px * bx + py * cx
        ky = ay + px * by + py * cy
        kz = az + px * bz + py * cz
        return (kx * kx + ky * ky) / torch.clamp(kz * kz, min=1e-24)

    def safe(q):
        tiny = torch.where(q < 0, torch.full_like(q, -1e-20),
                           torch.full_like(q, 1e-20))
        return torch.where(torch.abs(q) < 1e-20, tiny, q)

    for px, py in ((xlo, ylo), (xlo, yhi), (xhi, ylo), (xhi, yhi)):
        hit |= rho_at(px, py) <= thresh
    for py in (ylo, yhi):                 # dQ/dx = 0 on horizontal edges
        px = torch.clamp(-(B * py + D) / (2.0 * safe(A)), xlo, xhi)
        hit |= rho_at(px, py) <= thresh
    for px in (xlo, xhi):                 # dQ/dy = 0 on vertical edges
        py = torch.clamp(-(B * px + E) / (2.0 * safe(C)), ylo, yhi)
        hit |= rho_at(px, py) <= thresh
    det = safe(4.0 * A * C - B * B)       # interior stationary point
    px = torch.clamp((B * E - 2.0 * C * D) / det, xlo, xhi)
    py = torch.clamp((B * D - 2.0 * A * E) / det, ylo, yhi)
    hit |= rho_at(px, py) <= thresh
    return hit


def _pack_nibbles(pos):
    """[N, 8] values < 16 → one int32 word per row, value j at bits
    4j..4j+3 (two's complement when the top nibble is ≥ 8)."""
    shifts = torch.arange(8, device=pos.device, dtype=torch.int64) * 4
    word = (pos.to(torch.int64) << shifts).sum(dim=1)
    word = torch.where(word >= 2 ** 31, word - 2 ** 32, word)
    return word.to(torch.int32)


def expand_rows_plain(g, total_capped, tiles_x: int, n: int, sentinel: int,
                      has_cull: bool):
    """Per-slot (tile_id, surf_id) from gathered table rows g [capp, R]
    (x0, y0, nx, dup_start, surfel id[, small, w0, w1]) — the arithmetic
    of the TPU ``_expand_kernel``, elementwise; slots ≥ ``total_capped``
    get (sentinel, n)."""
    slot = torch.arange(g.shape[0], dtype=torch.int32, device=g.device)
    x0, y0, nx = g[:, 0], g[:, 1], g[:, 2]
    k = slot - g[:, 3]
    in_stream = slot < total_capped
    if has_cull:
        is_small = g[:, 5] > 0
        kk = torch.clamp(k, 0, CULL_KMAX - 1)
        prow = torch.where(kk < 8, g[:, 6], g[:, 7])
        pk = (prow >> ((kk & 7) * 4)) & 15
        k = torch.where(is_small, pk, k)
    q, r = _divmod_small(k, nx)
    tid = (y0 + q) * tiles_x + x0 + r
    return (torch.where(in_stream, tid, torch.full_like(tid, sentinel)),
            torch.where(in_stream, g[:, 4], torch.full_like(tid, n)))


def expand_duplicates_plain(tbl, dup_start, cap: int, tiles_x: int,
                            sentinel: int, has_cull: bool):
    """Plain version of kernel K3: slot → surfel rank via marks + cumsum,
    one row gather, then ``expand_rows_plain``."""
    n = tbl.shape[0]
    capp = -(-cap // EXP_BLK) * EXP_BLK
    pos = dup_start[1:-1].to(torch.int64)
    pos = pos[pos < capp]          # the TPU's scatter mode="drop"
    marks = torch.zeros(capp, dtype=torch.int32, device=tbl.device)
    marks.index_add_(0, pos, torch.ones_like(pos, dtype=torch.int32))
    rank = torch.clamp(torch.cumsum(marks, 0), max=n - 1)
    g = tbl[rank]                  # ranks lie in [0, n-1]: take mode="clip"
    total_capped = torch.clamp(dup_start[-1], max=cap)
    return expand_rows_plain(g, total_capped, tiles_x, n, sentinel, has_cull)


DESIGNS = ("sm90", "first")   # K3's redesign and its first design


def expand_duplicates_cuda(tbl, dup_start, cap: int, tiles_x: int,
                           sentinel: int, has_cull: bool,
                           design: str = "sm90"):
    """Launch kernel K3 on the current stream: its H100 design
    (``csrc/expand_sm90.cuh``, the default) or ``design="first"``, its
    first design (``csrc/expand.cu``); both give the same bits."""
    if design not in DESIGNS:
        raise ValueError(f"unknown design {design!r}; one of {DESIGNS}")
    dev = tbl.device
    n, rows = tbl.shape
    if dev.type != "cuda" or dup_start.device != dev:
        raise ValueError("expand_duplicates_cuda needs tbl and dup_start "
                         "on one CUDA device")
    if tbl.dtype != torch.int32 or dup_start.dtype != torch.int32:
        raise TypeError("tbl and dup_start must be int32")
    if rows != (8 if has_cull else 5) or dup_start.shape != (n + 1,) \
            or n < 1:
        raise ValueError(f"bad shapes tbl {tuple(tbl.shape)}, dup_start "
                         f"{tuple(dup_start.shape)} (has_cull={has_cull})")
    if not (tbl.is_contiguous() and dup_start.is_contiguous()):
        raise ValueError("tbl and dup_start must be contiguous")
    lib = cuda_lib.load_library()
    capp = -(-cap // EXP_BLK) * EXP_BLK
    tile_id = torch.empty(capp, dtype=torch.int32, device=dev)
    surf_id = torch.empty(capp, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    entry = lib.su_expand if design == "sm90" else lib.su_expand_first
    rc = entry(tbl.data_ptr(), rows, dup_start.data_ptr(), n, cap, capp,
               tiles_x, sentinel, int(has_cull), tile_id.data_ptr(),
               surf_id.data_ptr(), dev.index if dev.index is not None
               else torch.cuda.current_device(), stream)
    cuda_lib.check(rc, f"expand ({design}) launch")
    trace.launch_counts["expand"] += 1
    return tile_id, surf_id


def expand_duplicates(tbl, dup_start, cap: int, tiles_x: int, sentinel: int,
                      has_cull: bool):
    """Duplicate expansion: tbl [N, 5(+3)] int32 depth-ranked rows
    (x0, y0, nx, dup_start, surfel id[, small, w0, w1]) and dup_start
    [N+1] → (tile_id, surf_id) [capp], capp = cap rounded up to EXP_BLK.
    K3 on a CUDA tensor, its plain version on a CPU tensor."""
    if tbl.device.type == "cpu":
        return expand_duplicates_plain(tbl, dup_start, cap, tiles_x,
                                       sentinel, has_cull)
    return expand_duplicates_cuda(tbl, dup_start, cap, tiles_x, sentinel,
                                  has_cull)


def tile_rects(center2d, ext, valid, width: int, height: int, tile_w: int,
               tile_h: int, max_tiles_per_surfel: int = 256):
    """Per-surfel tile rectangles: (x0, y0, nx, rect_nt, nt) int32, nt the
    rectangle's tile count capped at ``max_tiles_per_surfel`` (0 where
    invalid)."""
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)
    cx, cy = center2d[:, 0], center2d[:, 1]
    ex, ey = ext[:, 0], ext[:, 1]
    cell = lambda v, size, hi: torch.clamp(torch.floor(v / size), 0,
                                           hi - 1).to(torch.int32)
    x0 = cell(cx - ex, tile_w, tiles_x)
    x1 = cell(cx + ex, tile_w, tiles_x)
    y0 = cell(cy - ey, tile_h, tiles_y)
    y1 = cell(cy + ey, tile_h, tiles_y)
    nx = x1 - x0 + 1
    rect_nt = nx * (y1 - y0 + 1)
    nt = torch.where(valid, torch.clamp(rect_nt, max=max_tiles_per_surfel),
                     torch.zeros_like(rect_nt))
    return x0, y0, nx, rect_nt, nt


def conic_cull(cull, center2d, rects, valid, tile_w: int, tile_h: int,
               max_tiles_per_surfel: int = 256):
    """The exact conic tile test of the surfels spanning at most CULL_KMAX
    tiles: (nt, [small, w0, w1] columns), nt their passing tile count
    (capped), the passing rect positions packed as nibbles."""
    x0, y0, nx, rect_nt, nt = rects
    n = center2d.shape[0]
    i32 = torch.int32
    coefs = torch.cat([cull, center2d], dim=1)
    coefs_k = tuple(coefs[:, i:i + 1] for i in range(13))
    ks = torch.arange(CULL_KMAX, dtype=i32, device=center2d.device)[None, :]
    kyk, kxk = _divmod_small(ks.expand(n, CULL_KMAX),
                             torch.clamp(nx, min=1)[:, None])
    passk = ((ks < rect_nt[:, None])
             & _tile_can_contribute(coefs_k, x0[:, None] + kxk,
                                    y0[:, None] + kyk, tile_w, tile_h))
    small = (rect_nt <= CULL_KMAX) & valid
    exact_nt = passk.sum(dim=1).to(i32)
    nt = torch.where(small,
                     torch.clamp(exact_nt, max=max_tiles_per_surfel), nt)
    w0, w1 = pack_positions(passk)
    return nt, [small[:, None].to(i32), w0[:, None], w1[:, None]]


def pack_positions(passk):
    """The rect positions of passk [N, CULL_KMAX] bool as a compact list,
    the passing ones first and each group in rect order (a stable sort),
    packed as nibbles: (w0, w1) [N] int32, positions 0-7 and 8-15."""
    ks = torch.arange(CULL_KMAX, dtype=torch.int32, device=passk.device)
    keys = torch.where(passk, ks, CULL_KMAX + ks)
    pos = torch.sort(keys, dim=1, stable=True).values % CULL_KMAX
    return _pack_nibbles(pos[:, :8]), _pack_nibbles(pos[:, 8:])


def depth_order(depth, valid):
    """The depth rank: one stable argsort, invalid surfels last. [N]
    int32."""
    key = torch.where(valid, depth, torch.full_like(depth, float("inf")))
    return torch.argsort(key, stable=True).to(torch.int32)


def surfel_table(rects, nt, cull_cols):
    """The per-surfel table [N, 4(+3)] int32, rows (x0, y0, max(nx, 1),
    nt[, small, w0, w1]), from ``tile_rects`` and ``conic_cull``."""
    x0, y0, nx = rects[:3]
    return torch.cat([x0[:, None], y0[:, None],
                      torch.clamp(nx, min=1)[:, None], nt[:, None]]
                     + cull_cols, dim=1)


def cull_rects_plain(cull, center2d, ext, valid, width: int, height: int,
                     tile_w: int, tile_h: int,
                     max_tiles_per_surfel: int = 256):
    """Plain version of the conic cull kernel: ``tile_rects`` +
    ``conic_cull`` + ``surfel_table``, the per-surfel table [N, 7]."""
    rects = tile_rects(center2d, ext, valid, width, height, tile_w, tile_h,
                       max_tiles_per_surfel)
    nt, cull_cols = conic_cull(cull, center2d, rects, valid, tile_w, tile_h,
                               max_tiles_per_surfel)
    return surfel_table(rects, nt, cull_cols)


def cull_rects_cuda(cull, center2d, ext, valid, width: int, height: int,
                    tile_w: int, tile_h: int, max_tiles_per_surfel: int = 256):
    """Launch the conic cull kernel (``csrc/cull_sm90.cuh``) on the current
    stream: ``cull_rects_plain``'s table [N, 7] int32, bit for bit but for
    w0 and w1 on the rows that are not small, which are 0 (K3 reads them
    only on small rows). cull [N, 11], center2d and ext [N, 2] float32,
    valid [N] bool, all contiguous on one CUDA device."""
    n = center2d.shape[0]
    f32 = torch.float32
    if (cull.dtype, center2d.dtype, ext.dtype, valid.dtype) != (
            f32, f32, f32, torch.bool):
        raise TypeError("cull, center2d and ext must be float32 and valid "
                        "bool")
    if (cull.shape != (n, 11) or center2d.shape != (n, 2)
            or ext.shape != (n, 2) or valid.shape != (n,) or n < 1):
        raise ValueError(f"bad shapes cull {tuple(cull.shape)}, center2d "
                         f"{tuple(center2d.shape)}, ext {tuple(ext.shape)}, "
                         f"valid {tuple(valid.shape)}")
    if not all(t.is_contiguous() for t in (cull, center2d, ext, valid)):
        raise ValueError("cull, center2d, ext and valid must be contiguous")
    dev = center2d.device
    if dev.type != "cuda" or any(t.device != dev for t in (cull, ext, valid)):
        raise ValueError("cull_rects_cuda needs its inputs on one CUDA "
                         "device")
    lib = cuda_lib.load_library()
    table = torch.empty((n, 7), dtype=torch.int32, device=dev)
    rc = lib.su_cull(center2d.data_ptr(), ext.data_ptr(), valid.data_ptr(),
                     cull.data_ptr(), n, width, height, tile_w, tile_h,
                     max_tiles_per_surfel, table.data_ptr(),
                     dev.index if dev.index is not None
                     else torch.cuda.current_device(),
                     torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(rc, "cull launch")
    trace.launch_counts["cull"] += 1
    return table


def rank_table(table, order):
    """One gather of the per-surfel table [N, 4(+3)] (``surfel_table``)
    into depth rank and the cumsum of its tile counts: (tbl, dup_start) as
    ``ranked_table`` returns them."""
    i32 = torch.int32
    tbl_s = table[order.long()]
    dup_start = torch.cat([torch.zeros(1, dtype=i32, device=order.device),
                           torch.cumsum(tbl_s[:, 3], 0).to(i32)])
    tbl = torch.cat([tbl_s[:, 0:3], dup_start[:-1, None], order[:, None],
                     tbl_s[:, 4:]], dim=1).contiguous()
    return tbl, dup_start


def ranked_table(center2d, ext, depth, valid, width: int, height: int,
                 tile_w: int, tile_h: int, max_tiles_per_surfel: int = 256,
                 cull=None):
    """The depth-ranked per-surfel table the duplicate expansion reads:
    tbl [N, 5(+3)] int32 rows (x0, y0, nx, dup_start, surfel id[, small,
    w0, w1]) and dup_start [N+1] int32, the cumsum of the per-surfel tile
    counts (dup_start[N] is the uncapped duplicate total). The stages:
    the per-surfel table (with ``cull`` the conic cull kernel on a CUDA
    tensor, ``cull_rects_plain`` on a CPU tensor; without, ``tile_rects``),
    then ``depth_order`` and ``rank_table``."""
    args = (center2d, ext, valid, width, height, tile_w, tile_h,
            max_tiles_per_surfel)
    with trace.span("bin.cull"):
        if cull is None:
            rects = tile_rects(*args)
            table = surfel_table(rects, rects[4], [])
        elif center2d.device.type == "cpu":
            table = cull_rects_plain(cull, *args)
        else:
            table = cull_rects_cuda(cull, *args)
    with trace.span("bin.depth_sort"):
        return rank_table(table, depth_order(depth, valid))


def tile_order(tile_offsets):
    """The tiles of the CSR ``tile_offsets`` [T+1] by descending duplicate
    count, ties in tile order (a stable sort): [T] int32, a permutation.
    Block b of K1 and K2 runs tile ``tile_order[b]``, so the longest tiles
    start first and none walks alone at the end; a tile's outputs do not
    depend on when it runs."""
    lengths = tile_offsets[1:] - tile_offsets[:-1]
    return torch.sort(lengths, descending=True, stable=True).indices.to(
        torch.int32)


def sort_by_tile(tile_id, surf_id):
    """The stream grouped by tile: a stable single-key sort, so depth order
    within each tile is preserved. (sorted tile ids, surfel per slot)."""
    s_tile, perm = torch.sort(tile_id, stable=True)
    return s_tile, surf_id[perm]


def csr_offsets(s_tile, n_tiles: int):
    """Per-tile CSR offsets [n_tiles + 1] int32 of the sorted tile ids."""
    return torch.searchsorted(
        s_tile, torch.arange(n_tiles + 1, dtype=torch.int32,
                             device=s_tile.device),
        side="left").to(torch.int32)


def bin_surfels_stream(center2d, ext, depth, valid, width: int, height: int,
                       tile_w: int, tile_h: int, dup_capacity: int,
                       max_tiles_per_surfel: int = 256,
                       cull=None) -> StreamBinning:
    """center2d [N,2], ext [N,2] per-axis extents, depth [N], valid [N].

    ``dup_capacity`` (multiple of S_CHUNK) is the stream size; on overflow
    the farthest surfels' duplicates are dropped (``overflow``).
    ``cull`` [N, 11] (``SurfelScreen.cull``) enables the exact conic tile
    test for surfels spanning at most CULL_KMAX tiles.
    """
    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)
    n_tiles = tiles_x * tiles_y
    cap = dup_capacity
    if cap % S_CHUNK:
        raise ValueError(f"dup_capacity {cap} is not a multiple of {S_CHUNK}")
    tbl, dup_start = ranked_table(center2d, ext, depth, valid, width, height,
                                  tile_w, tile_h, max_tiles_per_surfel, cull)
    total = dup_start[-1]
    with trace.span("bin.expand"):
        tile_id, surf_id = expand_duplicates(tbl, dup_start, cap, tiles_x,
                                             n_tiles, cull is not None)
    tile_id = tile_id[:cap]
    surf_id = surf_id[:cap]

    with trace.span("bin.tile_sort"):
        s_tile, s_surf = sort_by_tile(tile_id, surf_id)
        off = csr_offsets(s_tile, n_tiles)
        return StreamBinning(sorted_surfel=s_surf, tile_offsets=off,
                             overflow=total > cap, demand=total,
                             tiles_x=tiles_x, tiles_y=tiles_y,
                             tile_order=tile_order(off))
