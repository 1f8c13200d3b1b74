"""Public rasterization API: the tiled, differentiable render
(counterpart of ``streetunveiler_tpu/ops/rasterizer/api.py``).

``rasterize`` = ``preprocess_surfels`` → ``bin_surfels_stream`` (duplicate
expansion: kernel K3) → ``_gather_records`` → ``blend_stream`` (kernel K1
forward, kernel K2 backward) → image assembly. The backward runs K2, then
the record-grad scatter (autograd's ``index_select`` backward), then
autograd through the preprocess; the binning is gradient-free. Colors are
precomputed by the caller; the static capacity ``duplicate_capacity``
replaces dynamic allocation, and overflow is reported, not hidden.
"""

from __future__ import annotations

import torch

from ... import trace
from .kernel import NQ, S_CHUNK, TILE_H, TILE_W, blend_stream, ch_for, \
    pack_geometry_T
from .preprocess import preprocess_surfels
from .tiles import bin_surfels_stream
from .types import RasterizeSettings, RenderOutput


def default_duplicate_capacity(n_surfels: int, width: int, height: int,
                               avg_tiles_per_surfel: float = 4.5) -> int:
    """A practical static capacity for the sorted duplicate stream
    (4.5 tiles per surfel plus 16 chunks, chunk-aligned). Undersizing
    degrades gracefully: the farthest surfels drop and
    ``RenderOutput.overflow`` says so."""
    cap = int(n_surfels * avg_tiles_per_surfel) + 16 * S_CHUNK
    return -(-cap // S_CHUNK) * S_CHUNK


@torch.no_grad()
def bin_for_camera(means3d, scales, quats, opacities, w2c, K,
                   settings: RasterizeSettings,
                   max_tiles_per_surfel: int = 256,
                   duplicate_capacity: int | None = None,
                   center2d_offset=None):
    """Preprocess + tile binning alone → ``StreamBinning`` (no gradient)."""
    n = means3d.shape[0]
    if duplicate_capacity is None:
        duplicate_capacity = default_duplicate_capacity(
            n, settings.width, settings.height)
    with trace.span("bin.preprocess"):
        zeros3 = torch.zeros((n, 3), device=means3d.device)
        sur = preprocess_surfels(means3d, scales, quats, opacities, zeros3,
                                 w2c, K, settings,
                                 center2d_offset=center2d_offset)
    return bin_surfels_stream(sur.center2d, sur.ext, sur.depth, sur.valid,
                              settings.width, settings.height, TILE_W,
                              TILE_H, duplicate_capacity,
                              max_tiles_per_surfel, cull=sur.cull)


def _gather_records(packT, idx):
    """Lane-axis take: packT [rec, N+1] → the records of the stream's
    duplicates in stream order, [rec, cap], contiguous (the layout the
    blend kernels load coalesced). Its backward, the record-grad scatter,
    is autograd's for ``index_select``: a library ``index_add_`` along the
    columns, as the JAX package leaves this scatter-add to XLA. Pad slots
    reference column N (the zero record); it takes their gradients and
    ``pack_geometry_T``'s backward drops it. On a card the scatter adds
    with atomics, so the sums' order, and their last bits, vary from run
    to run. While tracing, the range ``raster.record_scatter`` holds the
    scatter (hooks on the ``index_select`` node)."""
    recT = packT.index_select(1, idx)
    trace.backward_span("raster.record_scatter", recT)
    return recT.contiguous()


@torch.no_grad()
def bin_inputs_for_camera(means3d, scales, quats, opacities, w2c, K,
                          settings: RasterizeSettings,
                          center2d_offset=None):
    """Full-frame, slab-shiftable binning inputs (no gradient):
    ``(center2d, ext, depth, valid, cull)`` computed once with the FULL
    camera. A tile-sharded step computes them for its shard of the
    surfels, all-gathers them over ``tile`` and derives each slab's
    binning with ``bin_slab_from_inputs``; ``valid`` is the full frame's
    on-screen test (slab visibility, a subset, is derived per slab)."""
    zeros3 = torch.zeros((means3d.shape[0], 3), device=means3d.device)
    sur = preprocess_surfels(means3d, scales, quats, opacities, zeros3,
                             w2c, K, settings,
                             center2d_offset=center2d_offset)
    return sur.center2d, sur.ext, sur.depth, sur.valid, sur.cull


@torch.no_grad()
def bin_slab_from_inputs(inputs, row0: int, width: int, slab_h: int,
                         duplicate_capacity: int,
                         max_tiles_per_surfel: int = 256):
    """Slab binning from full-frame ``bin_inputs_for_camera`` outputs.

    The slab camera is the full camera with ``cy -= row0`` (an exact crop),
    which acts linearly on every input: ``center2d``'s y moves by −row0;
    ``ext`` is invariant; the cull table's constant term becomes
    A + row0·C (k(p) = A + px·B + py·C with py → py − row0), and B, C,
    ρ_max and d²max are invariant; ``valid`` is the full frame's validity
    and the slab's on-screen test."""
    c2d, ext, depth, valid, cull = inputs
    r0 = torch.tensor(float(row0), dtype=torch.float32, device=c2d.device)
    c2d_s = c2d - torch.stack([torch.zeros_like(r0), r0])
    cull_s = cull.clone()
    cull_s[:, 0:3] = cull[:, 0:3] + r0 * cull[:, 6:9]
    on_s = ((c2d_s[:, 0] + ext[:, 0] > 0)
            & (c2d_s[:, 0] - ext[:, 0] < width)
            & (c2d_s[:, 1] + ext[:, 1] > 0)
            & (c2d_s[:, 1] - ext[:, 1] < slab_h))
    return bin_surfels_stream(c2d_s, ext, depth, valid & on_s, width, slab_h,
                              TILE_W, TILE_H, duplicate_capacity,
                              max_tiles_per_surfel, cull=cull_s)


def shift_packT(packT, row0: int):
    """Re-express full-camera packed records [rec, N(+1)] for a row-slab
    crop. The slab camera differs from the full camera only by the
    principal point ``cy -= row0``, which acts linearly on the records:
    the y-components of M's stored columns (rows 1, 4) lose row0 × their
    z-components (rows 2, 5), and the projected center's y (row 7) moves
    by −row0; depth, opacity, color, normal and the payload do not depend
    on K. Differentiable (a linear map). A zero padding column stays
    non-contributing (its opacity row is 0)."""
    r0 = float(row0)
    out = packT.clone()
    out[1] = packT[1] - r0 * packT[2]
    out[4] = packT[4] - r0 * packT[5]
    out[7] = packT[7] - r0
    return out


def encode_extra(extra_payload, class_gates):
    """Fold ``class_gates`` [N, G] bool into one exact-float bitmask column
    appended after ``extra_payload``. Returns (pack_extra, n_gates)."""
    if class_gates is None:
        return extra_payload, 0
    n_gates = class_gates.shape[1]
    powers = 2.0 ** torch.arange(n_gates, dtype=torch.float32,
                                 device=class_gates.device)
    grow = torch.sum(class_gates.to(torch.float32) * powers, dim=1,
                     keepdim=True)
    return (grow if extra_payload is None
            else torch.cat([extra_payload, grow], dim=1)), n_gates


def rasterize_stream(recT, radii, settings: RasterizeSettings, binning,
                     bg=None, nq: int = NQ, gates_n: int = 0) -> RenderOutput:
    """Blend + image assembly over an already-gathered record stream
    ``recT`` [rec, cap] (``_gather_records(packT, binning.sorted_surfel)``).
    With ``gates_n`` > 0 the records carry the class bitmask in row
    Q_ROW0 + nq (``encode_extra``) and ``class_dist`` [H, W, G] holds each
    class's gated distortion.
    """
    acc, _ = blend_stream(recT, binning.tile_offsets, binning.tiles_x,
                          binning.tiles_y, settings, nq, gates_n,
                          binning.tile_order)
    with trace.span("raster.finalize"):
        return _assemble(acc, radii, settings, binning, bg, nq, gates_n)


def _assemble(acc, radii, settings: RasterizeSettings, binning, bg, nq: int,
              gates_n: int) -> RenderOutput:
    """The blend's accumulators [T, PIX, ch] → a ``RenderOutput``."""
    ch = ch_for(nq)
    ch_tot = ch + 4 * gates_n

    # [T, PIX, ch_tot] → [ch_tot, H, W]
    h, w_img = settings.height, settings.width
    img = acc.reshape(binning.tiles_y, binning.tiles_x, TILE_H, TILE_W,
                      ch_tot)
    img = img.permute(4, 0, 2, 1, 3).reshape(
        ch_tot, binning.tiles_y * TILE_H, binning.tiles_x * TILE_W)
    img = img[:, :h, :w_img]

    class_dist = None
    if gates_n:
        # per class (α_g, m1_g, m2_g, lk_g) after the main channels; each
        # distortion telescopes like the main one below
        al, m1g, m2g = img[ch::4], img[ch + 1::4], img[ch + 2::4]
        class_dist = (al * m2g - m1g * m1g).permute(1, 2, 0)

    color = img[0:3].permute(1, 2, 0)
    alpha = img[nq]
    if bg is not None:
        color = color + (1.0 - alpha)[..., None] * bg

    # depth distortion via the symmetric-pair identity: the ordered
    # pairwise sum Σ_{j<i} w_i w_j (m_i−m_j)² telescopes to α·M2 − M1²
    m1 = img[nq + 3]
    m2 = img[nq + 4]
    return RenderOutput(
        color=color,
        alpha=alpha,
        expected_depth=img[nq + 1],
        normal=img[3:6].permute(1, 2, 0),
        median_depth=img[nq + 5].detach(),
        distortion=alpha * m2 - m1 * m1,
        radii=radii,
        overflow=binning.overflow,
        demand=binning.demand,
        extra=None if nq == NQ else img[6:nq].permute(1, 2, 0),
        class_dist=class_dist,
    )


def rasterize(means3d, scales, quats, opacities, colors, w2c, K,
              settings: RasterizeSettings, bg=None,
              max_tiles_per_surfel: int = 256,
              duplicate_capacity: int | None = None,
              center2d_offset=None, extra_payload=None, class_gates=None,
              binning=None) -> RenderOutput:
    """Differentiable tiled 2DGS render on the device of the inputs.

    Same semantics as ``rasterize_oracle``; activated scales/opacities,
    ``colors`` [N, 3]. ``extra_payload`` [N, E] blends E more per-surfel
    channels with the same weights in the same pass (``out.extra``).
    ``binning``: a precomputed ``StreamBinning`` from ``bin_for_camera``;
    its own capacity rules. ``class_gates`` [N, G] bool runs G gated
    per-class distortion chains in the same blend (``out.class_dist``
    [H, W, G]: each class's distortion as if only its surfels rendered).

    While tracing (``streetunveiler_torch.trace``) it counts the stream
    that K1, K2, the gather and the scatter process: ``raster.slots`` (its
    capacity) and ``raster.duplicates`` (min(demand, capacity)).
    """
    n = means3d.shape[0]
    c = colors.shape[-1]
    if c != 3:
        raise ValueError(
            f"the blend is templated for 3 color channels, got {c}; render "
            "multi-channel payloads in triples or as extra_payload")
    if binning is not None:
        cap = binning.sorted_surfel.shape[0]
        if duplicate_capacity is not None and duplicate_capacity != cap:
            raise ValueError(f"binning built with duplicate_capacity={cap}, "
                             f"rasterize called with {duplicate_capacity}")
    elif duplicate_capacity is None:
        duplicate_capacity = default_duplicate_capacity(
            n, settings.width, settings.height)

    with trace.span("raster.preprocess"):
        sur = preprocess_surfels(means3d, scales, quats, opacities, colors,
                                 w2c, K, settings,
                                 center2d_offset=center2d_offset)
        nq = NQ + (0 if extra_payload is None else extra_payload.shape[1])
        pack_extra, gates_n = encode_extra(extra_payload, class_gates)
    if binning is None:
        binning = bin_surfels_stream(
            sur.center2d.detach(), sur.ext, sur.depth.detach(), sur.valid,
            settings.width, settings.height, TILE_W, TILE_H,
            duplicate_capacity, max_tiles_per_surfel, cull=sur.cull)
    if trace.enabled():
        cap = binning.sorted_surfel.shape[0]
        trace.count("raster.slots", cap)
        trace.count("raster.duplicates", torch.clamp(binning.demand,
                                                     max=cap))
    with trace.span("raster.gather"):
        recT = _gather_records(pack_geometry_T(sur, n, pack_extra),
                               binning.sorted_surfel)
    return rasterize_stream(recT, sur.radius, settings, binning, bg=bg,
                            nq=nq, gates_n=gates_n)
