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
    to run."""
    return packT.index_select(1, idx).contiguous()


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

    sur = preprocess_surfels(means3d, scales, quats, opacities, colors,
                             w2c, K, settings, center2d_offset=center2d_offset)
    nq = NQ + (0 if extra_payload is None else extra_payload.shape[1])
    pack_extra, gates_n = encode_extra(extra_payload, class_gates)
    if binning is None:
        binning = bin_surfels_stream(
            sur.center2d.detach(), sur.ext, sur.depth.detach(), sur.valid,
            settings.width, settings.height, TILE_W, TILE_H,
            duplicate_capacity, max_tiles_per_surfel, cull=sur.cull)
    recT = _gather_records(pack_geometry_T(sur, n, pack_extra),
                           binning.sorted_surfel)
    return rasterize_stream(recT, sur.radius, settings, binning, bg=bg,
                            nq=nq, gates_n=gates_n)
