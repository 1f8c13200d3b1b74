"""Untiled plain-torch 2DGS renderer — the correctness oracle, forward
and, through autograd, backward (counterpart of
``streetunveiler_tpu/ops/rasterizer/oracle.py``).

Every surfel against every pixel block, depth-sorted globally and scanned
front to back in chunks with a carried transmittance. It knows nothing of
tiles or duplicate streams, so the tiled path (binning + blend kernel) is
held to it. The distortion is the ordered pairwise sum itself, not the
telescoped α·m2 − m1² of the tiled path.
"""

from __future__ import annotations

import torch

from .blendmath import chunk_weights, map_depth, pair_alpha_depth
from .preprocess import preprocess_surfels
from .types import MEDIAN_T, RasterizeSettings, RenderOutput


def _blend_block(px, py, sur, settings, chunk_surfels):
    """Composite all (depth-sorted, padded) surfels over one pixel block
    px, py [P]; returns the per-pixel accumulators."""
    n = sur.depth.shape[0]
    p = px.shape[0]
    dev = px.device
    c = sur.color.shape[-1]
    m_rows_all = tuple(sur.M[:, i, j] for i in range(3) for j in range(3))

    t_carry = torch.ones(p, device=dev)
    done = torch.zeros(p, dtype=torch.bool, device=dev)
    color = torch.zeros((p, c), device=dev)
    normal_a = torch.zeros((p, 3), device=dev)
    depth_a, dist, a_sum, m1, m2, med = (torch.zeros(p, device=dev)
                                         for _ in range(6))
    for start in range(0, n, chunk_surfels):
        sl = slice(start, start + chunk_surfels)
        alpha, t = pair_alpha_depth(
            tuple(m[sl] for m in m_rows_all),
            (sur.center2d[sl, 0], sur.center2d[sl, 1]), sur.depth[sl],
            sur.opacity[sl], sur.valid[sl], px, py, settings.znear)
        w, t_excl, t_carry, done = chunk_weights(alpha, t_carry, done,
                                                 t_eps=settings.t_eps)
        color = color + (w[:, :, None] * sur.color[sl, None, :]).sum(0)
        normal_a = normal_a + (w[:, :, None] * sur.normal[sl, None, :]).sum(0)
        depth_a = depth_a + torch.sum(w * t, dim=0)

        m = map_depth(t, settings.znear, settings.zfar)
        wm = w * m
        wm2 = wm * m
        a_excl = a_sum[None, :] + torch.cumsum(w, dim=0) - w
        m1_excl = m1[None, :] + torch.cumsum(wm, dim=0) - wm
        m2_excl = m2[None, :] + torch.cumsum(wm2, dim=0) - wm2
        dist = dist + torch.sum(
            w * (m * m * a_excl + m2_excl - 2.0 * m * m1_excl), dim=0)
        a_sum = a_sum + torch.sum(w, dim=0)
        m1 = m1 + torch.sum(wm, dim=0)
        m2 = m2 + torch.sum(wm2, dim=0)

        # median depth: last composited surfel whose incoming T > 0.5
        cand = (w > 0.0) & (t_excl > MEDIAN_T)
        idx = torch.arange(w.shape[0], device=dev)[:, None].expand_as(w)
        best = torch.max(torch.where(cand, idx, torch.full_like(idx, -1)),
                         dim=0).values
        t_best = torch.gather(t, 0, torch.clamp(best, min=0)[None, :])[0]
        med = torch.where(best >= 0, t_best.detach(), med)
    return t_carry, color, depth_a, normal_a, dist, a_sum, med


def rasterize_oracle(means3d, scales, quats, opacities, colors, w2c, K,
                     settings: RasterizeSettings, bg=None,
                     chunk_surfels: int = 256, pixel_block: int = 4096,
                     center2d_offset=None) -> RenderOutput:
    """Render; ``scales``/``opacities`` pre-activated, ``colors`` [N, C],
    ``bg`` [C] composited behind the splats. Differentiable (the median
    depth under stop-gradient, as in the tiled path)."""
    h, w_img = settings.height, settings.width
    dev = means3d.device
    sur = preprocess_surfels(means3d, scales, quats, opacities, colors,
                             w2c, K, settings,
                             center2d_offset=center2d_offset)

    # global front-to-back order by center view depth
    n = sur.depth.shape[0]
    key = torch.where(sur.valid, sur.depth,
                      torch.full_like(sur.depth, float("inf")))
    order = torch.argsort(key, stable=True)
    srt = sur._make(x[order] for x in sur)
    pad = (-n) % chunk_surfels
    if pad:
        srt = sur._make(
            torch.cat([x, torch.zeros((pad,) + x.shape[1:], dtype=x.dtype,
                                      device=dev)]) for x in srt)

    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(w_img, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    outs = [_blend_block(px[s:s + pixel_block], py[s:s + pixel_block], srt,
                         settings, chunk_surfels)
            for s in range(0, h * w_img, pixel_block)]
    t_f, color, depth_a, normal_a, dist, a_sum, med = (
        torch.cat(parts, dim=0) for parts in zip(*outs))

    if bg is not None:
        color = color + t_f[:, None] * bg[None, :]
    c = colors.shape[-1]
    return RenderOutput(
        color=color.reshape(h, w_img, c),
        alpha=a_sum.reshape(h, w_img),
        expected_depth=depth_a.reshape(h, w_img),
        normal=normal_a.reshape(h, w_img, 3),
        median_depth=med.reshape(h, w_img),
        distortion=dist.reshape(h, w_img),
        radii=sur.radius,
    )
