"""Depth map → pseudo surface normal (counterpart of
``streetunveiler_tpu/ops/depth_normal.py``), in view space."""

from __future__ import annotations

import torch


def depth_to_points_view(depth, K):
    """depth [H,W] → view-space points [H,W,3]."""
    h, w = depth.shape
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=depth.device) + 0.5,
        torch.arange(w, dtype=torch.float32, device=depth.device) + 0.5,
        indexing="ij")
    x = (xs - cx) / fx
    y = (ys - cy) / fy
    return torch.stack([x * depth, y * depth, depth], dim=-1)


def depth_to_normal(depth, K):
    """depth [H,W] → unit normals [H,W,3] (zero on the 1px border)."""
    pts = depth_to_points_view(depth, K)
    d_horiz = pts[1:-1, 2:] - pts[1:-1, :-2]
    d_vert = pts[2:, 1:-1] - pts[:-2, 1:-1]
    # cross(vertical, horizontal): camera-facing (−z) for front-parallel
    # surfaces, matching the rasterizer's flipped surfel normals
    n = torch.linalg.cross(d_vert, d_horiz, dim=-1)
    n = n / torch.sqrt(torch.clamp(torch.sum(n * n, dim=-1, keepdim=True),
                                   min=1e-12))
    out = torch.zeros_like(pts)
    out[1:-1, 1:-1] = n
    return out
