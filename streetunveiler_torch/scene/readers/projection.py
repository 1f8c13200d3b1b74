"""Point-cloud to frame projection (counterpart of ``streetunveiler_tpu/
scene/readers/projection.py``, the reference's
``scene/dataset_readers/projection_utils.py``), on the card in float64 as
the JAX package's numpy runs it.

``cull_mask_in_frame``: which points a camera sees, and where.
``certain_semantic_mask``: a projected point's label is "certain" only if
the label map carries the same class ±10 px along both diagonals.
``colorize_points_from_frames``: a cloud's colours and labels from the
first frame that sees each point with a certain label. The world to view
product is written out as products and sums in a fixed order, with no
matrix multiply, so the card and the CPU give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device

CERTAIN_OFFSET = 10


def cull_mask_in_frame(points, w2c, K, width: int, height: int):
    """Returns (mask [N] bool, pix [N, 2], depth [N]), float64 tensors on
    the device of ``points`` ([N, 3], a tensor or an array)."""
    p = torch.as_tensor(points).to(torch.float64)
    w2c = np.asarray(w2c, np.float64)
    K = np.asarray(K, np.float64)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    v = [x * float(w2c[i, 0]) + y * float(w2c[i, 1]) + z * float(w2c[i, 2])
         + float(w2c[i, 3]) for i in range(3)]
    depth = v[2]
    zs = torch.clamp(depth, min=1e-8)
    px = v[0] / zs * float(K[0, 0]) + float(K[0, 2])
    py = v[1] / zs * float(K[1, 1]) + float(K[1, 2])
    mask = ((depth > 0.01) & (px >= 0) & (px < width) & (py >= 0)
            & (py < height))
    return mask, torch.stack([px, py], dim=1), depth


def certain_semantic_mask(pix, labels, semantic_map,
                          offset: int = CERTAIN_OFFSET):
    """pix [N, 2], labels [N] candidate classes, semantic_map [H, W], all
    tensors on one device. True where all four diagonal neighbours at
    ±offset carry the same class (the reference's
    ``getCertainSemanticMask``)."""
    h, w = semantic_map.shape
    x = pix[:, 0].to(torch.int64)
    y = pix[:, 1].to(torch.int64)
    ok = torch.ones(x.shape[0], dtype=torch.bool, device=pix.device)
    for dx, dy in [(offset, offset), (offset, -offset),
                   (-offset, offset), (-offset, -offset)]:
        xi = torch.clamp(x + dx, 0, w - 1)
        yi = torch.clamp(y + dy, 0, h - 1)
        ok &= semantic_map[yi, xi] == labels
    return ok


def colorize_points_from_frames(points, frames, device="cuda"):
    """Project a cloud into several frames on ``device``, picking up colour
    and semantics.

    ``points``: [N, 3] array; ``frames``: iterable of dicts with keys w2c,
    K, image [H, W, 3] float, semantic [H, W] int (optional), numpy; each
    frame's image and label map go to the device in turn. A point takes
    the colour and label of the first frame that sees it with a certain
    label (the reference's ``addWaymoLidarPointCloud``). Returns numpy
    (colors [N, 3] float32, semantics [N] int32, -1 where unseen, seen [N]
    bool).
    """
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(points), device=dev)
    n = pts.shape[0]
    colors = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    semantics = torch.full((n,), -1, dtype=torch.int32, device=dev)
    seen = torch.zeros(n, dtype=torch.bool, device=dev)
    for fr in frames:
        h, w = np.asarray(fr["image"]).shape[:2]
        mask, pix, _ = cull_mask_in_frame(pts, fr["w2c"], fr["K"], w, h)
        todo = mask & ~seen
        if not bool(todo.any()):
            continue
        img = torch.as_tensor(np.asarray(fr["image"], np.float32),
                              device=dev)
        pix = pix[todo]
        xi = torch.clamp(pix[:, 0].to(torch.int64), 0, w - 1)
        yi = torch.clamp(pix[:, 1].to(torch.int64), 0, h - 1)
        col = img[yi, xi]
        if fr.get("semantic") is not None:
            sem = torch.as_tensor(np.asarray(fr["semantic"]), device=dev)
            lab = sem[yi, xi].to(torch.int32)
            certain = certain_semantic_mask(pix, lab, sem)
        else:
            lab = torch.zeros(xi.shape[0], dtype=torch.int32, device=dev)
            certain = torch.ones(xi.shape[0], dtype=torch.bool, device=dev)
        idx = torch.nonzero(todo)[:, 0][certain]
        colors[idx] = col[certain]
        semantics[idx] = lab[certain]
        seen[idx] = True
    return colors.cpu().numpy(), semantics.cpu().numpy(), seen.cpu().numpy()
