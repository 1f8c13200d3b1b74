"""Unveil stage B — inpainting conditions (counterpart of
``streetunveiler_tpu/pipeline/masks.py``; the reference's
``2_generate_inpainted_mask.py``).

1. The removal set grows to nearby surfels by their mean 3-NN distance to
   the removed cloud: trainable < 4e-2, editable < 2e-2.
2. Per frame: the removal mask is |α_full − α_without| > 0.01 dilated by a
   5-pixel square, beside the background-only renders that condition the
   inpainter.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.gaussians import SurfelState
from ..ops.knn import mean_dist_to_reference
from ..renderer import render

TRAINABLE_DIST = 4e-2
EDITABLE_DIST = 2e-2
ALPHA_DIFF_THRESH = 0.01
DILATE_PX = 5


class RemovalMasks(NamedTuple):
    removed: np.ndarray     # [C] the selected instance surfels
    editable: np.ndarray    # [C] removed + close neighbours (tight)
    trainable: np.ndarray   # [C] removed + wider neighbourhood


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def include_neighbor_pcd(state: SurfelState, removed_mask,
                         editable_dist: float = EDITABLE_DIST,
                         trainable_dist: float = TRAINABLE_DIST
                         ) -> RemovalMasks:
    """The editable and trainable neighbourhoods of the removed surfels,
    from every surfel's mean distance to the removed sub-cloud (the
    reference's ``include_neighbor_pcd``), on the host. The default radii
    are the reference's, in its normalized scene units; the unveil CLI
    sets them with ``--editable_dist`` and ``--trainable_dist`` for a
    scene in other units (the JAX package has the defaults only)."""
    alive = _host(state.alive)
    removed = _host(removed_mask).astype(bool) & alive
    xyz = _host(state.params.xyz)
    ref = xyz[removed]
    if ref.shape[0] == 0:
        z = np.zeros_like(removed)
        return RemovalMasks(removed, z.copy(), z.copy())
    d = mean_dist_to_reference(xyz, ref)
    return RemovalMasks(
        removed=removed,
        editable=((d < editable_dist) | removed) & alive,
        trainable=((d < trainable_dist) | removed) & alive)


def dilate(mask, radius: int = DILATE_PX):
    """Binary dilation of an [H, W] bool tensor by a (2r+1)² square
    (max pooling, the image's border padded as empty)."""
    k = 2 * radius + 1
    m = mask.to(torch.float32)[None, None]
    return F.max_pool2d(m, k, stride=1, padding=radius)[0, 0] > 0.5


@torch.no_grad()
def removal_mask_for_frame(camera, state: SurfelState, removed_mask, bg,
                           dilate_px: int = DILATE_PX, device="cuda",
                           **render_kwargs):
    """Per-frame removal mask and background-only render (the inpaint
    conditions), tensors on ``device``: dict(mask [H, W] bool, and the
    rgb/depth/normal/alpha without the instance, the full render's alpha
    and rgb)."""
    keep = ~torch.as_tensor(removed_mask, device=device).bool()
    full = render(camera, state, bg, device=device, **render_kwargs)
    wo = render(camera, state, bg, opacity_mask=keep, device=device,
                **render_kwargs)
    diff = torch.abs(full.rend_alpha - wo.rend_alpha) > ALPHA_DIFF_THRESH
    return dict(mask=dilate(diff, dilate_px),
                rgb_without=wo.render,
                depth_without=wo.surf_depth,
                normal_without=wo.rend_normal,
                alpha_without=wo.rend_alpha,
                alpha_full=full.rend_alpha,
                rgb_full=full.render)


def _save_png(path, arr):
    from PIL import Image
    a = np.asarray(arr)
    if a.dtype != np.uint8:
        a = (np.clip(a.astype(np.float32), 0, 1) * 255).astype(np.uint8)
    Image.fromarray(a).save(path)


def write_inpaint_conditions(scene, state: SurfelState, removed_mask,
                             workspace: str, bg, sky_images=None,
                             frames=None, duplicate_capacity=None,
                             device="cuda"):
    """Write the per-frame stage-B artifacts in the reference's layout:
    ``mask_inpaint/{f:05d}.png|.npy`` (the dilated α-difference mask),
    ``inpainted_rgb/`` (the background-only render, the inpaint
    condition), ``inpainted_depth/`` (clamped disparity),
    ``inpainted_normal/`` (0.5·n + 0.5), ``original_rgb/`` and
    ``empty_opacity/`` (α − α_without), and ``valid_inpaint_frame.npy``.
    ``sky_images`` [H, W, 3] per frame are composited with the full
    render's α into both RGB images. Returns {frame: mask [H, W] bool}.

    These directories are the filesystem half of the out-of-band inpainter
    contract: a host running the real inpainting models reads them as the
    reference's stage C does."""
    dirs = {k: os.path.join(workspace, k)
            for k in ("mask_inpaint", "inpainted_rgb", "inpainted_depth",
                      "inpainted_normal", "original_rgb", "empty_opacity")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    frames = list(range(len(scene.train_cameras))) if frames is None \
        else list(frames)
    out_masks = {}
    for f in frames:
        cond = {k: _host(v) for k, v in removal_mask_for_frame(
            scene.train_cameras[f], state, removed_mask, bg,
            duplicate_capacity=duplicate_capacity, device=device).items()}
        rgb_full, rgb_wo = cond["rgb_full"], cond["rgb_without"]
        if sky_images is not None:
            sky = _host(sky_images[f])
            a = cond["alpha_full"][..., None]
            rgb_full = rgb_full + sky * (1.0 - a)
            rgb_wo = rgb_wo + sky * (1.0 - a)
        mask = cond["mask"].astype(bool)
        out_masks[f] = mask
        _save_png(os.path.join(dirs["mask_inpaint"], f"{f:05d}.png"),
                  mask.astype(np.uint8) * 255)
        np.save(os.path.join(dirs["mask_inpaint"], f"{f:05d}.npy"), mask)
        _save_png(os.path.join(dirs["original_rgb"], f"{f:05d}.png"),
                  rgb_full)
        _save_png(os.path.join(dirs["inpainted_rgb"], f"{f:05d}.png"),
                  rgb_wo)
        disp = 1.0 / np.maximum(cond["depth_without"], 1e-6)
        disp[~np.isfinite(disp)] = 0.0
        _save_png(os.path.join(dirs["inpainted_depth"], f"{f:05d}.png"),
                  np.repeat(np.clip(disp, 0, 1)[..., None], 3, -1))
        _save_png(os.path.join(dirs["inpainted_normal"], f"{f:05d}.png"),
                  cond["normal_without"] * 0.5 + 0.5)
        _save_png(os.path.join(dirs["empty_opacity"], f"{f:05d}.png"),
                  np.abs(cond["alpha_full"] - cond["alpha_without"]))
    np.save(os.path.join(workspace, "valid_inpaint_frame.npy"),
            np.asarray(frames))
    return out_masks
