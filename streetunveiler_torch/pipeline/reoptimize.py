"""Unveil stage C — the delta re-optimization (counterpart of
``streetunveiler_tpu/pipeline/reoptimize.py``; the reference's
``3_reoptimization/1_optimization.py``).

Walks the key frames back to front in (key, previously processed key)
pairs. Each key frame is inpainted (the first by the primary inpainter,
later ones guided by the previous inpaint through the refill mask),
propagated forward to the frames between it and the previous key, and then
the masked deltas train for ``opt.iterations`` steps on random frames of
the accumulated candidate set, with masked L1 + distortion + normal
losses. The surfel state keeps its capacity; only the deltas train, each
step through the rasterizer's autograd path (K1 forward; K2 and the record
scatter backward). ``reoptimize_frames`` is that training loop over a
candidate set, resumable from where a call stopped.

While tracing (``trace.py``): ``unveil.step`` holds one delta step, in it
``unveil.deltas`` (``apply_deltas``; ``unveil.deltas_bwd`` its backward),
``unveil.loss`` (the loss after the render) and ``unveil.adam`` (the
deltas' Adam); ``unveil()`` opens ``unveil.condition`` (a frame's removal
mask and inpaint-input renders) and ``unveil.inpaint`` (the inpainter).
Each step counts ``unveil.trainable`` (the rows it trains) and
``unveil.surfels`` (the base's alive rows).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .. import trace
from ..config import ReOptimizationParams
from ..device import resolve_device
from ..models.deltas import apply_deltas, zero_deltas
from ..models.gaussians import SurfelParams, SurfelState, prune_mask
from ..renderer import render
from ..train.losses import l1_loss
from ..train.optim import adam_init, adam_update
from ..train.step import make_lrs
from .masks import dilate

REFILL_DIFF = 2e-2
_NAMES = tuple(f.name for f in dataclasses.fields(SurfelParams))


def reoptimize_loss(base: SurfelState, deltas: SurfelParams, train_mask,
                    camera, target, bg, opt: ReOptimizationParams,
                    sky_image=None, duplicate_capacity=None):
    """The stage-C loss of ``apply_deltas(base, deltas, train_mask)``
    against ``target`` [H, W, 3]: L1 + λ_dist·mean(distortion) +
    λ_normal·mean(1 − n_rend·n_surf), the sky composited behind the
    surfels. Returns (loss, image)."""
    with trace.span("unveil.deltas"):
        st = apply_deltas(base, deltas, train_mask)
    trace.backward_span("unveil.deltas_bwd", [getattr(st.params, n)
                                              for n in _NAMES])
    res = render(camera, st, bg, duplicate_capacity=duplicate_capacity,
                 device=base.device)
    with trace.span("unveil.loss"):
        image = res.render
        if sky_image is not None:
            image = image + sky_image * (1.0 - res.rend_alpha)[..., None]
        loss = l1_loss(image, target)
        loss = loss + opt.lambda_dist * torch.mean(res.rend_dist)
        normal_err = 1.0 - torch.sum(res.rend_normal * res.surf_normal,
                                     dim=-1)
        loss = loss + opt.lambda_normal * torch.mean(normal_err)
    return loss, image


def reoptimize_step(base: SurfelState, deltas: SurfelParams, opt_state,
                    train_mask, camera, target, bg, iteration: int,
                    opt: ReOptimizationParams, sky_image=None,
                    duplicate_capacity=None):
    """One delta step against an inpainted target, on the base's device.

    ``target`` [H, W, 3] is the pre-composited supervision: the inpainted
    image inside the removal mask, the ground truth outside (the
    reference's masked + unmasked L1 in one image). The gradient reaches
    the deltas through the rasterizer's backward; Adam (``make_lrs``'
    rates on ``opt``) updates the tensors of ``deltas`` and the moments of
    ``opt_state`` IN PLACE. Returns (deltas, opt_state, loss)."""
    with trace.span("unveil.step"):
        if trace.enabled():
            trace.count("unveil.trainable", torch.as_tensor(
                train_mask, device=base.device).sum())
            trace.count("unveil.surfels", base.alive.sum())
        leaves = {n: getattr(deltas, n).detach().requires_grad_(True)
                  for n in _NAMES}
        loss, _ = reoptimize_loss(base, SurfelParams(**leaves), train_mask,
                                  camera, target, bg, opt, sky_image,
                                  duplicate_capacity)
        grads = torch.autograd.grad(loss, [leaves[n] for n in _NAMES])
        with trace.span("unveil.adam"):
            lrs = make_lrs(opt, iteration, base.spatial_scale)
            deltas, opt_state = adam_update(
                SurfelParams(**dict(zip(_NAMES, grads))), opt_state, deltas,
                lrs)
    return deltas, opt_state, loss.detach()


def reoptimize_frames(base: SurfelState, deltas: SurfelParams, opt_state,
                      train_mask, cameras, targets, bg, candidates,
                      first_iteration: int, n_iterations: int,
                      opt: ReOptimizationParams, rng, order=(),
                      sky_images=None, duplicate_capacity=None):
    """Iterations ``first_iteration`` .. ``first_iteration + n_iterations
    - 1`` of the re-optimization over the frames ``candidates``: each
    takes the next frame of ``order`` and, once that is empty, of a new
    permutation of ``candidates`` from ``rng`` (a numpy ``Generator``),
    and makes one ``reoptimize_step`` against ``targets[frame]``
    (``cameras``, ``targets`` and ``sky_images`` are indexed by frame;
    ``deltas`` and ``opt_state`` are updated in place).

    Returns (deltas, opt_state, loss, order): the last step's loss (zero
    without a step) and the frames the last permutation has left, so that
    a call given them and the same ``rng`` continues exactly where this
    one stopped."""
    dev = base.device
    order = list(order)
    loss = torch.zeros((), device=dev)
    for it in range(first_iteration, first_iteration + n_iterations):
        if not order:
            order = list(rng.permutation(candidates))
        fid = int(order.pop())
        deltas, opt_state, loss = reoptimize_step(
            base, deltas, opt_state, train_mask, cameras[fid].to(dev),
            targets[fid], bg, it, opt,
            sky_image=None if sky_images is None else sky_images[fid],
            duplicate_capacity=duplicate_capacity)
    return deltas, opt_state, loss, order


def refill_mask(last_inframe_render, current_render, inpaint_mask):
    """The pixels earlier key frames do not constrain yet: channel-summed
    |last − current| > 2e-2 within the removal mask."""
    diff = torch.sum(torch.abs(last_inframe_render - current_render), dim=-1)
    return (diff > REFILL_DIFF) & inpaint_mask


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def unveil(scene, state: SurfelState, masks, key_frames: Sequence[int],
           inpainter, opt: ReOptimizationParams = ReOptimizationParams(),
           bg=None, sky_images=None, propagate: bool = True,
           duplicate_capacity=None, callback=None, frame_masks=None,
           seed: int = 0, device="cuda"):
    """The stage-C loop on ``device``. ``masks``: stage B's
    ``RemovalMasks``; ``frame_masks`` optionally maps frame → [H, W] bool
    removal masks from the stage-B artifacts (recomputed from the alpha
    difference when absent). Frames are drawn from
    ``np.random.default_rng(seed)`` permutations, as in the JAX package.
    Returns (unveiled_state, deltas, inpainted_targets)."""
    dev = resolve_device(device)
    state = state.to(dev)
    bg = torch.zeros(3, device=dev) if bg is None else torch.as_tensor(
        bg, dtype=torch.float32, device=dev)
    removed = torch.as_tensor(np.asarray(masks.removed, bool), device=dev)
    train_mask = torch.as_tensor(np.asarray(masks.trainable, bool),
                                 device=dev) & ~removed

    # the base: removed surfels pruned
    base = prune_mask(state, removed)
    deltas = zero_deltas(base.params)
    opt_state = adam_init(deltas)

    images = scene.train_images
    n_cams = len(scene.train_cameras)
    inpainted_targets: dict[int, np.ndarray] = {}
    targets_dev: dict[int, torch.Tensor] = {}
    last_inpaint = None
    rng = np.random.default_rng(seed)
    sky_dev = None if sky_images is None else [
        torch.as_tensor(s, dtype=torch.float32, device=dev)
        for s in sky_images]

    # the key list, sorted, with the last frame appended as a pure
    # propagation boundary (never inpainted itself)
    keys = sorted(set(key_frames))
    if not keys:
        with torch.no_grad():
            return apply_deltas(base, deltas, train_mask), deltas, {}
    if keys[-1] != n_cams - 1:
        keys.append(n_cams - 1)

    # editable narrowing: a surfel's neighbourhood is hidden from the
    # inpaint-input render only in the first (latest) key frame that sees
    # it, so later conditions keep the now-constrained geometry
    alive = _host(base.alive)
    editable_remaining = (np.asarray(masks.editable)
                          & ~np.asarray(masks.removed) & alive)
    candidates: list[int] = []

    for frame, last_frame in zip(reversed(keys[:-1]), reversed(keys[1:])):
        cam = scene.train_cameras[frame]
        gt = np.asarray(images[frame])
        in_frame = _host(scene.pcd_in_frame_mask(base.params.xyz,
                                                 frame)) & alive
        hide = in_frame & editable_remaining
        editable_remaining = editable_remaining & ~in_frame

        with trace.span("unveil.condition"):
            cond = _frame_condition(cam, state, base, bg,
                                    duplicate_capacity, hide_mask=hide)
        if frame_masks is not None and frame in frame_masks:
            mask = np.asarray(frame_masks[frame], bool)
        else:
            mask = _host(cond["mask"])
        rgb_without = _host(cond["rgb_without"])
        if last_inpaint is None:
            with trace.span("unveil.inpaint"):
                inp = inpainter.inpaint(rgb_without, mask)
        else:
            rm = _host(refill_mask(
                torch.as_tensor(last_inpaint, device=dev),
                cond["rgb_without"], torch.as_tensor(mask, device=dev)))
            with trace.span("unveil.inpaint"):
                inp = inpainter.inpaint(rgb_without, rm,
                                        reference=last_inpaint)
        last_inpaint = inp
        # supervision: inpainted inside the mask, the ground truth outside
        inpainted_targets[frame] = np.where(mask[..., None], inp,
                                            gt).astype(np.float32)

        # propagate forward to the frames between this key and the
        # previously processed one
        new_frames = [frame]
        if propagate:
            for mid in range(frame + 1, last_frame):
                if frame_masks is not None and mid in frame_masks:
                    mmask = np.asarray(frame_masks[mid], bool)
                else:
                    with trace.span("unveil.condition"):
                        mmask = _host(_frame_condition(
                            scene.train_cameras[mid], state, base, bg,
                            duplicate_capacity)["mask"])
                mimg = np.asarray(images[mid])
                with trace.span("unveil.inpaint"):
                    minp = inpainter.inpaint(mimg, mmask,
                                             reference=last_inpaint)
                inpainted_targets[mid] = np.where(
                    mmask[..., None], minp, mimg).astype(np.float32)
                new_frames.append(mid)
        for f in new_frames:
            targets_dev[f] = torch.as_tensor(inpainted_targets[f],
                                             device=dev)

        # re-optimization over the accumulated candidate set, frames in
        # random order without replacement
        candidates += new_frames
        deltas, opt_state, loss, _ = reoptimize_frames(
            base, deltas, opt_state, train_mask, scene.train_cameras,
            targets_dev, bg, candidates, 1, opt.iterations, opt, rng,
            sky_images=sky_dev, duplicate_capacity=duplicate_capacity)
        if callback:
            callback(frame, float(loss), inpainted_targets[frame])

    with torch.no_grad():
        final = apply_deltas(base, deltas, train_mask)
    return final, deltas, inpainted_targets


@torch.no_grad()
def _frame_condition(camera, full_state, base, bg, duplicate_capacity,
                     hide_mask=None):
    """Removal mask and inpaint-input render of one frame. ``hide_mask``
    [C] bool also hides the frame's editable neighbourhood from the input
    render, so that leftover floaters near the hole do not condition the
    inpainter."""
    dev = base.device
    full = render(camera, full_state, bg,
                  duplicate_capacity=duplicate_capacity, device=dev)
    wo = render(camera, base, bg, duplicate_capacity=duplicate_capacity,
                device=dev)
    diff = torch.abs(full.rend_alpha - wo.rend_alpha) > 0.01
    rgb_without = wo.render
    if hide_mask is not None:
        keep = ~torch.as_tensor(hide_mask, device=dev)
        rgb_without = render(camera, base, bg, opacity_mask=keep,
                             duplicate_capacity=duplicate_capacity,
                             device=dev).render
    return dict(mask=dilate(diff), rgb_without=rgb_without)
