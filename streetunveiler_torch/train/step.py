"""The stage-1 training step (counterpart of ``streetunveiler_tpu/train/
step.py``): render + losses + backward + Adam update (surfels and the
jointly trained sky) + densification statistics, eagerly, one call per
step.

The backward runs kernel K2 (the blend backward), the record-grad
scatter, then autograd through the preprocess and the SH decode. The
screen-space gradient that densification reads is the gradient of an
all-zero ``center2d_offset`` [C, 2] leaf, as in the JAX package.
Iteration-dependent loss weights (normal consistency, distortion, shrink,
SH warm-up, the xyz learning-rate decay) are host-side gates here: the
step number is known on the host, and a term whose weight is zero is not
computed.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..config import OptimizationParams
from ..device import resolve_device
from ..models.gaussians import (SurfelParams, SurfelState,
                                add_densification_stats)
from ..models.sky import SkyParams, render_sky
from ..renderer import bin_camera, render, semantic_class_mask
from ..scene.cameras import Camera
from ..utils.semantics import CONCERNED_IND, NUM_CONCERNED
from .losses import l1_loss, psnr, ssim
from .optim import AdamState, adam_init, adam_update
from .schedule import expon_lr

SEMANTIC_CLASS_WEIGHTS = (1.0, 1.0, 1.0, 1.0, 0.2, 1.0)  # sky down-weighted
SKY_LR = 1e-4            # the sky's own Adam: lr 1e-4, eps 1e-8
SKY_EPS = 1e-8
# the gated per-class distortion's classes: every concerned class but sky,
# in class order (road, sidewalk, building, vegetation, vehicle)
DIST_CLASSES = tuple(ci for ci in range(len(SEMANTIC_CLASS_WEIGHTS))
                     if ci != CONCERNED_IND["sky"])


def make_lrs(opt: OptimizationParams, iteration: int,
             spatial_scale) -> SurfelParams:
    """Per-parameter learning rates; the xyz rate follows the exponential
    schedule scaled by the scene extent (``spatial_scale``, a float or a
    0-d tensor — a tensor keeps the step free of host synchronisation)."""
    xyz_lr = expon_lr(iteration, opt.position_lr_init,
                      opt.position_lr_final,
                      lr_delay_mult=opt.position_lr_delay_mult,
                      max_steps=opt.position_lr_max_steps) * spatial_scale
    return SurfelParams(
        xyz=xyz_lr,
        features_dc=opt.feature_lr,
        features_rest=opt.feature_lr / 20.0,
        scaling=opt.scaling_lr,
        rotation=opt.rotation_lr,
        opacity=opt.opacity_lr)


def semantic_ce_loss(probs, gt_labels, weights=SEMANTIC_CLASS_WEIGHTS):
    """Class-weighted cross entropy that treats the composited class
    probabilities [H, W, C] as logits (the reference feeds them straight
    into ``F.cross_entropy``)."""
    logp = F.log_softmax(probs, dim=-1)
    onehot = F.one_hot(gt_labels.long(), probs.shape[-1]).to(probs.dtype)
    w = torch.as_tensor(weights, dtype=probs.dtype, device=probs.device)
    return -torch.mean(torch.sum(w * onehot * logp, dim=-1))


def stage1_loss(state: SurfelState, camera: Camera, gt_image, bg,
                iteration: int, opt: OptimizationParams, sky_params=None,
                sky_image=None, gt_semantic=None, class_dist: bool = False,
                center2d_offset=None, duplicate_capacity=None, binning=None):
    """The full stage-1 loss on the state's device. Returns (loss, aux).

    ``gt_semantic`` [H, W] int class labels, with
    ``opt.enable_semantic_loss``, adds the semantic cross entropy: the
    one-hot classes ride the same blend as 6 extra payload channels
    (nq = 12). With ``class_dist`` as well (the late phase, past
    ``semantic_dist_from_iter``) the same blend runs one gated
    transmittance chain per class but sky (G = 5) and the loss adds
    λ_dist·Σ_g mean(class_dist_g). ``sky_params`` (a ``SkyParams``, trained
    jointly) or a precomputed ``sky_image`` [H, W, 3] composites behind
    the surfels: ``image = render + sky·(1 − α)``.
    """
    want_sem = gt_semantic is not None and opt.enable_semantic_loss
    active_sh = min(iteration // 1000, state.sh_degree)
    extra = (F.one_hot(state.semantics.long(), NUM_CONCERNED)
             .to(torch.float32) if want_sem else None)
    gates = None
    if want_sem and class_dist:
        gates = torch.stack([semantic_class_mask(state, 1 << ci, reverse=True)
                             for ci in DIST_CLASSES], dim=1)
    res = render(camera, state, bg, active_sh_degree=active_sh,
                 center2d_offset=center2d_offset,
                 duplicate_capacity=duplicate_capacity, extra_payload=extra,
                 class_gates=gates, binning=binning, device=state.device)

    image = res.render
    if sky_params is not None:
        sky_image = render_sky(sky_params, camera.height, camera.width,
                               camera.K, torch.linalg.inv(camera.w2c))
    if sky_image is not None:
        image = image + sky_image * (1.0 - res.rend_alpha)[..., None]
    ll1 = l1_loss(image, gt_image)
    lssim = ssim(image, gt_image)
    loss = (1.0 - opt.lambda_dssim) * ll1 + opt.lambda_dssim * (1.0 - lssim)

    if iteration > opt.normal_consist_from_iter:
        normal_error = 1.0 - torch.sum(res.rend_normal * res.surf_normal,
                                       dim=-1)
        loss = loss + opt.lambda_normal * torch.mean(normal_error)
    if iteration > opt.semantic_dist_from_iter:
        loss = loss + opt.lambda_dist * torch.mean(res.rend_dist)
    if iteration > opt.shrinking_from_iter:
        mean_op = torch.sum(state.get_opacity()) / torch.clamp(
            state.num_alive, min=1)
        loss = loss + opt.lambda_shrink * mean_op

    sem_loss = torch.zeros((), device=image.device)
    if want_sem:
        sky_prior = F.one_hot(torch.tensor(CONCERNED_IND["sky"]),
                              NUM_CONCERNED).to(torch.float32).to(
                                  image.device)
        probs = res.extra + sky_prior * (1.0 - res.rend_alpha)[..., None]
        sem_loss = semantic_ce_loss(probs, gt_semantic)
        loss = loss + opt.semantic_loss_ratio * sem_loss
        if gates is not None:
            loss = loss + opt.lambda_dist * torch.sum(
                torch.mean(res.class_dist, dim=(0, 1)))

    with torch.no_grad():
        aux = dict(image=image.detach(), l1=ll1.detach(),
                   ssim=lssim.detach(), radii=res.radii.detach(),
                   psnr=psnr(torch.clamp(image, 0.0, 1.0), gt_image),
                   semantic=sem_loss.detach(), overflow=res.overflow,
                   demand=res.demand)
    return loss, aux


def bin_step(state: SurfelState, camera: Camera,
             duplicate_capacity: int | None = None, device="cuda"):
    """The binning alone (gradient-free) for ``train_step(...,
    binning=...)``. Kept a separate call as in the JAX package; on the card
    the split costs nothing."""
    dev = resolve_device(device)
    return bin_camera(camera.to(dev), state.to(dev),
                      duplicate_capacity=duplicate_capacity)


def train_step(state: SurfelState, opt_state: AdamState, camera: Camera,
               gt_image, bg, iteration: int, opt: OptimizationParams,
               sky_params: SkyParams | None = None,
               sky_opt_state: AdamState | None = None, sky_image=None,
               gt_semantic=None, class_dist: bool = False,
               duplicate_capacity: int | None = None, binning=None,
               device="cuda"):
    """One optimisation step on ``device`` (default the card; it raises
    without one unless ``device="cpu"``): the surfels and, with
    ``sky_params``, the sky trained jointly by its own Adam (lr 1e-4,
    eps 1e-8; ``sky_opt_state`` defaults to fresh moments).

    Returns (state, opt_state, sky_params, sky_opt_state, metrics); the sky
    pair is None when no sky is trained. The parameter tensors of ``state``
    and ``sky_params`` and the moments of both Adam states are updated IN
    PLACE (``adam_update``); the densification statistics come back as new
    tensors in the new state. ``metrics`` holds 0-d tensors on the device
    (reading one waits for the step). ``binning``: a ``bin_step`` result
    for this state and camera.
    """
    dev = resolve_device(device)
    state = state.to(dev)
    opt_state = opt_state.to(dev)
    camera = camera.to(dev)
    gt_image = torch.as_tensor(gt_image, dtype=torch.float32, device=dev)
    if gt_semantic is not None:
        gt_semantic = torch.as_tensor(gt_semantic, device=dev)

    names = [f.name for f in dataclasses.fields(SurfelParams)]
    leaves = {n: getattr(state.params, n).detach().requires_grad_(True)
              for n in names}
    zeros2d = torch.zeros((state.capacity, 2), dtype=torch.float32,
                          device=dev, requires_grad=True)
    st = dataclasses.replace(state, params=SurfelParams(**leaves))
    sky_leaves = None
    if sky_params is not None:
        sky_params = sky_params.to(dev)
        sky_leaves = sky_params.map(
            lambda t: t.detach().requires_grad_(True))
        sky_opt_state = (adam_init(sky_params) if sky_opt_state is None
                         else sky_opt_state.to(dev))
    loss, aux = stage1_loss(st, camera, gt_image, bg, iteration, opt,
                            sky_params=sky_leaves, sky_image=sky_image,
                            gt_semantic=gt_semantic, class_dist=class_dist,
                            center2d_offset=zeros2d,
                            duplicate_capacity=duplicate_capacity,
                            binning=binning)
    inputs = [leaves[n] for n in names] + [zeros2d]
    if sky_leaves is not None:
        inputs += list(sky_leaves.named_tensors().values())
    grads = torch.autograd.grad(loss, inputs)
    screen_grads = grads[len(names)]

    lrs = make_lrs(opt, iteration, state.spatial_scale)
    params, opt_state = adam_update(
        SurfelParams(**dict(zip(names, grads[:len(names)]))), opt_state,
        state.params, lrs)
    state = dataclasses.replace(state, params=params)
    if sky_params is not None:
        it = iter(grads[len(names) + 1:])
        sky_grads = sky_params.map(lambda _: next(it))
        sky_params, sky_opt_state = adam_update(
            sky_grads, sky_opt_state, sky_params, SKY_LR, eps=SKY_EPS)

    # densification statistics, gated off after densify_until_iter
    track = iteration < opt.densify_until_iter
    visible = (aux["radii"] > 0) & track
    state = add_densification_stats(state, screen_grads, aux["radii"],
                                    visible)

    metrics = dict(loss=loss.detach(), l1=aux["l1"], ssim=aux["ssim"],
                   psnr=aux["psnr"], n_alive=state.num_alive,
                   semantic=aux["semantic"], overflow=aux["overflow"],
                   demand=aux["demand"])
    return state, opt_state, sky_params, sky_opt_state, metrics


def init_optimizer(state: SurfelState) -> AdamState:
    return adam_init(state.params)
