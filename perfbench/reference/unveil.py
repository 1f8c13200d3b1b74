"""The plain delta re-optimization of the unveil stage (stage C) that the
benchmark's unveil cells judge the program by: the frozen base plus the
masked deltas, the stage-C loss and one delta step with Adam, in plain
PyTorch and float32: each step runs with TF32 off, unless the control
asks for it through ``model.mode(tf32=True)``. It imports nothing of the
program and no kernel: the render is ``model.render`` on ``raster.py``'s
plain rasterizer.

The equations (StreetUnveiler, arXiv:2405.18416, stage 3; its
``MaskGaussianModel`` and ``3_reoptimization/1_optimization.py:212-277``):

    θ_eff = detach(θ_base) + δ · m          (m: 1 on the trainable rows)
    loss  = L1(render(θ_eff) + sky·(1 − α), target)
            + λ_dist · mean(distortion) + λ_normal · mean(1 − n_rend·n_surf)

and an Adam step on δ alone, with ``model.make_lrs``' per-leaf rates on
the re-optimization's options (its xyz schedule over 1,000 steps, scaling
rate 5e-3).

Departures from that description, each shared with the program:

* the supervision is one image, the inpainted image inside the removal
  mask and the ground truth outside it, under one L1; the description
  sums a masked L1 against the inpaint and an unmasked one against the
  ground truth;
* no densification or pruning runs during the re-optimization (the
  description's options define a schedule, 200 → 1,500 every 200, that its
  loop never calls);
* the sky is an image per frame, rendered once from the stage-1 sky and
  composited behind the surfels; nothing of it trains with the deltas;
* the base's removed rows stay in the arrays as dead rows (opacity 0)
  instead of being cut out, so the deltas keep the state's row count.

Planted faults for the cells' controls (``fault``): ``mask_ignored``
(every alive row trains) and ``unchanged`` (the step returns the deltas
and moments it was given); ``model.mode(half_batch=True)`` takes the L1
over the image's upper half.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from . import model
from .model import AdamState, SurfelParams, SurfelState

PARAMS = tuple(f.name for f in dataclasses.fields(SurfelParams))


@dataclasses.dataclass
class Fault:
    mask_ignored: bool = False
    unchanged: bool = False


FAULT = Fault()


@contextlib.contextmanager
def fault(mask_ignored: bool = False, unchanged: bool = False):
    """Plant the faults named inside the block."""
    old = (FAULT.mask_ignored, FAULT.unchanged)
    FAULT.mask_ignored, FAULT.unchanged = mask_ignored, unchanged
    try:
        yield
    finally:
        FAULT.mask_ignored, FAULT.unchanged = old


@contextlib.contextmanager
def _precision():
    """TF32 off for matrix products and convolutions inside the block,
    unless ``model.mode`` computes the control."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = model.MODE.tf32
    torch.backends.cudnn.allow_tf32 = model.MODE.tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def zero_deltas(params: SurfelParams) -> SurfelParams:
    return SurfelParams(**{n: torch.zeros_like(getattr(params, n))
                           for n in PARAMS})


def prune(state: SurfelState, removed) -> SurfelState:
    """The base: the rows of ``removed`` dead."""
    return dataclasses.replace(state, alive=state.alive & ~removed)


def apply_deltas(base: SurfelState, deltas: SurfelParams,
                 train_mask) -> SurfelState:
    """θ_base (detached) + δ·m on every parameter leaf."""
    m = train_mask.to(torch.float32)

    def mix(name):
        b = getattr(base.params, name).detach()
        return b + getattr(deltas, name) * m.reshape(
            (-1,) + (1,) * (b.dim() - 1))
    return dataclasses.replace(base, params=SurfelParams(
        **{n: mix(n) for n in PARAMS}))


def reoptimize_loss(base: SurfelState, deltas: SurfelParams, train_mask,
                    camera, target, bg, opt, sky_image=None,
                    duplicate_capacity=None):
    """The stage-C loss of the effective state against ``target``
    [H, W, 3]. Returns (loss, render result)."""
    st = apply_deltas(base, deltas, train_mask)
    res = model.render(camera, st, bg, duplicate_capacity=duplicate_capacity,
                       device=base.device)
    image = res.render
    if sky_image is not None:
        image = image + sky_image * (1.0 - res.rend_alpha)[..., None]
    rows = image.shape[0] // 2 if model.MODE.half_batch else image.shape[0]
    loss = model.l1_loss(image[:rows], target[:rows])
    loss = loss + opt.lambda_dist * torch.mean(res.rend_dist)
    normal_err = 1.0 - torch.sum(res.rend_normal * res.surf_normal, dim=-1)
    loss = loss + opt.lambda_normal * torch.mean(normal_err)
    return loss, res


def reoptimize_step(base: SurfelState, deltas: SurfelParams,
                    opt_state: AdamState, train_mask, camera, target, bg,
                    iteration: int, opt, sky_image=None,
                    duplicate_capacity=None):
    """One delta step: the loss's gradient on the deltas, then Adam with
    ``model.make_lrs(opt, iteration, ·)`` (the deltas and moments updated
    in place). Returns (deltas, opt_state, loss, overflow)."""
    mask = base.alive if FAULT.mask_ignored else train_mask
    leaves = {n: getattr(deltas, n).detach().requires_grad_(True)
              for n in PARAMS}
    with _precision():
        loss, res = reoptimize_loss(base, SurfelParams(**leaves), mask,
                                    camera, target, bg, opt, sky_image,
                                    duplicate_capacity)
        grads = torch.autograd.grad(loss, [leaves[n] for n in PARAMS])
    if not FAULT.unchanged:
        lrs = model.make_lrs(opt, iteration, base.spatial_scale)
        deltas, opt_state = model.adam_update(
            SurfelParams(**dict(zip(PARAMS, grads))), opt_state, deltas,
            lrs)
    return deltas, opt_state, loss.detach(), bool(res.overflow)
