"""Per-leaf-LR Adam over ``SurfelParams`` (counterpart of
``streetunveiler_tpu/train/optim.py``).

Functional in layout, like the JAX package's: the moments are
``SurfelParams`` of tensors shaped like the parameters, so densification's
row surgery on them (``models/gaussians.py``) uses the same index maps as
on the parameters. ``torch.optim.Adam`` is not used: it keeps per-tensor
state keyed by tensor identity, which the row surgery would have to
rebuild, and its default eps is 1e-8 where the surfels take 1e-15.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..models.gaussians import SurfelParams


class AdamState(NamedTuple):
    step: int                # updates taken so far (host counter)
    mu: SurfelParams         # first moments
    nu: SurfelParams         # second moments

    def to(self, device) -> "AdamState":
        return AdamState(step=self.step, mu=self.mu.to(device),
                         nu=self.nu.to(device))


def adam_init(params: SurfelParams) -> AdamState:
    z = {f.name: torch.zeros_like(getattr(params, f.name))
         for f in dataclasses.fields(params)}
    return AdamState(step=0, mu=SurfelParams(**z),
                     nu=SurfelParams(**{k: torch.zeros_like(v)
                                        for k, v in z.items()}))


@torch.no_grad()
def adam_update(grads: SurfelParams, state: AdamState, params: SurfelParams,
                lrs: SurfelParams, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-15):
    """One Adam step with one learning rate per leaf (``lrs``: floats or
    0-d tensors, e.g. the scheduled xyz rate on the device).

    Updates IN PLACE, under ``torch.no_grad()``: the tensors of ``params``
    and of the moments ``state.mu``/``state.nu`` are overwritten, and the
    same objects come back as (params, AdamState(step + 1, mu, nu)). This
    saves a copy of every parameter and moment per step; callers that need
    the old values clone them first."""
    step = state.step + 1
    # bias corrections in float32, as the JAX package evaluates them: in
    # the first steps 1 − b2^t cancels, and the rounding of the power moves
    # the update by ~1e-5 relative
    f32 = np.float32
    bc1 = float(f32(1.0) - f32(b1) ** f32(step))
    bc2 = float(f32(1.0) - f32(b2) ** f32(step))
    for f in dataclasses.fields(params):
        p = getattr(params, f.name)
        g = getattr(grads, f.name)
        m = getattr(state.mu, f.name)
        v = getattr(state.nu, f.name)
        lr = getattr(lrs, f.name)
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p.sub_(upd * lr)
    return params, AdamState(step=step, mu=state.mu, nu=state.nu)
