"""Per-leaf-LR Adam over ``SurfelParams`` and the sky's ``SkyParams``
(counterpart of ``streetunveiler_tpu/train/optim.py``).

Functional in layout, like the JAX package's: the moments have the
parameters' structure (``SurfelParams`` or ``SkyParams`` of tensors shaped
like the parameters), so densification's row surgery on them
(``models/gaussians.py``) uses the same index maps as on the parameters.
``torch.optim.Adam`` is not used: it keeps per-tensor state keyed by
tensor identity, which the row surgery would have to rebuild. The surfels
take eps 1e-15 (the default here), the sky 1e-8.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..models.gaussians import SurfelParams
from ..models.sky import SkyParams


def tensor_leaves(tree) -> list:
    """The tensors of a ``SurfelParams`` or ``SkyParams``, in a fixed
    order (the JAX package's leaf order)."""
    if isinstance(tree, SkyParams):
        return list(tree.named_tensors().values())
    return [getattr(tree, f.name) for f in dataclasses.fields(tree)]


def _map(fn, tree):
    if isinstance(tree, SkyParams):
        return tree.map(fn)
    return type(tree)(**{f.name: fn(getattr(tree, f.name))
                         for f in dataclasses.fields(tree)})


class AdamState(NamedTuple):
    step: int                # updates taken so far (host counter)
    mu: SurfelParams         # first moments (or SkyParams)
    nu: SurfelParams         # second moments

    def to(self, device) -> "AdamState":
        return AdamState(step=self.step, mu=self.mu.to(device),
                         nu=self.nu.to(device))


def adam_init(params) -> AdamState:
    return AdamState(step=0, mu=_map(torch.zeros_like, params),
                     nu=_map(torch.zeros_like, params))


@torch.no_grad()
def adam_update(grads, state: AdamState, params, lrs, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-15):
    """One Adam step with one learning rate per leaf (``lrs``: the
    parameters' structure of floats or 0-d tensors, e.g. the scheduled xyz
    rate on the device, or one float for every leaf).

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
    leaves = tensor_leaves(params)
    lr_leaves = ([lrs] * len(leaves) if isinstance(lrs, (int, float))
                 else tensor_leaves(lrs))
    for p, g, m, v, lr in zip(leaves, tensor_leaves(grads),
                              tensor_leaves(state.mu),
                              tensor_leaves(state.nu), lr_leaves):
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p.sub_(upd * lr)
    return params, AdamState(step=step, mu=state.mu, nu=state.nu)
