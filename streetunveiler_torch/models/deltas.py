"""Masked delta re-optimization (counterpart of ``streetunveiler_tpu/
models/deltas.py``; the reference's ``MaskGaussianModel``).

The reference's frozen-base + trainable-delta model is one equation:

    effective_param = detach(base) + delta · mask

with per-attribute freeze bits and a per-surfel trainable mask. The deltas
are a ``SurfelParams`` of zeros; the unveil stage's optimizer steps only
them.
"""

from __future__ import annotations

import dataclasses

import torch

from .gaussians import SurfelParams, SurfelState


@dataclasses.dataclass(frozen=True)
class DeltaConfig:
    """Which attributes train (the reference's freeze bits: stage C trains
    xyz, features, scaling, rotation and opacity of the masked surfels)."""
    xyz: bool = True
    features: bool = True
    scaling: bool = True
    rotation: bool = True
    opacity: bool = True


def zero_deltas(params: SurfelParams) -> SurfelParams:
    return SurfelParams(**{f.name: torch.zeros_like(getattr(params, f.name))
                           for f in dataclasses.fields(params)})


def apply_deltas(base: SurfelState, deltas: SurfelParams, train_mask,
                 cfg: DeltaConfig = DeltaConfig()) -> SurfelState:
    """The effective state: the detached base plus the masked deltas.

    ``train_mask`` [C] bool — 1 = re-optimizable. Each enabled leaf is
    ``base + delta·mask``, so surfels outside the mask keep their base
    values bit for bit (x + 0·d = x), and a disabled leaf is the base
    itself."""
    b = base.params
    m = torch.as_tensor(train_mask, device=b.xyz.device).to(torch.float32)
    enabled = dict(xyz=cfg.xyz, features_dc=cfg.features,
                   features_rest=cfg.features, scaling=cfg.scaling,
                   rotation=cfg.rotation, opacity=cfg.opacity)

    def mix(name):
        bleaf = getattr(b, name).detach()
        if not enabled[name]:
            return bleaf
        mm = m.reshape((-1,) + (1,) * (bleaf.dim() - 1))
        return bleaf + getattr(deltas, name) * mm

    params = SurfelParams(**{f.name: mix(f.name)
                             for f in dataclasses.fields(SurfelParams)})
    return dataclasses.replace(base, params=params)
