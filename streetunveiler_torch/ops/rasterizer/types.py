"""Shared types for the 2DGS rasterizer (counterpart of
``streetunveiler_tpu/ops/rasterizer/types.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any

# Numerical constants of the 2DGS blending semantics.
ALPHA_EPS = 1.0 / 255.0     # minimum contribution weight
ALPHA_MAX = 0.99            # opacity clamp
T_EPS = 1e-4                # early-termination transmittance
FILTER_INV_SQUARE = 2.0     # screen-space low-pass: rho2d = 2 * d^2
MEDIAN_T = 0.5              # transmittance threshold for median depth


@dataclasses.dataclass(frozen=True)
class RasterizeSettings:
    """Rasterization configuration.

    ``t_eps`` is the early-termination transmittance (the reference CUDA
    loop break). The trigger ``t_after < t_eps`` is a knife-edge on f32
    rounding: two implementations that compute T in another order flip
    which pair triggers at a few pixels, each flip moving one weight of at
    most t_eps·α/(1−α). 0.0 disables termination (exact-parity testing).
    """

    width: int
    height: int
    znear: float = 0.2
    zfar: float = 100.0
    scale_modifier: float = 1.0
    t_eps: float = T_EPS


@dataclasses.dataclass(frozen=True)
class RenderOutput:
    """All rasterizer outputs, channels-last. ``expected_depth``/``normal``
    are alpha-weighted and unnormalized (the caller normalizes)."""

    color: Any          # [H, W, C]
    alpha: Any          # [H, W]
    expected_depth: Any  # [H, W]
    normal: Any         # [H, W, 3] view-space
    median_depth: Any   # [H, W]
    distortion: Any     # [H, W]
    radii: Any          # [N] screen-space radius (0 = culled)
    overflow: Any = False   # [] bool — duplicate stream truncated
    demand: Any = None  # [] i32 — uncapped duplicate total of the binning
    extra: Any = None   # [H, W, E] extra payload channels
    class_dist: Any = None  # [H, W, G] per-class gated distortion maps
