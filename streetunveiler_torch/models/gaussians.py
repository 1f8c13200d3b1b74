"""Surfel model state (counterpart of ``streetunveiler_tpu/models/
gaussians.py``): fixed-capacity tensors with an ``alive`` mask.

Parameterization as the reference: xyz [C,3]; SH features split dc
[C,1,3] / rest [C,K-1,3]; log-scales [C,2] (2D surfels); quaternion
[C,4]; opacity logit [C,1]; frozen int32 semantics [C]. Dead slots carry
a very negative opacity logit, so the rasterizer culls them.

Densify and prune come with the training slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..ops.knn import mean_sq_dist_to_3nn
from ..ops.sh import num_sh_bases, rgb_to_sh
from ..ops.transforms import inverse_sigmoid

DEAD_OPACITY_LOGIT = -20.0


@dataclasses.dataclass(frozen=True)
class SurfelParams:
    """Learnable parameters (raw, pre-activation)."""
    xyz: torch.Tensor            # [C, 3]
    features_dc: torch.Tensor    # [C, 1, 3]
    features_rest: torch.Tensor  # [C, K-1, 3]
    scaling: torch.Tensor        # [C, 2] log
    rotation: torch.Tensor       # [C, 4]
    opacity: torch.Tensor        # [C, 1] logit

    def to(self, device) -> "SurfelParams":
        return SurfelParams(**{f.name: getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class SurfelState:
    """Full surfel state (parameters + frozen/bookkeeping tensors)."""
    params: SurfelParams
    semantics: torch.Tensor      # [C] int32
    alive: torch.Tensor          # [C] bool
    max_radii2d: torch.Tensor    # [C] f32
    grad_accum: torch.Tensor     # [C] f32 screen-grad norm accumulator
    denom: torch.Tensor          # [C] f32
    spatial_scale: torch.Tensor  # [] f32 — cameras_extent
    sh_degree: int = 3

    @property
    def capacity(self) -> int:
        return self.params.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.params.xyz.device

    @property
    def num_alive(self):
        return torch.sum(self.alive)

    def to(self, device) -> "SurfelState":
        """The state on ``device`` (itself when it is there already)."""
        if self.device == torch.device(device):
            return self
        return dataclasses.replace(
            self, params=self.params.to(device),
            **{name: getattr(self, name).to(device)
               for name in ("semantics", "alive", "max_radii2d",
                            "grad_accum", "denom", "spatial_scale")})

    # --- activations (reference :96-128) ---
    def get_scaling(self):
        return torch.exp(self.params.scaling)

    def get_rotation(self):
        q = self.params.rotation
        return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)

    def get_opacity(self):
        op = torch.sigmoid(self.params.opacity)
        return torch.where(self.alive[:, None], op, torch.zeros_like(op))

    def get_features(self):
        return torch.cat([self.params.features_dc,
                          self.params.features_rest], dim=1)

    def semantic_mask(self, class_bits: int):
        """Bool mask of surfels whose class index is set in ``class_bits``."""
        bit = torch.bitwise_left_shift(
            torch.ones_like(self.semantics), self.semantics)
        return (bit & class_bits) != 0


def empty_params(capacity: int, sh_degree: int,
                 device="cuda") -> SurfelParams:
    dev = resolve_device(device)
    k = num_sh_bases(sh_degree)
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    rotation = z(capacity, 4)
    rotation[:, 0] = 1.0
    return SurfelParams(
        xyz=z(capacity, 3), features_dc=z(capacity, 1, 3),
        features_rest=z(capacity, k - 1, 3), scaling=z(capacity, 2),
        rotation=rotation,
        opacity=torch.full((capacity, 1), DEAD_OPACITY_LOGIT,
                           dtype=torch.float32, device=dev))


def create_from_pcd(points, colors, semantics, spatial_scale: float,
                    capacity: int | None = None, sh_degree: int = 3,
                    seed: int = 0, device="cuda") -> SurfelState:
    """Initialize from a (semantic) point cloud — reference
    ``create_from_pcd``: scale = log √(mean-sq-dist-to-3NN) on both axes,
    opacity 0.1, uniform [0,1) quaternions from ``seed`` (numpy, so the
    JAX package draws the same ones)."""
    dev = resolve_device(device)
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    if capacity is None:
        capacity = int(n * 2.5)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < initial points {n}")

    dist2 = np.maximum(mean_sq_dist_to_3nn(points), 1e-7)
    scales = np.log(np.sqrt(dist2))[:, None].repeat(2, axis=1)
    rng = np.random.default_rng(seed)
    rots = rng.random((n, 4)).astype(np.float32) + 1e-3
    sh_dc = rgb_to_sh(np.asarray(colors, np.float32))
    opac0 = float(inverse_sigmoid(torch.tensor(0.1, dtype=torch.float32)))

    p = empty_params(capacity, sh_degree, dev)
    put = lambda buf, vals: buf[:n].copy_(torch.as_tensor(
        np.asarray(vals, np.float32)))
    put(p.xyz, points)
    put(p.features_dc, sh_dc[:, None, :])
    put(p.scaling, scales)
    put(p.rotation, rots)
    p.opacity[:n] = opac0
    sem = torch.zeros(capacity, dtype=torch.int32, device=dev)
    sem[:n] = torch.as_tensor(np.asarray(semantics, np.int32))
    alive = torch.zeros(capacity, dtype=torch.bool, device=dev)
    alive[:n] = True
    z = lambda: torch.zeros(capacity, dtype=torch.float32, device=dev)
    return SurfelState(params=p, semantics=sem, alive=alive,
                       max_radii2d=z(), grad_accum=z(), denom=z(),
                       spatial_scale=torch.tensor(spatial_scale,
                                                  dtype=torch.float32,
                                                  device=dev),
                       sh_degree=sh_degree)
