"""Surfel model state (counterpart of ``streetunveiler_tpu/models/
gaussians.py``): fixed-capacity tensors with an ``alive`` mask.

Parameterization as the reference: xyz [C,3]; SH features split dc
[C,1,3] / rest [C,K-1,3]; log-scales [C,2] (2D surfels); quaternion
[C,4]; opacity logit [C,1]; frozen int32 semantics [C]. Dead slots carry
a very negative opacity logit, so the rasterizer culls them.

Densification works on fixed shapes as in the JAX package: newborn
surfels take dead slots, and pruning clears ``alive`` and seals the slot's
opacity logit. These functions return new tensors and leave their inputs
as they were.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..ops.knn import mean_sq_dist_to_3nn
from ..ops.sh import num_sh_bases, rgb_to_sh
from ..ops.transforms import inverse_sigmoid, quat_to_rotmat

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


# ------------------------------------------------------------ densification

def add_densification_stats(state: SurfelState, screen_grads, radii,
                            visible) -> SurfelState:
    """Accumulate per-surfel screen-space gradient norms, visibility counts
    and the largest screen radius over iterations."""
    gnorm = torch.linalg.vector_norm(screen_grads, dim=-1)
    vis = visible & state.alive
    zero = torch.zeros_like(gnorm)
    return dataclasses.replace(
        state,
        grad_accum=state.grad_accum + torch.where(vis, gnorm, zero),
        denom=state.denom + vis.to(torch.float32),
        max_radii2d=torch.where(vis, torch.maximum(state.max_radii2d, radii),
                                state.max_radii2d))


def _write_rows(leaf, targets, values, mask):
    """A copy of ``leaf`` with leaf[targets[i]] = values[i] where mask[i]
    (row i dropped otherwise): the masked rows land in a scratch row past
    the end, so no host synchronisation is needed."""
    cap = leaf.shape[0]
    safe_t = torch.where(mask, targets, torch.full_like(targets, cap))
    out = torch.cat([leaf, leaf[:1]], dim=0)
    out.index_copy_(0, safe_t, values)
    return out[:cap]


def _params_map(fn, *trees):
    return SurfelParams(**{f.name: fn(*(getattr(t, f.name) for t in trees))
                           for f in dataclasses.fields(SurfelParams)})


def densify_and_prune(state: SurfelState, opt_mu: SurfelParams,
                      opt_nu: SurfelParams, grad_threshold: float,
                      min_opacity: float, max_screen_size: float | None,
                      generator: torch.Generator | None = None,
                      percent_dense: float = 0.01, samples=None):
    """One densify + prune pass at fixed capacity.

    Clone small high-gradient surfels, split large ones (two children
    drawn from the surfel's own 2D Gaussian, scales / 1.6, parent pruned
    once both children were placed), then prune by opacity and, with
    ``max_screen_size``, by screen and world size. Returns
    (state, opt_mu, opt_nu) with zero moments in the newborn slots.
    Candidates that find no dead slot are dropped (watch ``num_alive``).

    The split offsets are N(0, 1) samples [2, cap, 2] scaled by the
    surfel's scales: ``samples`` when given (tests hand both packages the
    same numbers), else drawn with ``generator`` on the state's device.
    """
    p = state.params
    cap = state.capacity
    dev = p.xyz.device
    grads = torch.where(state.denom > 0, state.grad_accum / state.denom,
                        torch.zeros_like(state.grad_accum))
    scaling = torch.exp(p.scaling)
    max_scale = scaling.amax(dim=1)
    extent = state.spatial_scale

    high_grad = (grads >= grad_threshold) & state.alive
    clone_mask = high_grad & (max_scale <= percent_dense * extent)
    split_mask = high_grad & (max_scale > percent_dense * extent)

    # candidate pool: [cap] clones, then 2 × [cap] split children
    rot = quat_to_rotmat(p.rotation / torch.linalg.vector_norm(
        p.rotation, dim=-1, keepdim=True))
    if samples is None:
        samples = torch.randn((2, cap, 2), generator=generator, device=dev)
    samples = samples.to(dev) * scaling[None]
    # 2D surfel: offset = R @ (s1·n1, s2·n2, 0)
    offsets = (rot[None, :, :, :2] * samples[:, :, None, :]).sum(dim=-1)
    child_xyz = p.xyz[None] + offsets                       # [2, cap, 3]
    child_scaling = torch.log(scaling / (0.8 * 2.0))

    def cand(leaf, child_leaf=None):
        c = child_leaf if child_leaf is not None else (leaf, leaf)
        return torch.cat([leaf, c[0], c[1]], dim=0)

    cand_params = SurfelParams(
        xyz=cand(p.xyz, child_xyz),
        features_dc=cand(p.features_dc),
        features_rest=cand(p.features_rest),
        scaling=cand(p.scaling, (child_scaling, child_scaling)),
        rotation=cand(p.rotation),
        opacity=cand(p.opacity))
    cand_sem = torch.cat([state.semantics] * 3)
    cand_valid = torch.cat([clone_mask, split_mask, split_mask])

    # free slots (dead first) and valid candidates (in order), paired
    slot_order = torch.argsort(state.alive.to(torch.int8), stable=True)
    n_free = cap - torch.sum(state.alive)
    cand_order = torch.argsort((~cand_valid).to(torch.int8), stable=True)
    n_valid = torch.sum(cand_valid)
    k = torch.arange(cap, device=dev)
    write = (k < n_free) & (k < n_valid)
    targets = slot_order
    sources = cand_order[:cap]

    new_params = _params_map(
        lambda leaf, cl: _write_rows(leaf, targets, cl[sources], write),
        p, cand_params)
    new_sem = _write_rows(state.semantics, targets, cand_sem[sources], write)
    new_alive = _write_rows(state.alive, targets,
                            torch.ones_like(write), write)

    # newborn slots start with zero Adam moments
    def zero_rows(leaf):
        return _write_rows(leaf, targets, torch.zeros_like(leaf), write)
    opt_mu = _params_map(zero_rows, opt_mu)
    opt_nu = _params_map(zero_rows, opt_nu)

    # prune: split parents whose two children were both placed (at full
    # capacity an unconditional parent prune would only destroy surfels),
    # low opacity, and with max_screen_size screen and world size
    opacity = torch.sigmoid(new_params.opacity[:, 0])
    placed = _write_rows(torch.zeros(3 * cap, dtype=torch.bool, device=dev),
                         sources, torch.ones_like(write), write)
    children_placed = placed[cap:2 * cap] & placed[2 * cap:3 * cap]
    prune = (split_mask & children_placed) | (opacity < min_opacity)
    if max_screen_size is not None:
        prune = prune | (state.max_radii2d > max_screen_size) | (
            torch.exp(new_params.scaling).amax(dim=1) > 0.1 * extent)
    new_alive = new_alive & ~prune

    z = torch.zeros(cap, dtype=torch.float32, device=dev)
    state = dataclasses.replace(
        state, params=new_params, semantics=new_sem, alive=new_alive,
        max_radii2d=z, grad_accum=z.clone(), denom=z.clone())
    return _seal_dead(state), opt_mu, opt_nu


def prune_mask(state: SurfelState, mask) -> SurfelState:
    """Kill the surfels where ``mask``."""
    return _seal_dead(dataclasses.replace(state, alive=state.alive & ~mask))


def reset_opacity(state: SurfelState, opt_mu: SurfelParams,
                  opt_nu: SurfelParams):
    """Clamp opacity to ≤ 0.01 and zero its Adam moments."""
    cap = inverse_sigmoid(torch.tensor(0.01, dtype=torch.float32))
    op = torch.minimum(state.params.opacity, cap.to(state.device))
    params = dataclasses.replace(state.params, opacity=op)
    opt_mu = dataclasses.replace(
        opt_mu, opacity=torch.zeros_like(opt_mu.opacity))
    opt_nu = dataclasses.replace(
        opt_nu, opacity=torch.zeros_like(opt_nu.opacity))
    state = _seal_dead(dataclasses.replace(state, params=params))
    return state, opt_mu, opt_nu


def _seal_dead(state: SurfelState) -> SurfelState:
    """Dead slots get the dead opacity logit, so the rasterizer culls
    them."""
    op = torch.where(state.alive[:, None], state.params.opacity,
                     torch.full_like(state.params.opacity,
                                     DEAD_OPACITY_LOGIT))
    return dataclasses.replace(
        state, params=dataclasses.replace(state.params, opacity=op))
