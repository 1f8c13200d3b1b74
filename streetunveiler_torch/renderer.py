"""High-level renders (counterpart of ``streetunveiler_tpu/renderer.py``):
``render``, ``render_semantic`` and ``measure_duplicate_capacity`` over a
``SurfelState``, with the reference's render-dict contract as a dataclass.

Entry points take ``device`` (default ``"cuda"``; a CUDA request without a
card raises) and move the camera and state there when they are not there
already.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .device import resolve_device
from .models.gaussians import SurfelState
from .ops.depth_normal import depth_to_normal
from .ops.rasterizer import RasterizeSettings, rasterize, rasterize_oracle
from .ops.rasterizer.api import bin_for_camera
from .ops.rasterizer.kernel import S_CHUNK
from .ops.sh import eval_sh
from .scene.cameras import Camera


@dataclasses.dataclass(frozen=True)
class RenderResult:
    """The reference render-dict contract, channels-last."""
    render: Any          # [H, W, 3]
    rend_alpha: Any      # [H, W]
    rend_normal: Any     # [H, W, 3] view-space, alpha-weighted
    rend_dist: Any       # [H, W] depth-distortion accumulator
    surf_depth: Any      # [H, W]
    surf_normal: Any     # [H, W, 3] view-space, alpha-weighted
    radii: Any           # [C] screen radii (0 = culled)
    expected_depth: Any  # [H, W] unnormalized
    median_depth: Any    # [H, W]
    overflow: Any = False   # [] bool — duplicate stream truncated
    demand: Any = None   # [] i32 uncapped duplicate total (capacity sizing)
    extra: Any = None    # [H, W, E] fused extra payload channels
    class_dist: Any = None  # [H, W, G] fused per-class distortion maps

    @property
    def visibility_filter(self):
        return self.radii > 0

    def rend_normal_world(self, camera: Camera):
        return (self.rend_normal[..., :, None]
                * camera.w2c[:3, :3]).sum(dim=-2)

    def surf_normal_world(self, camera: Camera):
        return (self.surf_normal[..., :, None]
                * camera.w2c[:3, :3]).sum(dim=-2)


def _settings_for(camera: Camera, scale_modifier: float) -> RasterizeSettings:
    return RasterizeSettings(width=camera.width, height=camera.height,
                             znear=0.2, zfar=100.0,
                             scale_modifier=scale_modifier)


def surfel_colors(state: SurfelState, camera: Camera, active_sh_degree):
    """Per-surfel view-dependent RGB: SH decode + 0.5 shift, clamped ≥ 0."""
    dirs = state.params.xyz - camera.camera_center[None, :]
    dirs = dirs / torch.sqrt(torch.clamp(
        torch.sum(dirs * dirs, dim=-1, keepdim=True), min=1e-12))
    feats = state.get_features()
    # lower active degrees zero the tail bands
    k = feats.shape[1]
    band = torch.as_tensor(np.repeat(np.arange(state.sh_degree + 1),
                                     2 * np.arange(state.sh_degree + 1) + 1)
                           [:k], device=feats.device)
    feats = torch.where((band <= active_sh_degree)[None, :, None], feats,
                        torch.zeros_like(feats))
    rgb = eval_sh(state.sh_degree, feats, dirs) + 0.5
    return torch.clamp(rgb, min=0.0)


def bin_camera(camera: Camera, state: SurfelState,
               scale_modifier: float = 1.0, opacity_mask=None,
               center2d_offset=None, duplicate_capacity: int | None = None,
               max_tiles_per_surfel: int = 256):
    """Tile binning alone → ``StreamBinning`` (pass it to
    ``render(..., binning=...)``); camera and state on one device."""
    opac = state.get_opacity()[:, 0]
    if opacity_mask is not None:
        opac = torch.where(opacity_mask, opac, torch.zeros_like(opac))
    settings = _settings_for(camera, scale_modifier)
    return bin_for_camera(state.params.xyz, state.get_scaling(),
                          state.get_rotation(), opac, camera.w2c, camera.K,
                          settings, max_tiles_per_surfel=max_tiles_per_surfel,
                          duplicate_capacity=duplicate_capacity,
                          center2d_offset=center2d_offset)


def round_capacity(demand: int, headroom: float = 1.2) -> int:
    """Chunk-aligned static duplicate capacity for a measured demand."""
    cap = int(demand * headroom) + S_CHUNK
    return -(-cap // S_CHUNK) * S_CHUNK


def measure_duplicate_capacity(cameras, state: SurfelState,
                               headroom: float = 1.2, sample: int = 8,
                               device="cuda") -> int:
    """The true duplicate demand of ``state`` over (a sample of)
    ``cameras``, as an overflow-free static capacity. The binning counts
    its uncapped total before truncation, so the probe is exact at any
    probe capacity."""
    dev = resolve_device(device)
    state = state.to(dev)
    cams = list(cameras)
    if len(cams) > sample:          # evenly spaced sample
        idx = np.linspace(0, len(cams) - 1, sample).astype(int)
        cams = [cams[i] for i in idx]
    demand = 0
    for cam in cams:
        b = bin_camera(cam.to(dev), state)
        demand = max(demand, int(b.demand))
    return round_capacity(demand, headroom)


def render(camera: Camera, state: SurfelState, bg,
           active_sh_degree=3, scale_modifier: float = 1.0,
           depth_ratio: float = 0.0, opacity_mask=None,
           colors_override=None, center2d_offset=None,
           use_oracle: bool = False, duplicate_capacity: int | None = None,
           extra_payload=None, class_gates=None, binning=None,
           device="cuda") -> RenderResult:
    """Render a SurfelState through the tiled rasterizer on ``device``.

    opacity_mask [C] bool: surfels where False render with opacity 0.
    colors_override [C,3]: skip the SH decode. extra_payload [C,E]: extra
    channels blended in the same pass (→ ``result.extra``). class_gates
    [C,G] bool: G gated per-class distortion chains in the same pass (→
    ``result.class_dist`` [H,W,G]). binning: a precomputed StreamBinning
    from ``bin_camera`` of the same state, camera and mask.
    """
    dev = resolve_device(device)
    state = state.to(dev)
    camera = camera.to(dev)
    opac = state.get_opacity()[:, 0]
    if opacity_mask is not None:
        opac = torch.where(opacity_mask.to(dev), opac, torch.zeros_like(opac))
    colors = (colors_override.to(dev) if colors_override is not None
              else surfel_colors(state, camera, active_sh_degree))
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)

    settings = _settings_for(camera, scale_modifier)
    args = (state.params.xyz, state.get_scaling(), state.get_rotation(),
            opac, colors, camera.w2c, camera.K, settings)
    if use_oracle:
        out = rasterize_oracle(*args, bg=bg, center2d_offset=center2d_offset)
    else:
        out = rasterize(*args, bg=bg, center2d_offset=center2d_offset,
                        duplicate_capacity=duplicate_capacity,
                        extra_payload=(None if extra_payload is None
                                       else extra_payload.to(dev)),
                        class_gates=(None if class_gates is None
                                     else class_gates.to(dev)),
                        binning=binning)
    return finalize_render(out, camera, depth_ratio=depth_ratio)


def finalize_render(out, camera: Camera, depth_ratio: float = 0.0
                    ) -> RenderResult:
    """RenderOutput → the reference render-dict contract (depth mix and
    depth→normal pseudo surface)."""
    alpha = out.alpha
    exp_depth = torch.nan_to_num(out.expected_depth
                                 / torch.clamp(alpha, min=1e-8))
    surf_depth = exp_depth * (1.0 - depth_ratio) + depth_ratio * \
        torch.nan_to_num(out.median_depth)
    surf_normal = depth_to_normal(surf_depth, camera.K)
    surf_normal = surf_normal * alpha.detach()[..., None]
    return RenderResult(
        render=out.color,
        rend_alpha=alpha,
        rend_normal=out.normal,
        rend_dist=out.distortion,
        surf_depth=surf_depth,
        surf_normal=surf_normal,
        radii=out.radii,
        expected_depth=out.expected_depth,
        median_depth=out.median_depth,
        overflow=out.overflow,
        demand=out.demand,
        extra=out.extra,
        class_dist=out.class_dist,
    )


def semantic_class_mask(state: SurfelState, class_bits: int,
                        reverse: bool = True):
    """Opacity mask for bitmask semantic filtering: reverse=True keeps
    surfels in the class, reverse=False keeps the complement."""
    m = state.semantic_mask(class_bits)
    return m if reverse else ~m


def render_semantic(camera: Camera, state: SurfelState,
                    num_classes: int = 6, sky_index: int = 4,
                    scale_modifier: float = 1.0, opacity_mask=None,
                    center2d_offset=None,
                    duplicate_capacity: int | None = None, device="cuda"):
    """Semantic probability rendering: each surfel's one-hot class vector
    splatted as color + extra payload in one blend (nq = 3 + num_classes),
    with the sky-class prior as background. Returns [H, W, num_classes]."""
    dev = resolve_device(device)
    state = state.to(dev)
    onehot = torch.nn.functional.one_hot(state.semantics.long(),
                                         num_classes).to(torch.float32)
    res = render(camera, state, torch.zeros(3), scale_modifier=scale_modifier,
                 opacity_mask=opacity_mask, colors_override=onehot[:, 0:3],
                 extra_payload=onehot[:, 3:num_classes],
                 center2d_offset=center2d_offset,
                 duplicate_capacity=duplicate_capacity, device=dev)
    probs = torch.cat([res.render, res.extra], dim=-1)
    # sky prior: empty pixels read as sky
    sky_prior = torch.nn.functional.one_hot(
        torch.tensor(sky_index), num_classes).to(torch.float32).to(dev)
    return probs + sky_prior * (1.0 - res.rend_alpha)[..., None]
