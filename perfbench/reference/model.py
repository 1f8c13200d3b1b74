"""The plain training step and render the benchmark judges the program
by: the surfel state's activations, the SH colours, ``render`` and
``render_semantic``, the hash-grid sky, L1, SSIM and the semantic and
distortion terms of the stage-1 loss, Adam with per-leaf rates, and the
densification statistics, in plain PyTorch and float32 (TF32 is the
caller's to set: the control turns it on).

A frozen copy of the port's plain path as it stood when the benchmark was
defined (``raster.py`` holds the rasterizer). It imports nothing of the
program.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import raster
from .raster import (RasterizeSettings, depth_to_normal, eval_sh, rasterize,
                     sh_basis)


@dataclasses.dataclass
class Mode:
    """How the reference computes: ``tf32`` (the control: the operands of
    every matrix product and convolution rounded to TF32's 10 mantissa
    bits, and the library's TF32 switched on) and ``half_batch`` (a planted
    fault: the photometric and semantic losses over the image's upper
    half, the mean taken over it)."""
    tf32: bool = False
    half_batch: bool = False


MODE = Mode()


def round_tf32(x):
    """``x`` rounded to TF32 (1 sign, 8 exponent, 10 mantissa bits), to
    the nearest, ties away from zero."""
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32).view(x.shape)


def _operand(x):
    """A matrix product's or convolution's operand in the mode's
    precision (the gradient passes straight through the rounding)."""
    if not MODE.tf32:
        return x
    return x + (round_tf32(x) - x).detach()


@contextlib.contextmanager
def mode(tf32: bool = False, half_batch: bool = False):
    """Compute in ``mode`` inside the block."""
    old = (MODE.tf32, MODE.half_batch, torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    MODE.tf32, MODE.half_batch = tf32, half_batch
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (MODE.tf32, MODE.half_batch, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@dataclasses.dataclass(frozen=True)
class StepOptions:
    """The options of the stage-1 step that the loss, the rates and the
    statistics read (the names and defaults of the port's
    ``OptimizationParams``); a configuration file overrides them."""
    position_lr_init: float = 1.6e-5
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 50_000
    feature_lr: float = 2.5e-3
    opacity_lr: float = 0.05
    scaling_lr: float = 1e-3
    rotation_lr: float = 1e-3
    lambda_dssim: float = 0.2
    lambda_dist: float = 100.0
    lambda_normal: float = 0.05
    enable_semantic_loss: bool = True
    semantic_loss_ratio: float = 0.1
    densify_until_iter: int = 25_000
    semantic_dist_from_iter: int = 27_500
    normal_consist_from_iter: int = 30_000
    shrinking_from_iter: int = 31_000
    lambda_shrink: float = 0.001


CONCERNED_CLASSES = ["road", "sidewalk", "building", "vegetation", "sky",
                     "vehicle"]
CONCERNED_IND = {name: i for i, name in enumerate(CONCERNED_CLASSES)}
NUM_CONCERNED = len(CONCERNED_CLASSES)


@dataclasses.dataclass(frozen=True)
class Camera:
    """A pinhole camera. ``w2c``: 4x4 world→view; ``K``: 3x3 intrinsics."""

    w2c: torch.Tensor
    K: torch.Tensor
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def device(self) -> torch.device:
        return self.w2c.device

    @property
    def fx(self):
        return self.K[0, 0]

    @property
    def fy(self):
        return self.K[1, 1]

    @property
    def cx(self):
        return self.K[0, 2]

    @property
    def cy(self):
        return self.K[1, 2]

    @property
    def camera_center(self):
        return torch.linalg.inv(self.w2c)[:3, 3]

    def to(self, device) -> "Camera":
        return dataclasses.replace(self, w2c=self.w2c.to(device),
                                   K=self.K.to(device))



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
    dev = torch.device(device)
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
    dev = torch.device(device)
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


HASH_PRIMES = (1, 2654435761 - 2 ** 32, 805459861)


_INT32_MIN = -2 ** 31


@dataclasses.dataclass(frozen=True)
class SkyParams:
    hash_tables: torch.Tensor   # [L, 2^log2_size, F]
    mlp_w: tuple                # weights [in, out]
    mlp_b: tuple                # biases [out]
    num_levels: int = 16
    base_res: int = 16
    growth: float = 2.0
    sh_bands: int = 3

    def named_tensors(self) -> dict:
        """The tensors under the JAX package's leaf paths (``.hash_tables``,
        ``.mlp_w[0]``, …, ``.mlp_b[0]``, …), in its leaf order."""
        out = {".hash_tables": self.hash_tables}
        out.update({f".mlp_w[{i}]": w for i, w in enumerate(self.mlp_w)})
        out.update({f".mlp_b[{i}]": b for i, b in enumerate(self.mlp_b)})
        return out

    def map(self, fn) -> "SkyParams":
        """The same structure with ``fn`` applied to every tensor."""
        return dataclasses.replace(
            self, hash_tables=fn(self.hash_tables),
            mlp_w=tuple(fn(w) for w in self.mlp_w),
            mlp_b=tuple(fn(b) for b in self.mlp_b))

    def to(self, device) -> "SkyParams":
        return self.map(lambda t: t.to(device))


def freq_embed(x, num_freqs: int = 10):
    """Log-sampled positional encoding with the input: [..., 3] →
    [..., 3 + 6·num_freqs]."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    ang = x[..., None, :] * freqs[:, None]                 # [..., F, 3]
    enc = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], dim=-1)


def _wrap32(v):
    """int64 tensor → the int32 value with the same low 32 bits."""
    return ((v - _INT32_MIN) & 0xFFFFFFFF) + _INT32_MIN


def hash_encode(params: SkyParams, x):
    """Multiresolution hash-grid lookup with trilinear interpolation.

    x: [..., 3] raw world coordinates (the hash wraps any range). Returns
    [..., L·F]. The grid coordinate converts to int32 as XLA converts
    (saturating, NaN → 0); the int32 arithmetic then runs in int64 and is
    wrapped back to int32 after every step that can overflow."""
    n_levels, table_size, n_feat = params.hash_tables.shape
    dev = x.device
    # every level and corner at once (a loop over them launches thousands
    # of tiny kernels on a card): [..., L, 3] grid coordinates, then
    # [..., L, 8, 3] corners
    res = torch.tensor([params.base_res * params.growth ** level
                        for level in range(n_levels)], dtype=x.dtype,
                       device=dev)
    scaled = x[..., None, :] * res[:, None]
    base = torch.floor(scaled)
    frac = scaled - base
    base = torch.nan_to_num(base, nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31)
    base = base.to(torch.int64).clamp(_INT32_MIN, 2 ** 31 - 1)
    off = torch.tensor([[(corner >> k) & 1 for k in range(3)]
                        for corner in range(8)], device=dev)   # [8, 3]
    c = _wrap32(base[..., None, :] + off)
    primes = torch.tensor(HASH_PRIMES, dtype=torch.int64, device=dev)
    hk = _wrap32(c * primes)
    h = hk[..., 0] ^ hk[..., 1] ^ hk[..., 2]                   # [..., L, 8]
    h = torch.where(h == _INT32_MIN, h, h.abs())               # int32 abs
    idx = torch.remainder(h, table_size) + table_size * torch.arange(
        n_levels, device=dev)[:, None]
    f = frac[..., None, :]
    w = torch.where(off.bool(), f, 1.0 - f).prod(dim=-1)      # [..., L, 8]
    feats = params.hash_tables.reshape(-1, n_feat)[idx]       # [..., L, 8, F]
    out = (w[..., None] * feats).sum(dim=-2)                  # [..., L, F]
    return out.reshape(*x.shape[:-1], n_levels * n_feat)


def _mlp_tail(params: SkyParams, h):
    """Layers 1.. of the MLP on the first layer's pre-activation, then the
    sigmoid."""
    for w, b in zip(params.mlp_w[1:], params.mlp_b[1:]):
        h = _operand(torch.relu(h)) @ _operand(w) + b
    return torch.sigmoid(h)


def camera_rays(height: int, width: int, K, c2w):
    """Per-pixel rays (origins, directions) [H, W, 3]: direction
    ((i − cx)/fx, −(j − cy)/fy, −1) rotated by c2w, unnormalized."""
    dev = c2w.device
    j, i = torch.meshgrid(torch.arange(height, dtype=torch.float32,
                                       device=dev),
                          torch.arange(width, dtype=torch.float32,
                                       device=dev), indexing="ij")
    dirs = torch.stack([(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1],
                        -torch.ones_like(i)], dim=-1)
    # a 3-wide contraction as products and sums: full f32 whatever the
    # TF32 flags say
    rays_d = (dirs[..., None, :] * c2w[:3, :3]).sum(dim=-1)
    rays_o = c2w[:3, 3].expand_as(rays_d)
    return rays_o, rays_d


def render_sky(params: SkyParams, height: int, width: int, K, c2w):
    """[H, W, 3] sky image for a camera: ``sky_forward`` over
    ``camera_rays``, with the shared origin encoded once."""
    _, rays_d = camera_rays(height, width, K, c2w)
    origin = c2w[None, :3, 3]
    o_enc = torch.cat([hash_encode(params, origin), freq_embed(origin)],
                      dim=-1)                                 # [1, L·F + 63]
    d_enc = sh_basis(rays_d, params.sh_bands)                 # [H, W, 16]
    w0 = params.mlp_w[0]
    n_d = d_enc.shape[-1]
    h = _operand(d_enc) @ _operand(w0[:n_d]) + (
        _operand(o_enc) @ _operand(w0[n_d:]) + params.mlp_b[0])[0]
    return _mlp_tail(params, h)


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def psnr(pred, target, dim=None):
    """PSNR in dB over all elements (or per ``dim``)."""
    mse = torch.mean((pred - target) ** 2, dim=dim)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float):
    xs = [math.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma ** 2))
          for x in range(window_size)]
    s = sum(xs)
    return tuple(x / s for x in xs)


def _blur(x, window_size: int, sigma: float):
    """Separable depthwise Gaussian blur of x [C, H, W], zero padding."""
    c = x.shape[0]
    r = window_size // 2
    w = torch.tensor(_gaussian_window(window_size, sigma), dtype=x.dtype,
                     device=x.device)
    kh = w.view(1, 1, -1, 1).expand(c, 1, window_size, 1)
    kw = w.view(1, 1, 1, -1).expand(c, 1, 1, window_size)
    x = F.conv2d(_operand(x[None]), _operand(kh), padding=(r, 0), groups=c)
    x = F.conv2d(_operand(x), _operand(kw), padding=(0, r), groups=c)
    return x[0]


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """Mean windowed SSIM of [H, W, C] images in [0, 1]. The five blurred
    maps (μ1, μ2, E[x1²], E[x2²], E[x1·x2]) go through one depthwise
    convolution pair as 5·C channels."""
    a = img1.permute(2, 0, 1)
    b = img2.permute(2, 0, 1)
    c = a.shape[0]
    blurred = _blur(torch.cat([a, b, a * a, b * b, a * b], dim=0),
                    window_size, sigma)
    mu1, mu2, e11, e22, e12 = torch.split(blurred, c, dim=0)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map)


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1_000_000) -> float:
    """Log-linear interpolation from ``lr_init`` to ``lr_final`` over
    ``max_steps`` with an optional sine delay ramp (the reference's
    ``get_expon_lr_func``). Host-side floats: the step number is known on
    the host, and the rates must be positive. Evaluated in float32 like
    the JAX package's."""
    f32 = np.float32
    step = f32(step)
    if lr_delay_steps > 0:
        delay_rate = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
            f32(0.5 * math.pi) * np.clip(step / f32(lr_delay_steps), 0, 1))
    else:
        delay_rate = f32(1.0)
    t = np.clip(step / f32(max_steps), f32(0), f32(1))
    log_lerp = np.exp(np.log(f32(lr_init)) * (f32(1) - t)
                      + np.log(f32(lr_final)) * t)
    return float(f32(delay_rate * log_lerp))


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


SEMANTIC_CLASS_WEIGHTS = (1.0, 1.0, 1.0, 1.0, 0.2, 1.0)  # sky down-weighted


SKY_LR = 1e-4            # the sky's own Adam: lr 1e-4, eps 1e-8


SKY_EPS = 1e-8


DIST_CLASSES = tuple(ci for ci in range(len(SEMANTIC_CLASS_WEIGHTS))
                     if ci != CONCERNED_IND["sky"])


def make_lrs(opt: StepOptions, iteration: int,
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
                iteration: int, opt: StepOptions, sky_params=None,
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
    rows = image.shape[0] // 2 if MODE.half_batch else image.shape[0]
    ll1 = l1_loss(image[:rows], gt_image[:rows])
    lssim = ssim(image[:rows], gt_image[:rows])
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
        sem_loss = semantic_ce_loss(probs[:rows], gt_semantic[:rows])
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


def train_step(state: SurfelState, opt_state: AdamState, camera: Camera,
               gt_image, bg, iteration: int, opt: StepOptions,
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
    dev = torch.device(device)
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


@torch.no_grad()
def pair_counts(camera: Camera, state: SurfelState, active_sh_degree=3,
                colors_override=None, extra_payload=None, class_gates=None,
                duplicate_capacity: int | None = None,
                backward: bool = True) -> dict:
    """The pair counts of the blend that ``render`` runs for this camera
    and state (``k1``: the forward's, ``k2``: the backward's, both under
    the kernels' skip rule) and the stream's sizes that the bytes of each
    call count (``rec_rows``, ``capacity``, ``filled``, ``n_tiles``,
    ``pixels``, ``channels``, ``nq``, ``n_gates``)."""
    opac = state.get_opacity()[:, 0]
    colors = (colors_override if colors_override is not None
              else surfel_colors(state, camera, active_sh_degree))
    settings = _settings_for(camera, 1.0)
    sur = raster.preprocess_surfels(state.params.xyz, state.get_scaling(),
                                    state.get_rotation(), opac, colors,
                                    camera.w2c, camera.K, settings)
    nq = raster.NQ + (0 if extra_payload is None else extra_payload.shape[1])
    pack_extra, n_gates = raster.encode_extra(extra_payload, class_gates)
    b = raster.bin_surfels_stream(sur.center2d, sur.ext, sur.depth,
                                  sur.valid, settings.width, settings.height,
                                  raster.TILE_W, raster.TILE_H,
                                  duplicate_capacity, cull=sur.cull)
    recT = raster._gather_records(raster.pack_geometry_T(
        sur, state.capacity, pack_extra), b.sorted_surfel)
    acc, lk, k1 = raster.blend_forward_plain(
        recT, b.tile_offsets, b.tiles_x, b.tiles_y, settings, nq, n_gates,
        tile_batch=raster.TILE_BATCH, count_pairs=True, skip_rule=True)
    n_tiles = b.tiles_x * b.tiles_y
    out = dict(k1=k1, nq=nq, n_gates=n_gates, rec_rows=recT.shape[0],
               capacity=recT.shape[1], filled=int(b.tile_offsets[-1]),
               n_tiles=n_tiles, pixels=n_tiles * raster.PIX,
               channels=acc.shape[-1], overflow=bool(b.overflow))
    if backward:
        _, out["k2"] = raster.blend_backward_plain(
            recT, b.tile_offsets, b.tiles_x, b.tiles_y, settings, acc, lk,
            torch.zeros_like(acc), nq, n_gates,
            tile_batch=raster.TILE_BATCH, count_pairs=True, skip_rule=True)
    return out
