"""The benchmark's inputs, made on the device from ``--seed``: surfel
scenes, cameras, training targets and the sky's weights.

The scene, named by a configuration file's ``scene`` key, is ``street``:
the street of ``bench.py:22-53`` (ground carpet, facade walls, clutter;
splats projecting to ~4-10 px at f = 1000), SH degree 3, the one-hot
semantics of its classes; the training views are the identity-pose camera
and copies of it stepped along +z.

Targets are renders by the plain reference rasterizer
(``reference/raster.py``), never by the program: the scene itself with
its opacity logits raised by ``gt_opacity_boost`` (its colours and its
semantic argmax). The same seed gives the same inputs on any card.
Everything is a plain tensor here; the entry drivers wrap them in the
program's types and the reference's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .reference import raster

NUM_CLASSES = 6
SKY_CLASS = 4


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def _uniform(g, lo, hi, shape, device):
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def _normal(g, shape, device):
    return torch.randn(shape, generator=g, device=device)


# ------------------------------------------------------------ the street


def street_arrays(cfg: dict, seed: int, device) -> dict:
    """The street's surfel arrays (activated scales and opacities, as the
    scene is described): ``xyz`` [N, 3], ``scales`` [N, 2], ``quats``
    [N, 4], ``opacity`` [N], ``colors`` [N, 3], ``features_rest``
    [N, K-1, 3] ~ N(0, 0.05), ``semantics`` [N] int32."""
    n = int(cfg["n_surfels"])
    g = generator(seed, device)
    n_g, n_w = n // 2, n // 3
    n_c = n - n_g - n_w
    u = lambda lo, hi, *shape: _uniform(g, lo, hi, shape, device)
    ground = torch.stack([u(-30, 30, n_g), torch.full((n_g,), 2.0,
                                                      device=device),
                          u(2, 80, n_g)], 1)
    side = torch.where(u(0, 1, n_w) < 0.5, -12.0, 12.0)
    walls = torch.stack([side + 0.3 * _normal(g, (n_w,), device),
                         u(-8, 2, n_w), u(2, 80, n_w)], 1)
    clutter = torch.stack([u(-10, 10, n_c), u(-3, 2, n_c), u(3, 60, n_c)],
                          1)
    pts = torch.cat([ground, walls, clutter])
    scales = (u(3, 8, n, 1) * pts[:, 2:3] / 1000.0).repeat(1, 2)
    sem = torch.empty(n, dtype=torch.int32, device=device)
    sem[:n_g] = torch.where(ground[:, 0].abs() > 9.0, 1, 0).to(torch.int32)
    sem[n_g:n_g + n_w] = 2
    band = torch.div(clutter[:, 0], 4, rounding_mode="floor").to(
        torch.int64)
    sem[n_g + n_w:] = torch.where(band % 2 == 0, 5, 3).to(torch.int32)
    k = (int(cfg["sh_degree"]) + 1) ** 2
    return dict(xyz=pts, scales=scales, quats=_normal(g, (n, 4), device),
                opacity=u(0.3, 0.95, n), colors=u(0, 1, n, 3),
                features_rest=0.05 * _normal(g, (n, k - 1, 3), device),
                semantics=sem)


def street_cameras(cfg: dict, device) -> list:
    """The identity-pose camera and ``n_views - 1`` copies stepped
    ``view_step`` scene units along +z: (w2c [4, 4], K [3, 3]) pairs."""
    w, h, f = int(cfg["width"]), int(cfg["height"]), float(cfg["focal"])
    K = torch.tensor([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]],
                     dtype=torch.float32, device=device)
    cams = []
    for i in range(int(cfg["n_views"])):
        w2c = torch.eye(4, device=device)
        w2c[2, 3] = -float(cfg["view_step"]) * i
        cams.append((w2c, K))
    return cams


def street_raw_state(arrays: dict, cfg: dict) -> dict:
    """The street as raw (pre-activation) state arrays, every row alive:
    the layout both the program's ``SurfelState`` and the reference's are
    built from."""
    n = arrays["xyz"].shape[0]
    dev = arrays["xyz"].device
    op = arrays["opacity"]
    z = torch.zeros(n, device=dev)
    return dict(
        xyz=arrays["xyz"],
        features_dc=raster.rgb_to_sh(arrays["colors"])[:, None, :],
        features_rest=arrays["features_rest"],
        scaling=torch.log(arrays["scales"]), rotation=arrays["quats"],
        opacity=torch.log(op / (1.0 - op))[:, None],
        semantics=arrays["semantics"],
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        max_radii2d=z.clone(), grad_accum=z.clone(), denom=z.clone(),
        spatial_scale=torch.tensor(float(cfg["spatial_scale"]),
                                   device=dev),
        sh_degree=int(cfg["sh_degree"]))


# ---------------------------------------------------------------- targets


@torch.no_grad()
def render_targets(arrays: dict, cams: list, width: int, height: int, bg,
                   capacity: int, colors_fn=None):
    """Targets of each camera from activated surfel arrays (``xyz``,
    ``scales``, ``quats``, ``opacity``, ``colors``, ``semantics``), by the
    reference rasterizer: the colour render on ``bg`` clamped to [0, 1]
    and the argmax of the one-hot classes blended in the same pass, the
    sky class where nothing covers a pixel. ``colors_fn(w2c)``, when
    given, gives the view's colours (an SH decode). Returns host (images,
    labels) lists: the program uploads its targets from the host."""
    onehot = F.one_hot(arrays["semantics"].long(), NUM_CLASSES).float()
    sky = F.one_hot(torch.tensor(SKY_CLASS), NUM_CLASSES).float().to(
        onehot.device)
    settings = raster.RasterizeSettings(width=width, height=height)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=onehot.device)
    images, labels = [], []
    for w2c, K in cams:
        colors = arrays["colors"] if colors_fn is None else colors_fn(w2c)
        out = raster.rasterize(arrays["xyz"], arrays["scales"],
                               arrays["quats"], arrays["opacity"],
                               colors, w2c, K, settings, bg=bg,
                               duplicate_capacity=capacity,
                               extra_payload=onehot)
        if bool(out.overflow):
            raise RuntimeError("a target render overflowed its capacity")
        prob = out.extra + sky * (1.0 - out.alpha)[..., None]
        images.append(out.color.clamp(0.0, 1.0).cpu().numpy())
        labels.append(prob.argmax(-1).to(torch.int32).cpu().numpy())
    return images, labels


@torch.no_grad()
def stream_capacity(arrays: dict, cams: list, width: int, height: int,
                    headroom: float) -> int:
    """An overflow-free duplicate capacity for activated surfel arrays
    over ``cams``: the reference binning's largest demand × ``headroom``,
    chunk-aligned."""
    settings = raster.RasterizeSettings(width=width, height=height)
    demand = 0
    for w2c, K in cams:
        b = raster.bin_for_camera(arrays["xyz"], arrays["scales"],
                                  raster.normalized_quats(arrays["quats"]),
                                  arrays["opacity"], w2c, K, settings,
                                  duplicate_capacity=raster.S_CHUNK)
        demand = max(demand, int(b.demand))
    cap = int(demand * headroom) + raster.S_CHUNK
    return -(-cap // raster.S_CHUNK) * raster.S_CHUNK


def activated(raw: dict, opacity_boost: float = 0.0) -> dict:
    """Activated arrays (scales, unit quaternions, opacity with the dead
    rows at 0 and the logits raised by ``opacity_boost``, colours from the
    SH DC term) of raw state arrays."""
    op = torch.sigmoid(raw["opacity"][:, 0] + opacity_boost)
    return dict(xyz=raw["xyz"], scales=torch.exp(raw["scaling"]),
                quats=raster.normalized_quats(raw["rotation"]),
                opacity=torch.where(raw["alive"], op, torch.zeros_like(op)),
                colors=(raw["features_dc"][:, 0] * raster.C0 + 0.5).clamp(
                    min=0.0),
                semantics=raw["semantics"])


def sh_colors(raw: dict):
    """``colors_fn`` for ``render_targets``: each view's colours by the
    SH decode of raw state arrays at their full degree, as the program's
    render takes them."""
    feats = torch.cat([raw["features_dc"], raw["features_rest"]], dim=1)

    def colors(w2c):
        center = torch.linalg.inv(w2c)[:3, 3]
        d = raw["xyz"] - center[None, :]
        d = d / torch.sqrt(torch.clamp((d * d).sum(-1, keepdim=True),
                                       min=1e-12))
        return torch.clamp(raster.eval_sh(raw["sh_degree"], feats, d) + 0.5,
                           min=0.0)
    return colors


# -------------------------------------------------------------------- sky


def sky_arrays(seed: int, device, num_levels=16, features_per_level=2,
               log2_size=16, width=64, depth=3, sh_bands=3) -> dict:
    """The sky's weights from the seed, in the port's ``init_sky``
    distributions: hash tables ~ U(−1e-4, 1e-4), weights ~ N(0, 2/fan_in),
    zero biases."""
    g = generator(seed + 7919, device)
    tables = _uniform(g, -1e-4, 1e-4,
                      (num_levels, 2 ** log2_size, features_per_level),
                      device)
    in_dim = (sh_bands + 1) ** 2 + num_levels * features_per_level + 63
    dims = [in_dim] + [width] * depth + [3]
    ws = tuple(_normal(g, (dims[i], dims[i + 1]), device)
               * (2.0 / dims[i]) ** 0.5 for i in range(len(dims) - 1))
    bs = tuple(torch.zeros(dims[i + 1], device=device)
               for i in range(len(dims) - 1))
    return dict(hash_tables=tables, mlp_w=ws, mlp_b=bs,
                num_levels=num_levels, base_res=16, growth=2.0,
                sh_bands=sh_bands)
