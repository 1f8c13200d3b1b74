"""The street scene the measurement tools and ``chip_smoke.py`` run on.

``build_scene`` is the scene of ``bench.py:22-53`` (ground carpet, facade
walls, clutter; splats projecting to ~4-10 px at f = 1000), from a numpy
seed. ``street_stream`` bins it at 1920x1280 and gathers the blend's
records as the main path does: the photometric step's stream (nq 6, no
gated chains) or the late step's (nq 12 with the one-hot semantics, and
G = 5 gated chains for every class but sky). ``probe_inputs`` is the
probes' setup: the scene with its colours as the payload, binned and
gathered once. ``dense_streams`` is the dense-occlusion stack the blend
kernels' gated chains are checked on.
"""

from __future__ import annotations

import numpy as np
import torch

W, H, FOCAL, N_SURFELS = 1920, 1280, 1000.0, 300_000
# the miniature the tools run on the CPU: the same field of view at
# 128x96, with the splats scaled by 1920/128 so that they project to as
# many pixels as at full width
MINI = dict(n=600, width=128, height=96, focal=FOCAL * 128 / W,
            scale=W / 128)


def build_scene(n, seed=0):
    """The street scene of ``bench.py``: ground carpet + facade walls +
    clutter, splats projecting to ~4-10 px at f=1000. Returns numpy
    (points, scales, quats, opacities, colors, semantic ids)."""
    rng = np.random.default_rng(seed)
    n_g, n_w = n // 2, n // 3
    n_c = n - n_g - n_w
    ground = np.stack([rng.uniform(-30, 30, n_g), np.full(n_g, 2.0),
                       rng.uniform(2, 80, n_g)], 1)
    walls = np.stack([np.where(rng.random(n_w) < 0.5, -12.0, 12.0)
                      + rng.normal(0, 0.3, n_w),
                      rng.uniform(-8, 2, n_w), rng.uniform(2, 80, n_w)], 1)
    clutter = np.stack([rng.uniform(-10, 10, n_c), rng.uniform(-3, 2, n_c),
                        rng.uniform(3, 60, n_c)], 1)
    pts = np.concatenate([ground, walls, clutter]).astype(np.float32)
    depths = pts[:, 2]
    scales = (rng.uniform(3, 8, (n, 1)) * depths[:, None] / 1000.0
              ).astype(np.float32).repeat(2, 1)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, n).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    sem = np.empty(n, np.int32)
    sem[:n_g] = np.where(np.abs(ground[:, 0]) > 9.0, 1, 0)
    sem[n_g:n_g + n_w] = 2
    sem[n_g + n_w:] = np.where((clutter[:, 0] // 4).astype(int) % 2 == 0,
                               5, 3)
    return pts, scales, quats, opac, cols, sem


def street_state(n=N_SURFELS, seed=0, device="cuda", scale=1.0):
    """SurfelState of the street scene, SH degree 3: DC from the colors,
    the rest ~ N(0, 0.05) from the seed; the splats' scales times
    ``scale``."""
    from streetunveiler_torch.convert import state_from_arrays
    from streetunveiler_torch.ops.sh import rgb_to_sh
    pts, scales, quats, opac, cols, sem = build_scene(n, seed)
    scales = scales * np.float32(scale)
    rng = np.random.default_rng(seed + 1)
    z = np.zeros(n, np.float32)
    return state_from_arrays(dict(
        xyz=pts, features_dc=rgb_to_sh(cols)[:, None, :],
        features_rest=rng.normal(0, 0.05, (n, 15, 3)).astype(np.float32),
        scaling=np.log(scales), rotation=quats,
        opacity=np.log(opac / (1.0 - opac))[:, None],
        semantics=sem, alive=np.ones(n, bool), max_radii2d=z, grad_accum=z,
        denom=z, spatial_scale=np.float32(30.0)), device=device)


def street_camera(device="cuda", width=W, height=H, focal=FOCAL):
    """The identity-pose camera the street scene is viewed from."""
    from streetunveiler_torch.scene.cameras import Camera
    return Camera(w2c=torch.eye(4, device=device),
                  K=torch.tensor([[focal, 0, width / 2],
                                  [0, focal, height / 2], [0, 0, 1]],
                                 device=device),
                  width=width, height=height)


def street_stream(state, camera, late=False, device="cuda"):
    """The blend's inputs for ``state`` seen from ``camera``, binned and
    gathered as ``renderer.render`` does: (recT, tile_offsets, tiles_x,
    tiles_y, settings, nq, n_gates). ``late``: the late step's records
    (one-hot semantics as extra payload, the class bitmask of every class
    but sky as the gate row)."""
    import torch.nn.functional as F
    from streetunveiler_torch import renderer
    from streetunveiler_torch.ops.rasterizer import kernel, tiles
    from streetunveiler_torch.ops.rasterizer.api import (_gather_records,
                                                         encode_extra)
    from streetunveiler_torch.ops.rasterizer.preprocess import \
        preprocess_surfels
    from streetunveiler_torch.train.step import DIST_CLASSES
    cap = renderer.measure_duplicate_capacity([camera], state,
                                              device=device)
    settings = renderer._settings_for(camera, 1.0)
    with torch.no_grad():
        sur = preprocess_surfels(
            state.params.xyz, state.get_scaling(), state.get_rotation(),
            state.get_opacity()[:, 0], renderer.surfel_colors(state, camera, 3),
            camera.w2c, camera.K, settings)
        b = tiles.bin_surfels_stream(sur.center2d, sur.ext, sur.depth,
                                     sur.valid, camera.width, camera.height,
                                     kernel.TILE_W, kernel.TILE_H, cap,
                                     cull=sur.cull)
        extra, gates = None, None
        if late:
            extra = F.one_hot(state.semantics.long(), 6).to(torch.float32)
            gates = torch.stack([renderer.semantic_class_mask(state, 1 << c)
                                 for c in DIST_CLASSES], dim=1)
        pack_extra, n_gates = encode_extra(extra, gates)
        recT = _gather_records(kernel.pack_geometry_T(sur, state.capacity,
                                                      pack_extra),
                               b.sorted_surfel)
    nq = kernel.NQ + (0 if extra is None else extra.shape[1])
    return recT, b.tile_offsets, b.tiles_x, b.tiles_y, settings, nq, n_gates


def probe_inputs(n=N_SURFELS, width=W, height=H, focal=FOCAL, scale=1.0,
                 device="cuda"):
    """The setup of ``tools/probe_tax.py:build`` and
    ``tools/probe_compose4.py:main``: the street's surfels (their colours
    as the payload, the splats' scales times ``scale``) preprocessed from
    the identity pose, binned at the default duplicate capacity with at
    most 64 tiles per surfel, and their records gathered. Returns a
    namespace with the preprocess outputs the binning reads (``pre``:
    center2d, ext, depth, valid, cull), ``packT0``, ``binning``, ``recT0``,
    ``settings``, ``cap``, ``width``, ``height``, ``tiles_x``, ``tiles_y``.
    ``bin_stream(ctx)`` bins it again."""
    from types import SimpleNamespace
    from streetunveiler_torch.ops.rasterizer import RasterizeSettings, kernel
    from streetunveiler_torch.ops.rasterizer.api import (
        _gather_records, default_duplicate_capacity)
    from streetunveiler_torch.ops.rasterizer.preprocess import \
        preprocess_surfels
    pts, scales, quats, opac, cols, _ = build_scene(n)
    scales = scales * np.float32(scale)
    args = [torch.as_tensor(a, device=device)
            for a in (pts, scales, quats, opac, cols)]
    K = torch.tensor([[focal, 0, width / 2], [0, focal, height / 2],
                      [0, 0, 1]], dtype=torch.float32, device=device)
    settings = RasterizeSettings(width=width, height=height, znear=0.2,
                                 zfar=100.0)
    with torch.no_grad():
        sur = preprocess_surfels(*args, torch.eye(4, device=device), K,
                                 settings)
        ctx = SimpleNamespace(
            pre=(sur.center2d, sur.ext, sur.depth, sur.valid, sur.cull),
            packT0=kernel.pack_geometry_T(sur, n), settings=settings,
            cap=default_duplicate_capacity(n, width, height), width=width,
            height=height)
        ctx.binning = bin_stream(ctx)
        ctx.recT0 = _gather_records(ctx.packT0, ctx.binning.sorted_surfel)
    ctx.tiles_x, ctx.tiles_y = ctx.binning.tiles_x, ctx.binning.tiles_y
    return ctx


def bin_stream(ctx):
    """``tiles.bin_surfels_stream`` on ``probe_inputs``' surfels, as the
    probes call it (at most 64 tiles per surfel)."""
    from streetunveiler_torch.ops.rasterizer import kernel, tiles
    c2d, ext, depth, valid, cull = ctx.pre
    with torch.no_grad():
        return tiles.bin_surfels_stream(c2d, ext, depth, valid, ctx.width,
                                        ctx.height, kernel.TILE_W,
                                        kernel.TILE_H, ctx.cap, 64,
                                        cull=cull)


def dense_streams(device="cuda"):
    """A dense-occlusion stack: 1,500 mostly opaque surfels at 128×96
    whose nearest third is class 0 and the rest classes 1-4 at random, so
    that the other classes' gated chains outlive the main chain; binned as
    ``rasterize`` does. Returns {G: blend arguments (recT, tile_offsets,
    tiles_x, tiles_y, settings, nq, n_gates)} for the photometric records
    (G 0, nq 6) and the late ones (G 5, nq 12 with the one-hot classes)."""
    import torch.nn.functional as F
    from streetunveiler_torch.ops.rasterizer import (RasterizeSettings,
                                                     kernel, tiles)
    from streetunveiler_torch.ops.rasterizer.api import (
        _gather_records, default_duplicate_capacity, encode_extra)
    from streetunveiler_torch.ops.rasterizer.preprocess import \
        preprocess_surfels
    rng = np.random.default_rng(0)
    n, w, h, f = 1500, 128, 96, 110.0
    z = rng.uniform(2.0, 30.0, n)
    means = np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(-2, 2, n), z],
                     1)
    cls = np.where(z < np.quantile(z, 1 / 3), 0, rng.integers(1, 5, n))
    dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    args = [dev(means), dev(rng.uniform(0.2, 0.9, (n, 2))),
            dev(rng.normal(size=(n, 4))), dev(rng.uniform(0.5, 0.98, n)),
            dev(rng.uniform(0, 1, (n, 3)))]
    st = RasterizeSettings(width=w, height=h)
    K = dev([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    with torch.no_grad():
        sur = preprocess_surfels(*args, dev(np.eye(4)), K, st)
        b = tiles.bin_surfels_stream(sur.center2d, sur.ext, sur.depth,
                                     sur.valid, w, h, kernel.TILE_W,
                                     kernel.TILE_H,
                                     default_duplicate_capacity(n, w, h),
                                     cull=sur.cull)
        if bool(b.overflow):
            raise AssertionError("the dense stack overflowed its capacity")
        cls_t = torch.as_tensor(cls, device=device)
        out = {}
        for late in (False, True):
            extra = F.one_hot(cls_t, 6).float() if late else None
            gates = torch.stack([cls_t == g for g in range(5)], 1) if late \
                else None
            pack, n_gates = encode_extra(extra, gates)
            recT = _gather_records(kernel.pack_geometry_T(sur, n, pack),
                                   b.sorted_surfel)
            out[n_gates] = (recT, b.tile_offsets, b.tiles_x, b.tiles_y, st,
                            12 if late else 6, n_gates)
    return out
