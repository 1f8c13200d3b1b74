"""Procedural synthetic street scene (counterpart of
``streetunveiler_tpu/scene/readers/synthetic.py``): a street-like
ground-truth surfel soup (ground, facades, box "vehicles", foliage, with
semantic labels), a camera path, and GT images rendered by the port's own
rasterizer. The same seed gives the JAX package's points, cameras and
surfel orientations (numpy draws in the same order).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...device import resolve_device
from ...ops.knn import mean_sq_dist_to_3nn
from ...ops.rasterizer import RasterizeSettings, rasterize, rasterize_oracle
from ...utils.semantics import CONCERNED_IND, NUM_CONCERNED
from .basic import CameraInfo, PointCloud, SceneInfo, nerf_normalization


def _street_points(n, rng):
    """Returns (points, colors, semantics, normals) with street-scene
    structure. ``normals`` carry each point's surface orientation (NaN
    rows = unstructured, e.g. foliage) — real street surfaces are
    locally planar, so GT surfels align with them. Fully random surfel
    orientations would make the GT a high-frequency splat-noise field
    no reconstruction can fit."""
    n_g = n // 3
    n_w = n // 3
    n_v = n // 6
    n_veg = n - n_g - n_w - n_v

    ground = np.stack([rng.uniform(-8, 8, n_g), np.full(n_g, 1.6),
                       rng.uniform(2, 40, n_g)], 1)
    g_col = np.tile([[0.42, 0.42, 0.45]], (n_g, 1)) + rng.normal(0, 0.02, (n_g, 3))
    g_sem = np.full(n_g, CONCERNED_IND["road"])
    g_nrm = np.tile([[0.0, 1.0, 0.0]], (n_g, 1))

    side = np.where(rng.random(n_w) < 0.5, -6.0, 6.0)
    walls = np.stack([side + rng.normal(0, 0.1, n_w),
                      rng.uniform(-4, 1.6, n_w), rng.uniform(2, 40, n_w)], 1)
    w_col = np.tile([[0.6, 0.55, 0.5]], (n_w, 1)) + rng.normal(0, 0.05, (n_w, 3))
    w_sem = np.full(n_w, CONCERNED_IND["building"])
    w_nrm = np.stack([np.sign(side), np.zeros(n_w), np.zeros(n_w)], 1)

    # box "vehicles" parked on the right (shell normals point outward)
    centers = np.stack([np.full(n_v, 3.5), np.full(n_v, 1.1),
                        rng.uniform(6, 30, n_v)], 1)
    veh = centers + rng.normal(0, 0.6, (n_v, 3)) * [0.8, 0.35, 1.5]
    v_col = np.tile([[0.7, 0.15, 0.12]], (n_v, 1)) + rng.normal(0, 0.04, (n_v, 3))
    v_sem = np.full(n_v, CONCERNED_IND["vehicle"])
    v_nrm = veh - centers
    v_nrm /= np.maximum(np.linalg.norm(v_nrm, axis=1, keepdims=True), 1e-6)

    veg = np.stack([np.where(rng.random(n_veg) < 0.5, -5.0, 5.0)
                    + rng.normal(0, 0.4, n_veg),
                    rng.uniform(-2.5, 0.0, n_veg),
                    rng.uniform(4, 38, n_veg)], 1)
    veg_col = np.tile([[0.2, 0.45, 0.15]], (n_veg, 1)) + rng.normal(0, 0.05, (n_veg, 3))
    veg_sem = np.full(n_veg, CONCERNED_IND["vegetation"])
    veg_nrm = np.full((n_veg, 3), np.nan)    # unstructured foliage

    pts = np.concatenate([ground, walls, veh, veg]).astype(np.float32)
    cols = np.clip(np.concatenate([g_col, w_col, v_col, veg_col]), 0, 1)
    sems = np.concatenate([g_sem, w_sem, v_sem, veg_sem]).astype(np.int32)
    nrms = np.concatenate([g_nrm, w_nrm, v_nrm, veg_nrm]).astype(np.float32)
    return pts, cols.astype(np.float32), sems, nrms


def make_synthetic_street(n_points: int = 4000, n_cameras: int = 12,
                          width: int = 160, height: int = 112,
                          focal: float = 110.0, seed: int = 0,
                          render_gt: bool = True,
                          gt_opacity: float = 0.85,
                          eval_split: bool = False, llffhold: int = 8,
                          bg_color: tuple = (0.25, 0.45, 0.7),
                          device="cuda"):
    """Build SceneInfo; GT images come from a render of a hidden GT surfel
    set (consistent multi-view supervision) on ``device``: the untiled
    oracle on the CPU, the tiled ``rasterize`` on a card.

    ``eval_split`` holds out every ``llffhold``-th camera as a test view
    (the reference's COLMAP-reader convention,
    scene/dataset_readers/colmap.py ``eval``/``llffhold``).

    ``bg_color`` is the sky background GT composites on; it is returned
    in ``SceneInfo.background`` and training and render must composite
    on it (the CLI does): on another background the ~25% empty-sky
    pixels are unfittable."""
    rng = np.random.default_rng(seed)
    pts, cols, sems, nrms = _street_points(n_points, rng)
    K = np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]],
                 np.float32)

    cam_infos = []
    # drive-forward spacing: 1.2 m, compressed so the path never overruns
    # the scene content (z <= 40; a camera past ~29 m sees mostly empty
    # sky and degenerates the held-out metric)
    spacing = min(1.2, 28.8 / max(n_cameras - 1, 1))
    for i in range(n_cameras):
        # drive forward along +z with slight lateral sway
        t_world = np.array([0.35 * np.sin(i * 0.7), 0.0, i * spacing],
                           np.float64)
        R = np.eye(3)
        T = -R.T @ t_world               # w2c translation for identity R
        cam_infos.append(CameraInfo(
            uid=i, R=R, T=T, K=K, width=width, height=height,
            image_name=f"synth_{i:03d}"))

    images = None
    if render_gt:
        images = _render_gt_images(pts, cols, sems, cam_infos, gt_opacity,
                                   rng, bg_color, normals=nrms,
                                   device=device)
        cam_infos = [c._replace(image=img, semantics=sem)
                     for c, (img, sem) in zip(cam_infos, images)]

    pc = PointCloud(points=pts, colors=cols, semantics=sems)
    train_infos, test_infos = cam_infos, []
    if eval_split:
        # the reference's LLFF convention holds out i % llffhold == 0
        # (scene/dataset_readers/colmap.py:89-90), same as this repo's
        # colmap reader
        test_infos = [c for i, c in enumerate(cam_infos)
                      if i % llffhold == 0]
        train_infos = [c for i, c in enumerate(cam_infos)
                       if i % llffhold != 0]
    frame_dict = {"front_start": 0, "front_end": len(train_infos)}
    return SceneInfo(point_cloud=pc, reference_cloud=pc,
                     train_cameras=train_infos, test_cameras=test_infos,
                     nerf_normalization=nerf_normalization(train_infos),
                     camera_frame_dict=frame_dict,
                     background=tuple(bg_color))


def _normals_to_quats(normals, rng, noise: float = 0.08):
    """Quaternions whose rotation maps local +z (the surfel normal axis,
    models/gaussians densify convention: tangent plane = R[:, :2]) onto
    each given normal, plus a small random in-plane/out-of-plane wobble.
    NaN normal rows get fully random quaternions (foliage)."""
    n = normals.shape[0]
    z = np.array([0.0, 0.0, 1.0])
    nn = np.where(np.isfinite(normals), normals, z)
    nn = nn / np.maximum(np.linalg.norm(nn, axis=1, keepdims=True), 1e-6)
    # shortest-arc quaternion z → nn: q = (1 + z·n, z × n) normalized
    w = 1.0 + nn @ z
    xyz = np.cross(np.tile(z, (n, 1)), nn)
    # antipodal case (n ≈ −z): any 180° flip around x works
    flip = w < 1e-6
    w = np.where(flip, 0.0, w)
    xyz[flip] = [1.0, 0.0, 0.0]
    q = np.concatenate([w[:, None], xyz], 1)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q = q + rng.normal(0, noise, (n, 4))
    rnd = rng.normal(size=(n, 4))
    q = np.where(np.isfinite(normals[:, :1]), q, rnd)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


@torch.no_grad()
def _render_gt_images(pts, cols, sems, cam_infos, gt_opacity, rng,
                      bg_color=(0.25, 0.45, 0.7), normals=None,
                      device="cuda"):
    """GT colour images and semantic label maps, as numpy, per camera.

    On the CPU: ``rasterize_oracle`` for colour, and two oracle passes of
    the one-hot classes for the semantic argmax. On a card: one tiled
    ``rasterize`` with the one-hot classes as extra payload, at a
    demand-sized duplicate capacity (GT must never be truncated)."""
    from ...ops.rasterizer.api import default_duplicate_capacity
    from ...renderer import round_capacity

    dev = resolve_device(device)
    n = pts.shape[0]
    dist = np.sqrt(np.maximum(mean_sq_dist_to_3nn(pts), 1e-7))
    # surface-coverage scale with a percentile clamp: unclamped 3NN
    # distances give isolated near-field points meter-scale splats
    dist = np.minimum(dist, 3.0 * np.median(dist))
    scales = np.repeat(dist[:, None] * 1.3, 2, 1).astype(np.float32)
    if normals is not None:
        quats = _normals_to_quats(normals, rng)
    else:
        quats = rng.normal(size=(n, 4)).astype(np.float32)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    geo = (t(pts), t(scales), t(quats), torch.full((n,), gt_opacity,
                                                  device=dev))
    colors = t(cols)
    bg = torch.tensor(bg_color, dtype=torch.float32, device=dev)
    onehot = F.one_hot(torch.as_tensor(sems, device=dev).long(),
                       NUM_CONCERNED).to(torch.float32)
    sky = F.one_hot(torch.tensor(CONCERNED_IND["sky"], device=dev),
                    NUM_CONCERNED).to(torch.float32)
    cap = None

    out = []
    for ci in cam_infos:
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = ci.R.T
        w2c[:3, 3] = ci.T
        st = RasterizeSettings(width=ci.width, height=ci.height,
                               znear=0.2, zfar=100.0)
        cam = (t(w2c), t(ci.K), st)
        if dev.type == "cpu":
            res = rasterize_oracle(*geo, colors, *cam, bg=bg,
                                   chunk_surfels=256, pixel_block=4096)
            img = res.color
            # per-class alpha from one-hot renders, three classes a pass
            prob = torch.cat([rasterize_oracle(
                *geo, onehot[:, c0:c0 + 3], *cam, chunk_surfels=256,
                pixel_block=4096).color for c0 in range(0, NUM_CONCERNED, 3)],
                dim=-1)
        else:
            cap = cap or default_duplicate_capacity(n, st.width, st.height)
            res = rasterize(*geo, colors, *cam, bg=bg,
                            duplicate_capacity=cap, extra_payload=onehot)
            if bool(res.overflow):
                cap = round_capacity(int(res.demand), headroom=1.3)
                res = rasterize(*geo, colors, *cam, bg=bg,
                                duplicate_capacity=cap, extra_payload=onehot)
                if bool(res.overflow):
                    raise RuntimeError("GT render overflowed after resize")
            img = res.color
            prob = res.extra
        # empty pixels read as sky
        empty = torch.sum(prob, dim=-1, keepdim=True) < 0.2
        prob = torch.where(empty, sky, prob)
        out.append((torch.clamp(img, 0.0, 1.0).cpu().numpy()
                    .astype(np.float32),
                    torch.argmax(prob, dim=-1).to(torch.int32).cpu()
                    .numpy()))
    return out
