"""Shared driving-log scene assembly (counterpart of ``streetunveiler_tpu/
scene/readers/driving.py``).

Every driving reader (Waymo, Pandaset, KITTI, nuScenes) reduces to the
same steps:

1. per-frame cameras (pose, intrinsics, image, semantic .npz mask), and
2. LiDAR sweeps in world coordinates, both parsed on the host;
3. the cloud capped at ``max_points`` (a seeded choice on the host, the
   same points as the JAX package picks);
4. its points coloured and labelled by projecting them into the frames,
   on the card (``projection.colorize_points_from_frames``);
5. a voxel downsample with a semantic majority vote, on the card
   (``utils.pcd.voxel_down_sample``);
6. optionally a COLMAP model aligned into the dataset frame by a
   similarity over the camera centres (``ops.umeyama``), its labelled
   sparse points added;
7. a ``SceneInfo`` (numpy arrays) with the front camera's frame range.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from ...ops.umeyama import apply_similarity, umeyama
from ...utils.pcd import SemanticPointCloud, voxel_down_sample
from ...utils.semantics import cityscapes_to_concerned
from ..colmap import load_colmap_model, qvec2rotmat
from .basic import CameraInfo, PointCloud, SceneInfo, nerf_normalization
from .projection import colorize_points_from_frames


def load_semantic_npz(path: str):
    """A cityscapes train-id mask (``np.savez`` of one array) as concerned
    ids, or None when the file is absent."""
    if not os.path.exists(path):
        return None
    with np.load(path) as d:
        return cityscapes_to_concerned(d["arr_0"]).astype(np.int32)


def read_rgb(path: str):
    """(image [H, W, 3] float32 in [0, 1], width, height) of an image
    file."""
    from PIL import Image
    with Image.open(path) as pil:
        width, height = pil.size
        return (np.asarray(pil.convert("RGB"), np.float32) / 255.0, width,
                height)


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def cap_points(points, max_points: int) -> np.ndarray:
    """The cloud as float32, at most ``max_points`` of it, chosen without
    replacement by ``np.random.default_rng(0)`` (the JAX package's
    choice)."""
    pts = np.asarray(points, np.float32)
    if pts.shape[0] > max_points:
        sel = np.random.default_rng(0).choice(pts.shape[0], max_points,
                                              replace=False)
        pts = pts[sel]
    return pts


def camera_frames(cam_infos: Sequence[CameraInfo]) -> list:
    """The projection frames (w2c, K, image, semantic) of the cameras that
    hold an image."""
    frames = []
    for ci in cam_infos:
        if ci.image is None:
            continue
        w2c = np.eye(4)
        w2c[:3, :3] = ci.R.T
        w2c[:3, 3] = ci.T
        frames.append(dict(w2c=w2c, K=ci.K, image=ci.image,
                           semantic=ci.semantics))
    return frames


def labelled_cloud(pts, frames, device="cuda") -> SemanticPointCloud:
    """The points that some frame sees with a certain label, with that
    frame's colour and label (on ``device``)."""
    colors, sems, seen = colorize_points_from_frames(pts, frames,
                                                     device=device)
    keep = seen & (sems >= 0)
    return SemanticPointCloud(points=pts[keep], colors=colors[keep],
                              semantics=sems[keep])


def assemble_driving_scene(cam_infos: Sequence[CameraInfo],
                           lidar_points_world: np.ndarray,
                           colmap_path: str = "",
                           voxel_size: float = 0.15,
                           camera_frame_dict: Optional[dict] = None,
                           max_points: int = 5_000_000,
                           device="cuda") -> SceneInfo:
    """Steps 3-7 given cameras (with loaded images and semantics) and the
    LiDAR cloud; colorization and the voxel downsample run on
    ``device``."""
    pts = cap_points(lidar_points_world, max_points)
    frames = camera_frames(cam_infos)
    pc = voxel_down_sample(labelled_cloud(pts, frames, device=device),
                           voxel_size, device=device)

    # optional COLMAP sparse points aligned into the dataset frame
    if colmap_path and os.path.isdir(colmap_path):
        pc = _merge_colmap_points(pc, cam_infos, colmap_path, frames,
                                  device=device)

    cloud = PointCloud(points=pc.points, colors=pc.colors,
                       semantics=pc.semantics)
    return SceneInfo(point_cloud=cloud, reference_cloud=cloud,
                     train_cameras=list(cam_infos), test_cameras=[],
                     nerf_normalization=nerf_normalization(cam_infos),
                     camera_frame_dict=camera_frame_dict)


def _merge_colmap_points(pc, cam_infos, colmap_path, frames, device="cuda"):
    """Align the COLMAP model to the dataset frame by camera centres and
    add its sparse points, labelled by projection (the reference's
    ``readWaymoInfo``: Superpose3D and the sparse labelling)."""
    sparse = os.path.join(colmap_path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(colmap_path, "sparse")
    if not os.path.isdir(sparse):
        return pc
    _, images, (xyz, _rgb, _err) = load_colmap_model(sparse)

    # COLMAP images matched to dataset cameras by name
    col_centers = []
    data_centers = []
    by_name = {ci.image_name: ci for ci in cam_infos}
    for _, im in sorted(images.items()):
        ci = by_name.get(im.name) or by_name.get(os.path.splitext(im.name)[0])
        if ci is None:
            continue
        R = qvec2rotmat(im.qvec)
        col_centers.append(-R.T @ im.tvec)
        w2c = np.eye(4)
        w2c[:3, :3] = ci.R.T
        w2c[:3, 3] = ci.T
        data_centers.append(np.linalg.inv(w2c)[:3, 3])
    if len(col_centers) < 3:
        return pc
    _, R, t, c = umeyama(np.asarray(data_centers), np.asarray(col_centers))
    xyz_d = apply_similarity(xyz, R, t, c).astype(np.float32)
    return pc.concat(labelled_cloud(xyz_d, frames, device=device))
