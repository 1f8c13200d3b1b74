"""Shared reader types (counterpart of ``streetunveiler_tpu/scene/readers/
basic.py``, the reference's ``scene/dataset_readers/basic_utils.py``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray          # transposed world→cam rotation (COLMAP readers')
    T: np.ndarray          # translation
    K: np.ndarray          # 3x3 intrinsics at full resolution
    width: int
    height: int
    image_path: str = ""
    image_name: str = ""
    semantic_path: str = ""
    image: Optional[np.ndarray] = None       # [H,W,3] float in [0,1]
    semantics: Optional[np.ndarray] = None   # [H,W] int concerned ids


class PointCloud(NamedTuple):
    points: np.ndarray      # [N,3]
    colors: np.ndarray      # [N,3] float in [0,1]
    semantics: np.ndarray   # [N] int32 concerned class ids


class SceneInfo(NamedTuple):
    point_cloud: PointCloud
    reference_cloud: Optional[PointCloud]
    train_cameras: list
    test_cameras: list
    nerf_normalization: dict
    ply_path: str = ""
    reference_ply_path: str = ""
    # per-frame ranges for the "front" camera (reference camera_frame_dict,
    # scene/dataset_readers/waymo.py:443-449)
    camera_frame_dict: Optional[dict] = None
    # the background color GT images were composited on, when known (the
    # synthetic reader's sky color). Training/render MUST composite on the
    # same background or empty-sky pixels become unfittable — a ~12-PSNR
    # ceiling at config-2 scale (the round-4 plateau's second half).
    background: Optional[tuple] = None


def nerf_normalization(cam_infos) -> dict:
    """Reference ``getNerfppNorm``: center of camera centers, radius 1.1×max
    distance; translate = −center."""
    centers = []
    for cam in cam_infos:
        w2c = np.eye(4)
        w2c[:3, :3] = cam.R.T
        w2c[:3, 3] = cam.T
        c2w = np.linalg.inv(w2c)
        centers.append(c2w[:3, 3])
    centers = np.stack(centers)
    center = centers.mean(axis=0)
    radius = 1.1 * float(np.linalg.norm(centers - center, axis=1).max())
    return {"translate": -center, "radius": max(radius, 1e-3)}
