"""Waymo reader (counterpart of ``streetunveiler_tpu/scene/readers/
waymo.py``, the reference's ``scene/dataset_readers/waymo.py``).

Reads the neuralsim-preprocessed layout the reference trains on:

    <path>/scenario.pt                       per-frame poses, intrinsics
    <path>/images/camera_<X>/00000000.jpg    (FRONT, FRONT_LEFT, FRONT_RIGHT)
    <path>/lidars/lidar_TOP/00000000.npz     rays_o, rays_d, ranges
    <colmap_path>/input_masks/<idx>.npz      cityscapes train-id masks
    <colmap_path>/sparse/0/                  COLMAP model (optional)

``scenario.pt`` is a torch pickle of plain dicts and arrays, read with
``torch.load`` on the CPU. ``read_waymo_inputs`` parses the files on the
host; ``read_waymo_info`` then colours and voxel-downsamples the LiDAR
cloud on ``device`` (``driving.assemble_driving_scene``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .basic import CameraInfo
from .driving import assemble_driving_scene, load_semantic_npz, read_rgb

WAYMO_CAMERAS = ["camera_FRONT", "camera_FRONT_LEFT", "camera_FRONT_RIGHT"]


def _load_scenario(path):
    return torch.load(os.path.join(path, "scenario.pt"),
                      map_location="cpu", weights_only=False)


def _arr(x):
    return np.asarray(x.detach().cpu().numpy()
                      if hasattr(x, "detach") else x)


def read_waymo_inputs(path: str, colmap_path: str = "",
                      start_frame: int = 0, end_frame: int | None = None,
                      cameras=WAYMO_CAMERAS, lidar_stride: int = 1):
    """The segment's files on the host: (camera infos with their images
    and semantics, the valid LiDAR returns in world coordinates [M, 3],
    the front camera's frame range)."""
    scenario = _load_scenario(path)
    observers = scenario["observers"]
    # tolerate partial rigs (e.g. front-only exports)
    cameras = [c for c in cameras if c in observers]

    n_total = len(_arr(observers[cameras[0]]["data"]["c2w"])) \
        if cameras else None
    end_frame = end_frame if end_frame is not None else n_total
    frame_ids = list(range(start_frame, min(end_frame, n_total)))
    n_frames = len(frame_ids)

    cam_infos = []
    for rank, cam in enumerate(cameras):
        data = observers[cam]["data"]
        c2ws = _arr(data["c2w"])
        intrs = _arr(data["intr"])
        hw = _arr(data["hw"]) if "hw" in data else None
        for fi, frame in enumerate(frame_ids):
            c2w = np.asarray(c2ws[frame], np.float64)
            K = np.asarray(intrs[frame], np.float64)[:3, :3]
            w2c = np.linalg.inv(c2w)
            img_path = os.path.join(path, "images", cam,
                                    f"{frame:08d}.jpg")
            image = None
            height, width = (int(hw[frame][0]), int(hw[frame][1])) \
                if hw is not None else (1280, 1920)
            if os.path.exists(img_path):
                image, width, height = read_rgb(img_path)
            mask_idx = fi + rank * n_frames
            sem = load_semantic_npz(os.path.join(
                colmap_path, "input_masks", f"{mask_idx:05d}.npz")) \
                if colmap_path else None
            cam_infos.append(CameraInfo(
                uid=mask_idx, R=w2c[:3, :3].T, T=w2c[:3, 3],
                K=K.astype(np.float32), width=width, height=height,
                image_path=img_path, image_name=f"{cam}_{frame:08d}",
                image=image, semantics=sem))

    lidar_world = []
    lidar_dir = os.path.join(path, "lidars", "lidar_TOP")
    if os.path.isdir(lidar_dir):
        for frame in frame_ids[::lidar_stride]:
            lp = os.path.join(lidar_dir, f"{frame:08d}.npz")
            if not os.path.exists(lp):
                continue
            with np.load(lp) as d:
                ranges = d["ranges"]
                valid = ranges > 0
                pts = (d["rays_o"][valid]
                       + d["rays_d"][valid] * ranges[valid][..., None])
            lidar_world.append(pts.reshape(-1, 3))
    lidar = (np.concatenate(lidar_world) if lidar_world
             else np.zeros((0, 3), np.float32))
    return cam_infos, lidar, {"front_start": 0, "front_end": n_frames}


def read_waymo_info(path: str, colmap_path: str = "",
                    start_frame: int = 0, end_frame: int | None = None,
                    cameras=WAYMO_CAMERAS, voxel_size: float = 0.15,
                    lidar_stride: int = 1, device="cuda"):
    cam_infos, lidar, frame_dict = read_waymo_inputs(
        path, colmap_path, start_frame, end_frame, cameras, lidar_stride)
    return assemble_driving_scene(cam_infos, lidar, colmap_path,
                                  voxel_size=voxel_size,
                                  camera_frame_dict=frame_dict,
                                  device=device)
