"""Pandaset reader (counterpart of ``streetunveiler_tpu/scene/readers/
pandaset.py``, the reference's ``scene/dataset_readers/pandaset.py``).

Parses the Pandaset layout on the host, without the devkit:

    <path>/<seq>/camera/<cam>/poses.json, intrinsics.json, 00.jpg ...
    <path>/<seq>/lidar/00.pkl.gz        (a pickled table with x, y, z)
    <colmap_path>/input_masks/<idx>.npz

Poses are camera to world, a quaternion dict (w, x, y, z) and a position
dict. A LiDAR frame is indexed by column (``df["x"]``), so a pickled dict
of arrays reads as well as the published files, which are pickled pandas
DataFrames: unpickling those needs pandas, which this package does not
depend on. The cloud is coloured and voxel-downsampled on ``device``.
"""

from __future__ import annotations

import gzip
import os
import pickle

import numpy as np

from ..colmap import qvec2rotmat
from .basic import CameraInfo
from .driving import (assemble_driving_scene, load_semantic_npz,
                      read_json, read_rgb)

PANDASET_CAMERAS = ["front_camera", "front_left_camera",
                    "front_right_camera"]


def _pose_to_c2w(pose):
    q = pose["heading"]
    p = pose["position"]
    R = qvec2rotmat(np.array([q["w"], q["x"], q["y"], q["z"]]))
    c2w = np.eye(4)
    c2w[:3, :3] = R
    c2w[:3, 3] = (p["x"], p["y"], p["z"])
    return c2w


def _load_lidar_frame(path):
    with gzip.open(path, "rb") as f:
        df = pickle.load(f)
    return np.stack([np.asarray(df["x"]), np.asarray(df["y"]),
                     np.asarray(df["z"])], axis=1).astype(np.float32)


def read_pandaset_info(path: str, sequence: str, colmap_path: str = "",
                       start_frame: int = 0, end_frame: int | None = None,
                       cameras=PANDASET_CAMERAS, voxel_size: float = 0.15,
                       lidar_stride: int = 1, device="cuda"):
    seq_dir = os.path.join(path, sequence)
    cam_infos = []
    n_frames = None
    for rank, cam in enumerate(cameras):
        cdir = os.path.join(seq_dir, "camera", cam)
        poses = read_json(os.path.join(cdir, "poses.json"))
        intr = read_json(os.path.join(cdir, "intrinsics.json"))
        K = np.array([[intr["fx"], 0, intr["cx"]],
                      [0, intr["fy"], intr["cy"]],
                      [0, 0, 1]], np.float32)
        end = end_frame if end_frame is not None else len(poses)
        ids = list(range(start_frame, min(end, len(poses))))
        n_frames = len(ids)
        for fi, frame in enumerate(ids):
            c2w = _pose_to_c2w(poses[frame])
            w2c = np.linalg.inv(c2w)
            img_path = os.path.join(cdir, f"{frame:02d}.jpg")
            image = None
            width, height = 1920, 1080
            if os.path.exists(img_path):
                image, width, height = read_rgb(img_path)
            mask_idx = fi + rank * n_frames
            sem = load_semantic_npz(os.path.join(
                colmap_path, "input_masks", f"{mask_idx:05d}.npz")) \
                if colmap_path else None
            cam_infos.append(CameraInfo(
                uid=mask_idx, R=w2c[:3, :3].T, T=w2c[:3, 3],
                K=K, width=width, height=height, image_path=img_path,
                image_name=f"{cam}_{frame:02d}", image=image,
                semantics=sem))

    lidar_world = []
    ldir = os.path.join(seq_dir, "lidar")
    if os.path.isdir(ldir):
        files = sorted(f for f in os.listdir(ldir) if f.endswith(".pkl.gz"))
        end = end_frame if end_frame is not None else len(files)
        for frame in range(start_frame, min(end, len(files)), lidar_stride):
            lidar_world.append(_load_lidar_frame(
                os.path.join(ldir, files[frame])))
    lidar = (np.concatenate(lidar_world) if lidar_world
             else np.zeros((0, 3), np.float32))

    frame_dict = {"front_start": 0, "front_end": n_frames or 0}
    return assemble_driving_scene(cam_infos, lidar, colmap_path,
                                  voxel_size=voxel_size,
                                  camera_frame_dict=frame_dict,
                                  device=device)
