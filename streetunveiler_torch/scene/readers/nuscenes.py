"""nuScenes reader (counterpart of ``streetunveiler_tpu/scene/readers/
nuscenes.py``, the reference's ``scene/dataset_readers/nuscenes.py``).

Parses the nuScenes metadata (plain JSON tables under ``<path>/v1.0-*/``)
and the float32 ``.pcd.bin`` LiDAR sweeps on the host, without the
devkit: a scene's sample chain through the front cameras and LIDAR_TOP,
by direct table joins. The cloud is coloured and voxel-downsampled on
``device``.
"""

from __future__ import annotations

import os

import numpy as np

from ..colmap import qvec2rotmat
from .basic import CameraInfo
from .driving import (assemble_driving_scene, load_semantic_npz,
                      read_json, read_rgb)

NUSCENES_CAMERAS = ["CAM_FRONT", "CAM_FRONT_LEFT", "CAM_FRONT_RIGHT"]


def _load_tables(meta_dir, names):
    return {n: {r["token"]: r for r in
                read_json(os.path.join(meta_dir, n + ".json"))}
            for n in names}


def _pose_mat(rec):
    T = np.eye(4)
    T[:3, :3] = qvec2rotmat(np.asarray(rec["rotation"]))
    T[:3, 3] = rec["translation"]
    return T


def read_nuscenes_info(path: str, scene_name: str,
                       version: str = "v1.0-mini", colmap_path: str = "",
                       start_frame: int = 0, end_frame: int | None = None,
                       cameras=NUSCENES_CAMERAS, voxel_size: float = 0.15,
                       lidar_stride: int = 1, device="cuda"):
    meta = os.path.join(path, version)
    t = _load_tables(meta, ["scene", "sample", "sample_data",
                            "calibrated_sensor", "ego_pose", "sensor"])
    scene = next(s for s in t["scene"].values()
                 if s["name"] == scene_name)

    # walk the sample chain
    samples = []
    tok = scene["first_sample_token"]
    while tok:
        s = t["sample"][tok]
        samples.append(s)
        tok = s["next"]
    end = end_frame if end_frame is not None else len(samples)
    samples = samples[start_frame:end]
    n_frames = len(samples)

    # index sample_data by (sample_token, channel), keyframes only
    sd_by = {}
    for sd in t["sample_data"].values():
        if not sd["is_key_frame"]:
            continue
        ch = t["sensor"][t["calibrated_sensor"][
            sd["calibrated_sensor_token"]]["sensor_token"]]["channel"]
        sd_by[(sd["sample_token"], ch)] = sd

    cam_infos = []
    for rank, cam in enumerate(cameras):
        for fi, s in enumerate(samples):
            sd = sd_by[(s["token"], cam)]
            cs = t["calibrated_sensor"][sd["calibrated_sensor_token"]]
            ego = t["ego_pose"][sd["ego_pose_token"]]
            c2w = _pose_mat(ego) @ _pose_mat(cs)
            w2c = np.linalg.inv(c2w)
            K = np.asarray(cs["camera_intrinsic"], np.float32)
            img_path = os.path.join(path, sd["filename"])
            image = None
            width, height = sd["width"], sd["height"]
            if os.path.exists(img_path):
                image, width, height = read_rgb(img_path)
            mask_idx = fi + rank * n_frames
            sem = load_semantic_npz(os.path.join(
                colmap_path, "input_masks", f"{mask_idx:05d}.npz")) \
                if colmap_path else None
            cam_infos.append(CameraInfo(
                uid=mask_idx, R=w2c[:3, :3].T, T=w2c[:3, 3], K=K,
                width=width, height=height, image_path=img_path,
                image_name=os.path.basename(sd["filename"]), image=image,
                semantics=sem))

    lidar_world = []
    for s in samples[::lidar_stride]:
        sd = sd_by.get((s["token"], "LIDAR_TOP"))
        if sd is None:
            continue
        lp = os.path.join(path, sd["filename"])
        if not os.path.exists(lp):
            continue
        scan = np.fromfile(lp, np.float32).reshape(-1, 5)[:, :3]
        cs = t["calibrated_sensor"][sd["calibrated_sensor_token"]]
        ego = t["ego_pose"][sd["ego_pose_token"]]
        l2w = _pose_mat(ego) @ _pose_mat(cs)
        lidar_world.append(scan @ l2w[:3, :3].T + l2w[:3, 3])
    lidar = (np.concatenate(lidar_world) if lidar_world
             else np.zeros((0, 3), np.float32))

    frame_dict = {"front_start": 0, "front_end": n_frames}
    return assemble_driving_scene(cam_infos, lidar, colmap_path,
                                  voxel_size=voxel_size,
                                  camera_frame_dict=frame_dict,
                                  device=device)
