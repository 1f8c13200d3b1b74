"""KITTI raw reader (counterpart of ``streetunveiler_tpu/scene/readers/
kitti.py``, the reference's ``scene/dataset_readers/kitti.py``).

Parses the KITTI raw layout on the host, without the devkit:

    <base>/<date>/calib_cam_to_cam.txt, calib_imu_to_velo.txt,
    calib_velo_to_cam.txt
    <base>/<date>/<date>_drive_<drive>_sync/oxts/data/*.txt   (GPS/IMU)
    <base>/<date>/<date>_drive_<drive>_sync/velodyne_points/data/*.bin
    <base>/<date>/<date>_drive_<drive>_sync/image_02/data/*.png, image_03

Semantic masks come from ``<colmap_path>/input_masks/<idx>.npz``, the
image_02 frames first, then image_03. The cloud is coloured and
voxel-downsampled on ``device`` (``driving.assemble_driving_scene``).
"""

from __future__ import annotations

import os

import numpy as np

from .basic import CameraInfo, SceneInfo
from .driving import assemble_driving_scene, load_semantic_npz, read_rgb

EARTH_RADIUS = 6378137.0


def _read_calib_file(path):
    out = {}
    with open(path) as f:
        lines = f.readlines()
    for line in lines:
        if ":" not in line:
            continue
        key, val = line.split(":", 1)
        try:
            out[key.strip()] = np.array([float(x) for x in val.split()])
        except ValueError:
            pass
    return out


def _oxts_pose(oxts_row, scale):
    """GPS/IMU → 4x4 world pose (Mercator), the pykitti formula."""
    lat, lon, alt, roll, pitch, yaw = oxts_row[:6]
    tx = scale * np.radians(lon) * EARTH_RADIUS
    ty = scale * EARTH_RADIUS * np.log(np.tan(np.pi / 4
                                              + np.radians(lat) / 2))
    tz = alt
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    T = np.eye(4)
    T[:3, :3] = Rz @ Ry @ Rx
    T[:3, 3] = (tx, ty, tz)
    return T


def read_kitti_info(base: str, date: str, drive: str, colmap_path: str = "",
                    start_frame: int = 0, end_frame: int | None = None,
                    voxel_size: float = 0.15, lidar_stride: int = 1,
                    device="cuda"):
    date_dir = os.path.join(base, date)
    drive_dir = os.path.join(date_dir,
                             f"{date}_drive_{drive}_sync")
    c2c = _read_calib_file(os.path.join(date_dir, "calib_cam_to_cam.txt"))
    v2c = _read_calib_file(os.path.join(date_dir, "calib_velo_to_cam.txt"))
    i2v = _read_calib_file(os.path.join(date_dir, "calib_imu_to_velo.txt"))

    T_velo_cam0 = np.eye(4)
    T_velo_cam0[:3, :3] = v2c["R"].reshape(3, 3)
    T_velo_cam0[:3, 3] = v2c["T"]
    T_imu_velo = np.eye(4)
    T_imu_velo[:3, :3] = i2v["R"].reshape(3, 3)
    T_imu_velo[:3, 3] = i2v["T"]

    oxts_dir = os.path.join(drive_dir, "oxts", "data")
    frames_avail = sorted(os.listdir(oxts_dir))
    end_frame = end_frame if end_frame is not None else len(frames_avail)
    frame_ids = list(range(start_frame, min(end_frame, len(frames_avail))))

    oxts0 = np.loadtxt(os.path.join(oxts_dir, frames_avail[frame_ids[0]]))
    scale = np.cos(np.radians(oxts0[0]))
    T0 = _oxts_pose(oxts0, scale)
    T0_inv = np.linalg.inv(T0)

    cam_infos = []
    lidar_world = []
    n_frames = len(frame_ids)
    for rank, cam in enumerate(["02", "03"]):
        # rectified intrinsics + cam0→camX rectification transform
        P = c2c[f"P_rect_{cam}"].reshape(3, 4)
        R_rect0 = np.eye(4)
        R_rect0[:3, :3] = c2c["R_rect_00"].reshape(3, 3)
        K = P[:, :3].copy()
        # P = K [I | t] in rect frame; baseline offset folds into the pose
        t_off = np.linalg.inv(K) @ P[:, 3]
        for fi, frame in enumerate(frame_ids):
            oxts = np.loadtxt(os.path.join(oxts_dir, frames_avail[frame]))
            T_w_imu = T0_inv @ _oxts_pose(oxts, scale)
            # world→camX = [I|t_off]∘R_rect∘T_velo_cam0∘T_imu_velo∘inv(T_w_imu)
            w2c = R_rect0 @ T_velo_cam0 @ T_imu_velo @ np.linalg.inv(T_w_imu)
            w2c[:3, 3] += t_off
            img_path = os.path.join(drive_dir, f"image_{cam}", "data",
                                    frames_avail[frame].replace(".txt",
                                                                ".png"))
            image = None
            width, height = 1242, 375
            if os.path.exists(img_path):
                image, width, height = read_rgb(img_path)
            mask_idx = fi + rank * n_frames
            sem = load_semantic_npz(os.path.join(
                colmap_path, "input_masks", f"{mask_idx:05d}.npz")) \
                if colmap_path else None
            cam_infos.append(CameraInfo(
                uid=mask_idx, R=w2c[:3, :3].T, T=w2c[:3, 3],
                K=K.astype(np.float32), width=width, height=height,
                image_path=img_path,
                image_name=f"{cam}_{frame:010d}", image=image,
                semantics=sem))

            if rank == 0 and fi % lidar_stride == 0:
                vpath = os.path.join(drive_dir, "velodyne_points", "data",
                                     frames_avail[frame].replace(".txt",
                                                                 ".bin"))
                if os.path.exists(vpath):
                    scan = np.fromfile(vpath, np.float32).reshape(-1, 4)
                    T_w_velo = T_w_imu @ np.linalg.inv(T_imu_velo)
                    pts = scan[:, :3] @ T_w_velo[:3, :3].T + T_w_velo[:3, 3]
                    lidar_world.append(pts)

    lidar = (np.concatenate(lidar_world) if lidar_world
             else np.zeros((0, 3), np.float32))
    frame_dict = {"front_start": 0, "front_end": n_frames}
    return assemble_driving_scene(cam_infos, lidar, colmap_path,
                                  voxel_size=voxel_size,
                                  camera_frame_dict=frame_dict,
                                  device=device)
