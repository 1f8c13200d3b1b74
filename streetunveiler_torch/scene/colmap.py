"""COLMAP model parsing (counterpart of ``streetunveiler_tpu/scene/
colmap.py``, the reference's ``scene/colmap_loader.py``): ``cameras``,
``images`` and ``points3D`` in COLMAP's binary or text format, read into
plain numpy structures on the host.
"""

from __future__ import annotations

import os
import struct
from typing import NamedTuple

import numpy as np

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


def qvec2rotmat(qvec):
    """COLMAP (w,x,y,z) quaternion → rotation matrix
    (reference colmap_loader.py:43)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y]])


def rotmat2qvec(R):
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path):
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "<" + "d" * np_))
            cams[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return cams


def read_images_binary(path):
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<dddd"))
            tvec = np.array(_read(f, "<ddd"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "<Q")
            data = np.frombuffer(f.read(24 * npts),
                                 dtype=[("x", "<f8"), ("y", "<f8"),
                                        ("id", "<q")])
            images[img_id] = ColmapImage(
                img_id, qvec, tvec, cam_id, name.decode("utf-8"),
                np.stack([data["x"], data["y"]], 1), data["id"].copy())
    return images


def read_points3d_binary(path):
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty(n)
        for i in range(n):
            _pid, x, y, z, r, g, b, e = _read(f, "<QdddBBBd")
            xyz[i] = (x, y, z)
            rgb[i] = (r, g, b)
            err[i] = e
            (tl,) = _read(f, "<Q")
            f.seek(8 * tl, 1)
    return xyz, rgb, err


def read_cameras_text(path):
    cams = {}
    with open(path) as f:
        lines = f.readlines()
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        el = line.split()
        cams[int(el[0])] = ColmapCamera(
            int(el[0]), el[1], int(el[2]), int(el[3]),
            np.array([float(x) for x in el[4:]]))
    return cams


def read_images_text(path):
    images = {}
    with open(path) as f:
        lines = [l.strip() for l in f
                 if l.strip() and not l.startswith("#")]
    for meta, pts in zip(lines[0::2], lines[1::2]):
        el = meta.split()
        data = np.array([float(x) for x in pts.split()]).reshape(-1, 3) \
            if pts else np.zeros((0, 3))
        images[int(el[0])] = ColmapImage(
            int(el[0]), np.array([float(x) for x in el[1:5]]),
            np.array([float(x) for x in el[5:8]]), int(el[8]), el[9],
            data[:, :2], data[:, 2].astype(np.int64))
    return images


def read_points3d_text(path):
    with open(path) as f:
        rows = [l.split() for l in f
                if l.strip() and not l.startswith("#")]
    xyz = np.array([[float(r[1]), float(r[2]), float(r[3])] for r in rows])
    rgb = np.array([[int(r[4]), int(r[5]), int(r[6])] for r in rows], np.uint8)
    err = np.array([float(r[7]) for r in rows])
    return xyz, rgb, err


def load_colmap_model(sparse_dir):
    """Load (cameras, images, points) preferring binary files
    (reference readColmapSceneInfo dispatch)."""
    def pick(stem):
        b = os.path.join(sparse_dir, stem + ".bin")
        t = os.path.join(sparse_dir, stem + ".txt")
        return (b, True) if os.path.exists(b) else (t, False)

    p, binary = pick("cameras")
    cams = read_cameras_binary(p) if binary else read_cameras_text(p)
    p, binary = pick("images")
    images = read_images_binary(p) if binary else read_images_text(p)
    p, binary = pick("points3D")
    pts = read_points3d_binary(p) if binary else read_points3d_text(p)
    return cams, images, pts
