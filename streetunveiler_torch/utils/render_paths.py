"""Novel-view camera paths and video export (counterpart of
``streetunveiler_tpu/utils/render_paths.py``): the poses' PCA frame, an
elliptical fly-around fitted to the cameras, and an animated GIF of a
directory of PNG frames. Host-side numpy and PIL."""

from __future__ import annotations

import os

import numpy as np


def _normalize(v):
    return v / (np.linalg.norm(v) + 1e-12)


def transform_poses_pca(c2ws: np.ndarray):
    """Recenter and rotate c2w poses [N, 4, 4] into their PCA frame.
    Returns (poses_recentered, transform [4, 4])."""
    poses = np.asarray(c2ws, np.float64)
    t = poses[:, :3, 3]
    t_mean = t.mean(axis=0)
    t_c = t - t_mean
    eigval, eigvec = np.linalg.eig(t_c.T @ t_c)
    inds = np.argsort(eigval)[::-1]
    rot = eigvec[:, inds].T
    if np.linalg.det(rot) < 0:
        rot = np.diag([1, 1, -1.0]) @ rot
    transform = np.concatenate([rot, rot @ -t_mean[:, None]], axis=1)
    transform = np.concatenate([transform, [[0, 0, 0, 1.0]]], axis=0)
    new = transform @ poses
    # flip when the mean up axis ends up negative
    if new[:, 2, 1].mean() < 0:
        flip = np.diag([1.0, -1.0, -1.0, 1.0])
        new = flip @ new
        transform = flip @ transform
    return new, transform


def generate_ellipse_path(c2ws: np.ndarray, n_frames: int = 120,
                          z_variation: float = 0.0, z_phase: float = 0.0,
                          const_speed: bool = True):
    """An elliptical fly-around fitted to the camera positions, looking at
    their centre. Returns c2w [n_frames, 4, 4]."""
    poses, transform = transform_poses_pca(np.asarray(c2ws))
    center = poses[:, :3, 3].mean(axis=0)
    offset = np.array([center[0], center[1], 0.0])
    sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
    zlo = np.percentile(poses[:, 2, 3], 10)
    zhi = np.percentile(poses[:, 2, 3], 90)

    th = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    pts = np.stack([
        sc[0] * np.cos(th) + offset[0],
        sc[1] * np.sin(th) + offset[1],
        z_variation * (zlo + (zhi - zlo) * 0.5
                       * (np.sin(th + z_phase * 2 * np.pi) + 1))
        + (1 - z_variation) * poses[:, 2, 3].mean()], axis=1)

    up = np.array([0.0, 0.0, 1.0])
    out = []
    inv_t = np.linalg.inv(transform)
    for p in pts:
        fwd = _normalize(center - p)
        right = _normalize(np.cross(fwd, up))
        down = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, 0] = right
        c2w[:3, 1] = down
        c2w[:3, 2] = fwd
        c2w[:3, 3] = p
        out.append(inv_t @ c2w)
    return np.stack(out)


def write_video(frames_dir: str, out_path: str, fps: int = 30) -> str:
    """The PNG frames of ``frames_dir`` (name order) as an animated GIF;
    returns its path (``.gif`` appended when missing)."""
    from PIL import Image
    names = sorted(f for f in os.listdir(frames_dir) if f.endswith(".png"))
    imgs = [Image.open(os.path.join(frames_dir, n)) for n in names]
    if not imgs:
        raise ValueError(f"no frames in {frames_dir}")
    gif = out_path if out_path.endswith(".gif") else out_path + ".gif"
    imgs[0].save(gif, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
    return gif
