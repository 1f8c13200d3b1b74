"""Camera / rigid-body math (counterpart of ``streetunveiler_tpu/ops/
transforms.py``): COLMAP-convention world→view matrices, the z∈[0, zfar]
projection of the reference, and quaternion → rotation."""

from __future__ import annotations

import math

import torch


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view(R, t, translate=None, scale: float = 1.0):
    """4x4 world→camera matrix from the transposed rotation ``R`` and the
    translation ``t`` (reference ``getWorld2View2``), optionally
    recentering/rescaling the camera center."""
    R = torch.as_tensor(R, dtype=torch.float32)
    t = torch.as_tensor(t, dtype=torch.float32, device=R.device)
    Rt = torch.zeros((4, 4), dtype=torch.float32, device=R.device)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = (torch.zeros(3, dtype=torch.float32, device=R.device)
                     if translate is None
                     else torch.as_tensor(translate, dtype=torch.float32,
                                          device=R.device))
        C2W = torch.linalg.inv(Rt)
        C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
        Rt = torch.linalg.inv(C2W)
    return Rt


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float,
                      K=None, width: float | None = None,
                      height: float | None = None):
    """Perspective matrix in the reference's z∈[0, zfar] clip convention;
    the asymmetric intrinsics frustum when ``K``/``width``/``height`` are
    given, else the symmetric fov frustum."""
    if K is not None:
        K = torch.as_tensor(K, dtype=torch.float32)
        fx, fy = K[0, 0], K[1, 1]
        cx, cy = K[0, 2], K[1, 2]
        left = -cx / fx * znear
        right = (width - cx) / fx * znear
        top = cy / fy * znear
        bottom = -(height - cy) / fy * znear
        device = K.device
    else:
        top = torch.tensor(math.tan(fovy / 2.0) * znear)
        bottom = -top
        right = torch.tensor(math.tan(fovx / 2.0) * znear)
        left = -right
        device = None
    P = torch.zeros((4, 4), dtype=torch.float32, device=device)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def quat_to_rotmat(q):
    """Quaternion(s) [..., 4] (w, x, y, z), normalized here → rotation
    matrices [..., 3, 3] (reference ``build_rotation``)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def camera_center_from_w2c(w2c):
    """Camera position in world space from a 4x4 world→view matrix."""
    return torch.linalg.inv(w2c)[:3, 3]
