"""Camera state (counterpart of ``streetunveiler_tpu/scene/cameras.py``):
a pinhole camera as a dataclass of a 4x4 world→view matrix and 3x3
intrinsics on one device."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..ops.transforms import focal2fov, projection_matrix


@dataclasses.dataclass(frozen=True)
class Camera:
    """A pinhole camera. ``w2c``: 4x4 world→view; ``K``: 3x3 intrinsics."""

    w2c: torch.Tensor
    K: torch.Tensor
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def device(self) -> torch.device:
        return self.w2c.device

    @property
    def fx(self):
        return self.K[0, 0]

    @property
    def fy(self):
        return self.K[1, 1]

    @property
    def cx(self):
        return self.K[0, 2]

    @property
    def cy(self):
        return self.K[1, 2]

    @property
    def fovx(self) -> float:
        return focal2fov(float(self.K[0, 0]), self.width)

    @property
    def fovy(self) -> float:
        return focal2fov(float(self.K[1, 1]), self.height)

    @property
    def camera_center(self):
        return torch.linalg.inv(self.w2c)[:3, 3]

    @property
    def world_view_transform(self):
        """Transposed w2c — the reference's row-vector convention."""
        return self.w2c.T

    @property
    def full_proj_transform(self):
        """Transposed (proj @ w2c), reference ``scene/cameras.py:66-70``."""
        proj = projection_matrix(self.znear, self.zfar, self.fovx, self.fovy,
                                 K=self.K, width=self.width,
                                 height=self.height)
        return (proj @ self.w2c).T

    def to(self, device) -> "Camera":
        return dataclasses.replace(self, w2c=self.w2c.to(device),
                                   K=self.K.to(device))

    def resize(self, scale: float) -> "Camera":
        """Camera for an image downscaled by ``scale``."""
        K = self.K.clone()
        K[:2, :] /= scale
        return dataclasses.replace(
            self, K=K, width=int(round(self.width / scale)),
            height=int(round(self.height / scale)))


def make_camera(R, t, K, width, height, znear=0.01, zfar=100.0,
                device="cuda") -> Camera:
    """Camera from COLMAP-style (R, t) — R is the transposed world→cam
    rotation exactly as the reference readers store it."""
    dev = resolve_device(device)
    R = np.asarray(R, np.float32)
    t = np.asarray(t, np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = R.T
    w2c[:3, 3] = t
    return Camera(w2c=torch.as_tensor(w2c, device=dev),
                  K=torch.as_tensor(np.asarray(K, np.float32), device=dev),
                  width=int(width), height=int(height), znear=znear,
                  zfar=zfar)
