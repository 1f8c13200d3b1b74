"""Blender / NeRF-synthetic reader (counterpart of ``streetunveiler_tpu/
scene/readers/blender.py``, the reference's ``readNerfSyntheticInfo``).

Parses ``transforms_train.json`` and ``transforms_test.json`` on the host;
their poses are OpenGL camera-to-world matrices (y up, -z forward),
converted to the OpenCV convention used everywhere else. The initial
points are uniform in [-1.3, 1.3]^3 from ``seed``, 100k by default, as the
reference draws them when no PLY exists.
"""

from __future__ import annotations

import os

import numpy as np

from ...utils.semantics import CONCERNED_IND
from .basic import CameraInfo, PointCloud, SceneInfo, nerf_normalization
from .driving import read_json

_GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0])


def read_blender_info(path: str, white_background: bool = False,
                      n_init_points: int = 100_000, seed: int = 0,
                      device="cuda"):
    # ``device`` keeps the readers' one signature: this one only parses
    # files, on the host
    def load_split(name):
        meta_path = os.path.join(path, f"transforms_{name}.json")
        if not os.path.exists(meta_path):
            return []
        meta = read_json(meta_path)
        infos = []
        for i, fr in enumerate(meta["frames"]):
            c2w = np.asarray(fr["transform_matrix"], np.float64) @ _GL_TO_CV
            w2c = np.linalg.inv(c2w)
            img_path = os.path.join(path, fr["file_path"] + ".png")
            image = None
            width = height = 800
            if os.path.exists(img_path):
                from PIL import Image
                with Image.open(img_path) as pil:
                    width, height = pil.size
                    rgba = np.asarray(pil.convert("RGBA"),
                                      np.float32) / 255.0
                bg = 1.0 if white_background else 0.0
                image = rgba[..., :3] * rgba[..., 3:] + bg * (1 - rgba[..., 3:])
            focal = 0.5 * width / np.tan(0.5 * meta["camera_angle_x"])
            K = np.array([[focal, 0, width / 2], [0, focal, height / 2],
                          [0, 0, 1]], np.float32)
            infos.append(CameraInfo(
                uid=i, R=w2c[:3, :3].T, T=w2c[:3, 3], K=K, width=width,
                height=height, image_path=img_path,
                image_name=os.path.basename(fr["file_path"]), image=image))
        return infos

    train = load_split("train")
    test = load_split("test")
    rng = np.random.default_rng(seed)
    pts = (rng.random((n_init_points, 3), dtype=np.float32) * 2.6 - 1.3)
    pc = PointCloud(points=pts,
                    colors=rng.random((n_init_points, 3), dtype=np.float32),
                    semantics=np.full(n_init_points,
                                      CONCERNED_IND["building"], np.int32))
    return SceneInfo(point_cloud=pc, reference_cloud=pc,
                     train_cameras=train, test_cameras=test,
                     nerf_normalization=nerf_normalization(train))
