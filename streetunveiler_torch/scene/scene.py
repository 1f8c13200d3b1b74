"""Scene container (counterpart of ``streetunveiler_tpu/scene/scene.py``):
the camera lists with their images and semantic maps, the initial surfel
state, and the model-dir artifact layout
(``point_cloud/iteration_N/point_cloud.ply``, ``cameras.json``), and the
point↔frame projection queries of the unveil pipeline.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..device import resolve_device
from ..models.gaussians import SurfelState, create_from_pcd
from ..utils.ply import state_from_ply, state_to_ply
from ..utils.semantics import CONCERNED_IND
from .cameras import make_camera
from .readers.basic import SceneInfo


def resolution_scale_size(width, height, resolution: int = -1):
    """The reference's resolution policy: -1 clamps the width to 1600;
    k ∈ {1, 2, 4, 8} divides."""
    if resolution in (1, 2, 4, 8):
        return round(width / resolution), round(height / resolution)
    if width > 1600:
        scale = width / 1600.0
        return round(width / scale), round(height / scale)
    return width, height


class Scene:
    def __init__(self, scene_info: SceneInfo, model_path: str = "",
                 resolution: int = -1, only_pose: bool = False,
                 device="cuda"):
        """Cameras on ``device``; images [H, W, 3] float and semantic maps
        [H, W] int stay numpy arrays (None with ``only_pose``)."""
        self.info = scene_info
        self.model_path = model_path
        self.resolution = resolution
        self.only_pose = only_pose
        self.device = resolve_device(device)
        self.cameras_extent = float(scene_info.nerf_normalization["radius"])
        self.camera_frame_dict = scene_info.camera_frame_dict or {}
        # the background the GT images were composited on, when the reader
        # knows it: training and render composite on the same colour, or
        # empty-sky pixels become unfittable
        self.background = getattr(scene_info, "background", None)
        self.train_cameras, self.train_images, self.train_semantics = \
            self.load_split(scene_info.train_cameras)
        self.test_cameras, self.test_images, self.test_semantics = \
            self.load_split(scene_info.test_cameras)
        self._scaled: dict = {}

    def load_split(self, cam_infos, scale: float = 1.0):
        """(cameras, images, semantics) of ``cam_infos`` at the scene's
        resolution, downscaled by ``scale``."""
        cams, images, semantics = [], [], []
        for ci in cam_infos:
            w, h = resolution_scale_size(ci.width, ci.height,
                                         self.resolution)
            w, h = round(w / scale), round(h / scale)
            K = np.array(ci.K)
            K[0, :] *= w / ci.width
            K[1, :] *= h / ci.height
            cams.append(make_camera(ci.R, ci.T, K, w, h, device=self.device))
            img = None if self.only_pose else ci.image
            if img is not None and img.shape[:2] != (h, w):
                img = _resize(img, w, h)
            sem = None if self.only_pose else ci.semantics
            if sem is not None and sem.shape[:2] != (h, w):
                sem = _resize_nearest(sem, w, h)
            images.append(img)
            semantics.append(sem)
        return cams, images, semantics

    def at_scale(self, scale: float):
        """(cameras, images, semantics) of the train split downscaled by
        ``scale`` (the reference's ``getTrainCameras(scale)``), cached."""
        if scale == 1.0:
            return self.train_cameras, self.train_images, self.train_semantics
        if scale not in self._scaled:
            self._scaled[scale] = self.load_split(self.info.train_cameras,
                                                  scale)
        return self._scaled[scale]

    # ----------------------------------------------------------- state
    def create_state(self, capacity: int = 0, sh_degree: int = 3,
                     prune_sky: bool = True) -> SurfelState:
        """Surfels from the scene point cloud on the scene's device.
        ``prune_sky``: sky-class points are dropped (the sky is the env
        map's)."""
        pc = self.info.point_cloud
        pts, cols, sems = pc.points, pc.colors, pc.semantics
        if prune_sky:
            keep = sems != CONCERNED_IND["sky"]
            pts, cols, sems = pts[keep], cols[keep], sems[keep]
        cap = capacity or int(pts.shape[0] * 2.5)
        return create_from_pcd(pts, cols, sems, self.cameras_extent,
                               capacity=cap, sh_degree=sh_degree,
                               device=self.device)

    # ------------------------------------------------------- artifacts
    def save_cameras_json(self, path: str = "") -> str:
        """``cameras.json`` in the reference's SIBR-viewer format: c2w
        position and rotation rows and the focal lengths per view."""
        entries = []
        for i, cam in enumerate(self.train_cameras):
            c2w = np.linalg.inv(cam.w2c.detach().cpu().numpy())
            K = cam.K.detach().cpu().numpy()
            entries.append({
                "id": i,
                "img_name": f"{i:05d}",
                "width": int(cam.width),
                "height": int(cam.height),
                "position": c2w[:3, 3].tolist(),
                "rotation": [row.tolist() for row in c2w[:3, :3]],
                "fx": float(K[0, 0]),
                "fy": float(K[1, 1]),
            })
        out = path or os.path.join(self.model_path, "cameras.json")
        with open(out, "w") as f:
            json.dump(entries, f)
        return out

    def ply_dir(self, iteration: int) -> str:
        return os.path.join(self.model_path, "point_cloud",
                            f"iteration_{iteration}")

    def save(self, state: SurfelState, iteration: int) -> None:
        state_to_ply(os.path.join(self.ply_dir(iteration), "point_cloud.ply"),
                     state)

    def load(self, iteration: int, capacity: int = 0) -> SurfelState:
        path = os.path.join(self.ply_dir(iteration), "point_cloud.ply")
        return state_from_ply(path, spatial_scale=self.cameras_extent,
                              capacity=capacity or None, device=self.device)

    # ------------------------------------------- projection queries
    def _view(self, xyz, frame_idx: int):
        cam = self.train_cameras[frame_idx]
        xyz = torch.as_tensor(xyz, dtype=torch.float32, device=cam.device)
        # a 3-wide contraction as products and sums: f32 whatever the TF32
        # flags say
        v = (xyz[:, None, :] * cam.w2c[:3, :3]).sum(dim=-1) + cam.w2c[:3, 3]
        return cam, v

    def pcd_in_frame_mask(self, xyz, frame_idx: int, margin: float = 0.0):
        """[N] bool: the points in train frame ``frame_idx``'s frustum
        (depth > 0.01, projection inside the image widened by
        ``margin``; the reference's ``getPcdInTrainFrame``)."""
        cam, v = self._view(xyz, frame_idx)
        z = v[:, 2]
        zs = torch.clamp(z, min=1e-8)
        x = v[:, 0] / zs * cam.K[0, 0] + cam.K[0, 2]
        y = v[:, 1] / zs * cam.K[1, 1] + cam.K[1, 2]
        return ((z > 0.01) & (x >= -margin) & (x < cam.width + margin)
                & (y >= -margin) & (y < cam.height + margin))

    def pcd_pixel_coords(self, xyz, frame_idx: int):
        """(pixel coordinates [N, 2], depth [N]) of the points in train
        frame ``frame_idx`` (the reference's
        ``getPcdPixelCoordsInTrainFrameWithDepth``)."""
        cam, v = self._view(xyz, frame_idx)
        z = torch.clamp(v[:, 2], min=1e-8)
        x = v[:, 0] / z * cam.K[0, 0] + cam.K[0, 2]
        y = v[:, 1] / z * cam.K[1, 1] + cam.K[1, 2]
        return torch.stack([x, y], dim=-1), v[:, 2]

    def semantic_mask_of_splatting(self, xyz, semantic_remain_bit: int):
        """[N] bool numpy: the points that project, in some train frame,
        onto a pixel whose GT class is in the bit set (the reference's
        ``getSemanticMaskOfSplatting``)."""
        final = np.zeros(len(xyz), bool)
        for fid, sem in enumerate(self.train_semantics):
            if sem is None:
                continue
            cam = self.train_cameras[fid]
            pix, _ = self.pcd_pixel_coords(xyz, fid)
            inm = self.pcd_in_frame_mask(xyz, fid).cpu().numpy()
            pix = pix.cpu().numpy()
            px = np.clip(pix[:, 0].astype(np.int64), 0, cam.width - 1)
            py = np.clip(pix[:, 1].astype(np.int64), 0, cam.height - 1)
            hit = ((1 << np.asarray(sem)[py, px].astype(np.int64))
                   & semantic_remain_bit) > 0
            final |= inm & hit
        return final


def _resize(img, w, h):
    from PIL import Image
    pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return np.asarray(pil.resize((w, h)), np.float32) / 255.0


def _resize_nearest(arr, w, h):
    from PIL import Image
    pil = Image.fromarray(arr.astype(np.int32), mode="I")
    return np.asarray(pil.resize((w, h), Image.NEAREST), np.int32)
