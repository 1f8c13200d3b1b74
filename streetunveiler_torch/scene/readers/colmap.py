"""COLMAP scene reader (counterpart of ``streetunveiler_tpu/scene/
readers/colmap.py``, the reference's ``scene/dataset_readers/colmap.py``).

A ``SceneInfo`` from a COLMAP sparse reconstruction and its image
directory, parsed on the host. Semantic maps (.npz of cityscapes train
ids) are read from a ``semantic`` sibling directory when it holds one for
the image; the sparse points are labelled 'building'.
"""

from __future__ import annotations

import os

import numpy as np

from ...utils.semantics import CONCERNED_IND
from ..colmap import load_colmap_model, qvec2rotmat
from .basic import CameraInfo, PointCloud, SceneInfo, nerf_normalization
from .driving import load_semantic_npz, read_rgb


def _intrinsics(cam):
    if cam.model == "SIMPLE_PINHOLE":
        f, cx, cy = cam.params[:3]
        fx = fy = f
    elif cam.model == "PINHOLE":
        fx, fy, cx, cy = cam.params[:4]
    elif cam.model in ("SIMPLE_RADIAL", "RADIAL"):
        f, cx, cy = cam.params[:3]
        fx = fy = f
    elif cam.model == "OPENCV":
        fx, fy, cx, cy = cam.params[:4]
    else:
        raise ValueError(f"unsupported COLMAP camera model {cam.model}")
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


def read_colmap_scene(source_path: str, colmap_path: str = "",
                      images: str = "images", eval_split: bool = False,
                      llffhold: int = 8, load_images: bool = True,
                      device="cuda"):
    # ``device`` keeps the readers' one signature: this one only parses
    # files, on the host
    sparse = colmap_path or os.path.join(source_path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(source_path, "sparse")
    cams, imgs, (xyz, rgb, _err) = load_colmap_model(sparse)

    cam_infos = []
    img_dir = os.path.join(source_path, images)
    sem_dir = os.path.join(source_path, "semantic")
    for idx, (img_id, im) in enumerate(sorted(imgs.items())):
        cam = cams[im.camera_id]
        R = qvec2rotmat(im.qvec).T        # readers store transposed rotation
        image = None
        ipath = os.path.join(img_dir, im.name)
        spath = os.path.join(sem_dir, os.path.splitext(im.name)[0] + ".npz")
        if load_images and os.path.exists(ipath):
            image = read_rgb(ipath)[0]
        semantics = load_semantic_npz(spath)
        cam_infos.append(CameraInfo(
            uid=idx, R=R, T=im.tvec.astype(np.float64), K=_intrinsics(cam),
            width=cam.width, height=cam.height, image_path=ipath,
            image_name=im.name, semantic_path=spath, image=image,
            semantics=semantics))

    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    pc = PointCloud(points=xyz.astype(np.float32),
                    colors=(rgb.astype(np.float32) / 255.0),
                    semantics=np.full(xyz.shape[0],
                                      CONCERNED_IND["building"], np.int32))
    return SceneInfo(point_cloud=pc, reference_cloud=pc,
                     train_cameras=train, test_cameras=test,
                     nerf_normalization=nerf_normalization(train),
                     ply_path=os.path.join(sparse, "points3D.ply"))
