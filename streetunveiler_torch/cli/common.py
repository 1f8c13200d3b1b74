"""Shared CLI helpers (counterpart of ``streetunveiler_tpu/cli/
common.py``): the scene from persisted ``ModelParams``, every dataset kind
with its selectors, and the background every entry point composites on."""

from __future__ import annotations

import torch

from ..config import ModelParams

SCENE_KINDS = ("synthetic", "colmap", "blender", "waymo", "kitti",
               "pandaset", "nuscenes")


def load_scene_info(model: ModelParams, seed: int = 0, device="cuda"):
    """``SceneInfo`` for the configured dataset kind and its selectors
    (persisted in ``cfg_args.json``, so that render and unveil reload the
    scene training used); the driving and synthetic readers put their
    cloud on ``device``."""
    kind = model.scene or ("colmap" if model.source_path else "synthetic")
    frames = dict(start_frame=model.start_frame or 0,
                  end_frame=model.end_frame, device=device)
    if kind == "synthetic":
        from ..scene.readers import make_synthetic_street
        kw = dict(seed=seed, eval_split=model.eval, device=device)
        if model.synthetic_points:
            kw["n_points"] = model.synthetic_points
        if model.synthetic_cameras:
            kw["n_cameras"] = model.synthetic_cameras
        if model.synthetic_width:
            kw["width"] = model.synthetic_width
        if model.synthetic_height:
            kw["height"] = model.synthetic_height
        if model.synthetic_focal:
            kw["focal"] = model.synthetic_focal
        return make_synthetic_street(**kw)
    if kind == "colmap":
        from ..scene.readers import read_colmap_scene
        return read_colmap_scene(model.source_path, model.colmap_path,
                                 images=model.images,
                                 eval_split=model.eval)
    if kind == "blender":
        from ..scene.readers import read_blender_info
        return read_blender_info(model.source_path,
                                 white_background=model.white_background)
    if kind == "waymo":
        from ..scene.readers import read_waymo_info
        return read_waymo_info(model.source_path, model.colmap_path,
                               **frames)
    if kind == "kitti":
        from ..scene.readers import read_kitti_info
        return read_kitti_info(model.source_path, model.date, model.drive,
                               model.colmap_path, **frames)
    if kind == "pandaset":
        from ..scene.readers import read_pandaset_info
        return read_pandaset_info(model.source_path, model.sequence,
                                  model.colmap_path, **frames)
    if kind == "nuscenes":
        from ..scene.readers import read_nuscenes_info
        return read_nuscenes_info(model.source_path, model.scene_name,
                                  version=model.version,
                                  colmap_path=model.colmap_path, **frames)
    raise ValueError(f"unknown scene kind {kind!r}; expected one of "
                     f"{SCENE_KINDS}")


def scene_background(scene, white_background: bool = False, device="cuda"):
    """White with ``white_background``, else the background the GT images
    were composited on when the reader knows it, else black. Training on
    another background than the GT's makes empty-sky pixels unfittable."""
    if white_background:
        return torch.ones(3, device=device)
    if getattr(scene, "background", None) is not None:
        return torch.tensor(scene.background, dtype=torch.float32,
                            device=device)
    return torch.zeros(3, device=device)
