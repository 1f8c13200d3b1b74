"""Shared CLI helpers (counterpart of ``streetunveiler_tpu/cli/
common.py``): the scene from persisted ``ModelParams`` and the background
every entry point composites on."""

from __future__ import annotations

import torch

from ..config import ModelParams

SCENE_KINDS = ("synthetic", "colmap", "blender", "waymo", "kitti",
               "pandaset", "nuscenes")


def load_scene_info(model: ModelParams, seed: int = 0, device="cuda"):
    """``SceneInfo`` for the configured dataset kind. Only the synthetic
    street scene is ported; the file-based readers raise."""
    kind = model.scene or ("colmap" if model.source_path else "synthetic")
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
    if kind in SCENE_KINDS:
        raise NotImplementedError(
            f"the {kind} reader is not ported to the PyTorch build yet: the "
            "file-based readers come with the data-layer slice, item 14 "
            "(ROADMAP.md)")
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
