"""Configuration (counterpart of ``streetunveiler_tpu/config.py``): the
reference's parameter groups as frozen dataclasses with the same field
names and defaults, JSON persistence as ``cfg_args.json`` in the model dir
(so later stages re-read it, and a file written by either package loads in
the other), and a ``--field value`` override parser.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelParams:
    sh_degree: int = 3
    source_path: str = ""
    colmap_path: str = ""
    model_path: str = ""
    start_frame: Optional[int] = None
    end_frame: Optional[int] = None
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    eval: bool = False
    # fixed surfel capacity (0 → sized from the init cloud)
    capacity: int = 0
    # dataset dispatch: the reference sniffs sentinel files
    # (scene/__init__.py:41-67); here the kind + per-dataset selectors are
    # explicit and persisted so later stages reload the same scene
    scene: str = "synthetic"   # synthetic|colmap|blender|waymo|kitti|pandaset|nuscenes
    date: str = ""             # kitti: recording date (e.g. 2011_09_26)
    drive: str = ""            # kitti: drive number (e.g. 0001)
    sequence: str = ""         # pandaset: sequence id
    scene_name: str = ""       # nuscenes: scene name
    version: str = "v1.0-mini"  # nuscenes: table version
    # synthetic scene scale (persisted so every stage reloads the SAME
    # procedural scene; 0 → the reader's defaults). The config-2 e2e gate
    # drives these at 100k pts / 800x600 (tools/e2e_config2.py).
    synthetic_points: int = 0
    synthetic_cameras: int = 0
    synthetic_width: int = 0
    synthetic_height: int = 0
    synthetic_focal: float = 0.0


@dataclasses.dataclass(frozen=True)
class PipelineParams:
    depth_ratio: float = 0.0
    debug: bool = False
    # knobs of the JAX package's TPU build, kept so that cfg_args.json
    # files stay interchangeable (``interpret`` means nothing here)
    interpret: bool = False
    duplicate_capacity: int = 0      # 0 → auto
    tile_devices: int = 1            # tile-parallel mesh size


@dataclasses.dataclass(frozen=True)
class OptimizationParams:
    iterations: int = 50_000
    position_lr_init: float = 1.6e-5
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 50_000
    feature_lr: float = 2.5e-3
    opacity_lr: float = 0.05
    scaling_lr: float = 1e-3
    rotation_lr: float = 1e-3
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    lambda_dist: float = 100.0
    lambda_normal: float = 0.05
    opacity_cull: float = 0.005

    enable_semantic_loss: bool = True
    semantic_loss_ratio: float = 0.1

    densification_interval: int = 500   # dynamically 1.15×n_cams (train.py:56)
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 25_000
    densify_grad_threshold: float = 2e-4
    # screen-size prune after the first opacity reset (the reference
    # hardcodes 20 px, train.py:172-173 — appropriate for its ~1600-px
    # real scenes). Scenes whose legitimate splats project larger (e.g.
    # near-field geometry at short focal lengths) must raise this or the
    # post-reset prune mass-extincts the model; 0 disables.
    max_screen_size: float = 20.0

    semantic_dist_from_iter: int = 27_500
    normal_consist_from_iter: int = 30_000

    prune_from_iter: int = 31_000
    prune_until_iter: int = 45_000
    prune_interval: int = 4_000
    # late-prune threshold. The reference declares 0.3
    # (arguments/__init__.py:102) but its loop hardcodes 0.5
    # (train.py:185); here the field is authoritative with the value the
    # reference actually uses.
    prune_opacity: float = 0.5

    shrinking_from_iter: int = 31_000
    lambda_shrink: float = 0.001


@dataclasses.dataclass(frozen=True)
class ReOptimizationParams(OptimizationParams):
    """The unveil stage's delta re-optimization (stage C): a short
    schedule over the masked deltas."""
    iterations: int = 1000
    position_lr_max_steps: int = 1000
    scaling_lr: float = 5e-3
    semantic_loss_ratio: float = 0.02
    densification_interval: int = 200
    opacity_reset_interval: int = 400
    densify_from_iter: int = 200
    densify_until_iter: int = 1_500
    enable_geometry_loss: bool = False
    geometric_loss_ratio: float = 0.5
    enable_depth_loss: bool = False
    depth_loss_ratio: float = 0.025


CFG_NAME = "cfg_args.json"


def save_config(model_path: str, **groups) -> None:
    """Persist parameter groups into the model dir (reference cfg_args).

    Groups are dataclasses; a plain dict passes through verbatim (used
    for the ``scene`` group: derived quantities like ``cameras_extent``
    that later stages assert against).
    """
    os.makedirs(model_path, exist_ok=True)
    payload = {name: (dataclasses.asdict(g) if dataclasses.is_dataclass(g)
                      else dict(g)) for name, g in groups.items()}
    with open(os.path.join(model_path, CFG_NAME), "w") as f:
        json.dump(payload, f, indent=2)


def load_config(model_path: str):
    """Load persisted groups, reconstructing the dataclasses
    (reference ``get_combined_args`` merge base)."""
    with open(os.path.join(model_path, CFG_NAME)) as f:
        payload = json.load(f)
    kinds = {"model": ModelParams, "pipeline": PipelineParams,
             "optimization": OptimizationParams,
             "reoptimization": ReOptimizationParams}
    out = {}
    for name, values in payload.items():
        cls = kinds.get(name)
        if cls is None:
            out[name] = values          # plain-dict group (e.g. "scene")
            continue
        fields = {f.name for f in dataclasses.fields(cls)}
        out[name] = cls(**{k: v for k, v in values.items() if k in fields})
    return out


def apply_overrides(group, argv):
    """Apply ``--field value`` CLI overrides to a dataclass instance
    (the reference's argparse merge, ``get_combined_args``)."""
    fields = {f.name: f for f in dataclasses.fields(group)}
    i = 0
    updates = {}
    rest = []
    while i < len(argv):
        a = argv[i]
        if a.startswith("--") and a[2:] in fields:
            name = a[2:]
            # with `from __future__ import annotations` field types are
            # strings ("int", "Optional[int]", …); normalize before dispatch
            ftype = str(fields[name].type).replace("builtins.", "")
            base = ftype.replace("Optional[", "").rstrip("]")
            if base == "bool":
                updates[name] = True
                i += 1
            else:
                raw = argv[i + 1]
                if ftype.startswith("Optional") and raw.lower() == "none":
                    updates[name] = None
                else:
                    caster = {"int": int, "float": float}.get(base, str)
                    updates[name] = caster(raw)
                i += 2
        else:
            rest.append(a)
            i += 1
    return dataclasses.replace(group, **updates), rest
