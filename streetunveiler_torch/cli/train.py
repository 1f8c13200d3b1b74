"""Stage-1 training CLI (counterpart of ``streetunveiler_tpu/cli/
train.py``), on the synthetic street scene:

    python -m streetunveiler_torch.cli.train --model_path /tmp/model \
        --iterations 2000 [--semantics] [--sky] [--device cuda]

Runs on the card by default (``--device cpu`` for the CPU). With
``--semantics`` the step adds the semantic cross entropy and, past
``semantic_dist_from_iter``, the gated per-class distortion; ``--sky``
trains the sky model jointly (initialised from ``--seed``). Persists
``cfg_args.json`` and ``cameras.json`` into the model dir, saves PLYs at
``--save_every`` and a resumable ``checkpoint/iteration_N/splatting.npz``
(the sky included) at the end; ``--start_iteration N`` resumes from one.
Option groups of ``config.py`` are overridable as ``--field value``. Not
ported yet, and refused: the file-based readers (``--scene`` other than
synthetic), multi-device meshes (``--tile_devices``, ``--data_devices``,
``--multihost``) and ``--profile``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _refuse(flag: str, item: str):
    raise SystemExit(f"{flag} is not ported to the PyTorch build yet: it "
                     f"comes with {item} (ROADMAP.md)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="synthetic")
    ap.add_argument("--source_path", default="")
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--eval", action="store_true",
                    help="hold out every 8th view for evaluation")
    ap.add_argument("--iterations", type=int, default=None)
    ap.add_argument("--capacity", type=int, default=0)
    ap.add_argument("--resolution", type=int, default=-1)
    ap.add_argument("--sky", action="store_true",
                    help="train the sky model jointly")
    ap.add_argument("--semantics", action="store_true")
    ap.add_argument("--start_iteration", type=int, default=0,
                    help="resume from checkpoint/iteration_N")
    ap.add_argument("--save_every", type=int, default=5000)
    ap.add_argument("--log_every", type=int, default=200)
    ap.add_argument("--eval_every", type=int, default=1000,
                    help="held-out PSNR/L1 interval (0 = off)")
    ap.add_argument("--duplicate_capacity", type=int, default=0)
    ap.add_argument("--tile_devices", type=int, default=1)
    ap.add_argument("--data_devices", type=int, default=1)
    ap.add_argument("--multihost", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args, rest = ap.parse_known_args(argv)

    if args.tile_devices > 1 or args.data_devices > 1 or args.multihost:
        _refuse("multi-device training", "the multi-device slice, item 16")
    if args.profile:
        _refuse("--profile", "the render/eval slice, item 12")

    import torch

    from ..config import (ModelParams, OptimizationParams, PipelineParams,
                          apply_overrides, save_config)
    from ..device import resolve_device, strict_fp32
    from ..models.sky import init_sky
    from ..scene.scene import Scene
    from ..train.checkpoint import load_checkpoint, save_checkpoint
    from ..train.loop import train_scene
    from ..train.step import init_optimizer
    from ..utils.logging import TrainLogger
    from .common import load_scene_info, scene_background

    dev = resolve_device(args.device)
    strict_fp32()
    opt, rest = apply_overrides(OptimizationParams(), rest)
    model = ModelParams(source_path=args.source_path,
                        model_path=args.model_path,
                        resolution=args.resolution, capacity=args.capacity,
                        scene=args.scene, eval=args.eval)
    model, rest = apply_overrides(model, rest)
    pipe, rest = apply_overrides(PipelineParams(
        duplicate_capacity=args.duplicate_capacity), rest)
    if rest:
        print(f"WARNING: unrecognized arguments {rest}", file=sys.stderr)
    info = load_scene_info(model, seed=args.seed, device=dev)
    scene = Scene(info, model_path=args.model_path,
                  resolution=args.resolution, device=dev)
    save_config(args.model_path, model=model, pipeline=pipe,
                optimization=opt,
                scene={"cameras_extent": float(scene.cameras_extent)})
    scene.save_cameras_json()
    state = scene.create_state(capacity=args.capacity,
                               sh_degree=model.sh_degree)
    print(f"scene: {len(scene.train_cameras)} train / "
          f"{len(scene.test_cameras)} test cameras, "
          f"{int(state.num_alive)} init surfels, "
          f"capacity {state.capacity}, extent {scene.cameras_extent:.1f}, "
          f"device {dev}")
    bg = scene_background(scene, model.white_background, device=dev)

    sky_params = None
    if args.sky:
        sky_params = init_sky(torch.Generator().manual_seed(args.seed),
                              device=dev)

    opt_state = init_optimizer(state)
    start_iteration = args.start_iteration
    if start_iteration > 0:
        ckpt_dir = os.path.join(args.model_path, "checkpoint",
                                f"iteration_{start_iteration}")
        state, opt_state, it, ck_sky, _ = load_checkpoint(ckpt_dir,
                                                          device=dev)
        if sky_params is not None:
            if ck_sky is None:
                raise SystemExit(f"--sky: {ckpt_dir} holds no sky")
            sky_params = ck_sky
        print(f"resumed from {ckpt_dir} at iteration {it}")

    iterations = args.iterations or opt.iterations
    saves = tuple(range(args.save_every, iterations + 1, args.save_every)
                  ) + (iterations,)

    def report(r):
        line = (f"[{r.iteration}] loss={r.loss:.5f} psnr={r.psnr:.2f} "
                f"alive={r.n_alive} {r.iters_per_s:.1f} it/s")
        if np.isfinite(r.test_psnr):
            line += f" test_psnr={r.test_psnr:.2f}"
        print(line, flush=True)

    logger = TrainLogger(os.path.join(args.model_path, "logs"))
    try:
        state, sky_params, reports = train_scene(
            scene, state, opt, sky_params=sky_params, bg=bg,
            iterations=iterations,
            start_iteration=start_iteration, save_iterations=saves,
            log_every=args.log_every, eval_every=args.eval_every,
            duplicate_capacity=args.duplicate_capacity or None,
            use_semantics=args.semantics, seed=args.seed, callback=report,
            logger=logger, opt_state=opt_state, device=dev)
    finally:
        logger.close()

    ckpt_dir = os.path.join(args.model_path, "checkpoint",
                            f"iteration_{iterations}")
    save_checkpoint(ckpt_dir, state, init_optimizer(state), iterations,
                    sky_params=sky_params)
    print(f"saved {ckpt_dir}")
    return state, reports


if __name__ == "__main__":
    main()
