"""Unveil CLI (counterpart of ``streetunveiler_tpu/cli/unveil.py``): the
reference's four-stage chain in one command, each stage re-runnable from
its files.

    python -m streetunveiler_torch.cli.unveil --model_path /tmp/model \
        --semantic_class vehicle --all [--device cuda]

Stages: A selects instances (clusters and per-instance preview renders) →
B writes removal masks and the per-frame inpaint conditions → C inpaints
and re-optimizes the masked deltas → final renders into
``instance_workspace_<round>/``. A second run starts from the newest
unveiled round (round chaining).

``--inpainter`` picks the 2D model: ``diffuse`` (the built-in fill) or
``dir:<path>`` (the out-of-band file exchange, where a host running the
real models answers requests; ``pipeline/inpaint.py``). The in-process
ZITS++ and LeftRefill adapters (``zits:``, ``leftrefill:``) are not ported
yet and are refused. Runs on the card by default (``--device cpu`` for
the CPU).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def make_inpainter(spec: str, timeout: float = 600.0, device="cuda"):
    from ..pipeline.inpaint import DiffuseFillInpainter, DirectoryInpainter
    if spec == "diffuse":
        return DiffuseFillInpainter(device=device)
    if spec.startswith("dir:"):
        return DirectoryInpainter(spec[4:], timeout=timeout,
                                  fallback=DiffuseFillInpainter(
                                      device=device))
    if spec.startswith(("zits:", "leftrefill:")):
        raise SystemExit(
            f"the {spec.split(':')[0]} inpainter is not ported to the "
            "PyTorch build yet: its adapter comes with the rest of the "
            "unveil slice, item 13's remainder (ROADMAP.md); use 'diffuse' "
            "or 'dir:<path>'")
    raise ValueError(f"unknown inpainter spec {spec!r} (expected 'diffuse' "
                     "or 'dir:<path>')")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--semantic_class", default="vehicle")
    ap.add_argument("--instances", type=int, nargs="*", default=None,
                    help="instance ids to remove (pick from the stage-A "
                         "instance_render previews); omit with --all")
    ap.add_argument("--all", action="store_true",
                    help="remove every solid cluster")
    ap.add_argument("--cluster_threshold", type=float, default=None,
                    help="instance clustering distance (defaults to 7e-2, "
                         "which assumes normalized scene units; scale to "
                         "~1%% of the scene extent otherwise)")
    ap.add_argument("--min_cluster_size", type=int, default=None,
                    help="clusters below this many surfels are not solid "
                         "(default: pipeline/select.MIN_SOLID_CLUSTER)")
    ap.add_argument("--trainable_dist", type=float, default=None,
                    help="neighbourhood radius of the re-optimized surfels "
                         "around the removed ones (defaults to 4e-2, which "
                         "assumes normalized scene units like "
                         "--cluster_threshold; scale it with the scene "
                         "otherwise)")
    ap.add_argument("--editable_dist", type=float, default=None,
                    help="neighbourhood radius of the surfels hidden from "
                         "the inpaint conditions (defaults to 2e-2)")
    ap.add_argument("--key_stride", type=int, default=4,
                    help="every k-th frame is a key frame")
    ap.add_argument("--reopt_iterations", type=int, default=1000)
    ap.add_argument("--inpainter", default="diffuse",
                    help="'diffuse' or 'dir:<exchange-dir>'")
    ap.add_argument("--inpaint_timeout", type=float, default=600.0)
    ap.add_argument("--select_only", action="store_true",
                    help="stop after stage A so instance ids can be chosen "
                         "from the preview renders")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..config import ReOptimizationParams, load_config
    from ..device import resolve_device, strict_fp32
    from ..models.sky import render_sky
    from ..pipeline.masks import (EDITABLE_DIST, TRAINABLE_DIST,
                                  include_neighbor_pcd,
                                  write_inpaint_conditions)
    from ..pipeline.reoptimize import unveil
    from ..pipeline.select import (MIN_SOLID_CLUSTER,
                                   cluster_semantic_instance,
                                   removal_mask_for_instances,
                                   render_instance_previews)
    from ..renderer import measure_duplicate_capacity, render
    from ..scene.scene import Scene
    from ..train.checkpoint import (latest_unveiled_checkpoint,
                                    load_sky_for_iteration,
                                    search_max_inpaint_round,
                                    search_max_iteration)
    from ..utils.ply import state_from_ply, state_to_ply
    from ..utils.semantics import CONCERNED_IND
    from .common import load_scene_info, scene_background

    dev = resolve_device(args.device)
    strict_fp32()
    inpainter = make_inpainter(args.inpainter, timeout=args.inpaint_timeout,
                               device=dev)
    cfg = load_config(args.model_path)
    model = cfg["model"]
    info = load_scene_info(model, seed=args.seed, device=dev)
    scene = Scene(info, model_path=args.model_path,
                  resolution=model.resolution, device=dev)

    iteration = args.iteration
    if iteration < 0:
        iteration = search_max_iteration(
            os.path.join(args.model_path, "point_cloud"))

    # round chaining: round r starts from round r−1's unveiled checkpoint,
    # so a second run removes its class from the already unveiled scene
    prev_ply = latest_unveiled_checkpoint(args.model_path)
    if prev_ply is not None:
        # the PLY carries no spatial scale; a rerun with another
        # resolution or config would change it silently
        saved_extent = cfg.get("scene", {}).get("cameras_extent")
        if saved_extent is not None and abs(
                scene.cameras_extent - saved_extent) > 1e-4 * abs(
                    saved_extent):
            raise SystemExit(
                f"scene cameras_extent {scene.cameras_extent} differs from "
                f"the training-time value {saved_extent} persisted in "
                f"cfg_args.json — rerun with the training resolution/config "
                f"or retrain before chaining unveil rounds")
        state = state_from_ply(prev_ply, spatial_scale=scene.cameras_extent,
                               device=dev)
        print(f"chaining from unveiled checkpoint {prev_ply}")
    else:
        state = scene.load(iteration)

    rnd = search_max_inpaint_round(args.model_path) + 1
    ws = os.path.join(args.model_path, f"instance_workspace_{rnd}")
    os.makedirs(ws, exist_ok=True)

    # demand-measured duplicate capacity: a truncated stream silently
    # drops the farthest surfels from every render, mask and step
    dup_cap = measure_duplicate_capacity(scene.train_cameras, state,
                                         device=dev)
    print(f"duplicate capacity (measured): {dup_cap}")

    # the trained sky, composited into the conditions and final renders
    sky_params = load_sky_for_iteration(args.model_path, iteration,
                                        device=dev)
    sky_images = None
    if sky_params is not None:
        with torch.no_grad():
            sky_images = [render_sky(sky_params, c.height, c.width, c.K,
                                     torch.linalg.inv(c.w2c))
                          for c in scene.train_cameras]

    # ---- stage A: selection and per-instance previews
    class_bit = 1 << CONCERNED_IND[args.semantic_class]
    min_size = args.min_cluster_size or MIN_SOLID_CLUSTER
    cl = cluster_semantic_instance(state, class_bit,
                                   threshold=args.cluster_threshold)
    np.save(os.path.join(ws, "cluster_labels.npy"), cl.labels)
    solid = render_instance_previews(
        scene, state, cl, ws, min_size=min_size,
        close_depth=max(4.0, 0.3 * scene.cameras_extent),
        duplicate_capacity=dup_cap, device=dev)
    print(f"stage A: {len(cl.cluster_sizes)} clusters "
          f"(top sizes {cl.cluster_sizes[:5]}), "
          f"{int(solid.sum())} surfels in solid clusters; previews in "
          f"{os.path.join(ws, 'instance_render')}")
    summary = dict(round=rnd, workspace=ws, clusters=len(cl.cluster_sizes),
                   solid=int(solid.sum()), duplicate_capacity=dup_cap)
    if args.select_only:
        print("stage A only (--select_only): rerun with --instances <ids> "
              "or --all")
        return summary

    # ---- stage B: removal and neighbourhood masks, condition artifacts
    removal = removal_mask_for_instances(
        cl, args.instances or [], all_solid=args.all or not args.instances,
        min_size=min_size)
    masks = include_neighbor_pcd(
        state, removal, editable_dist=args.editable_dist or EDITABLE_DIST,
        trainable_dist=args.trainable_dist or TRAINABLE_DIST)
    np.save(os.path.join(ws, "removed_pcd_mask.npy"), masks.removed)
    np.save(os.path.join(ws, "trainable_pcd_mask.npy"), masks.trainable)
    np.save(os.path.join(ws, "editable_pcd_mask.npy"), masks.editable)
    # stages B and C touch only the front cameras of a multi-camera rig
    n_cams = len(scene.train_cameras)
    fs = int(scene.camera_frame_dict.get("front_start", 0))
    fe = int(scene.camera_frame_dict.get("front_end", n_cams))
    front_frames = list(range(fs, fe))

    bg = scene_background(scene, device=dev)
    frame_masks = write_inpaint_conditions(scene, state, masks.removed, ws,
                                           bg, sky_images=sky_images,
                                           frames=front_frames,
                                           duplicate_capacity=dup_cap,
                                           device=dev)
    print(f"stage B: removing {int(removal.sum())} surfels, "
          f"{int(masks.trainable.sum())} trainable; conditions in {ws} "
          f"(front frames {fs}..{fe - 1})")

    # ---- stage C: inpaint and delta re-optimization over the front
    # range, its last frame the propagation boundary
    key_frames = list(range(fs, fe, args.key_stride))
    if key_frames and key_frames[-1] != fe - 1:
        key_frames.append(fe - 1)
    opt = ReOptimizationParams(iterations=args.reopt_iterations)
    losses = []
    final, deltas, targets = unveil(scene, state, masks, key_frames, inpainter,
                               opt=opt, sky_images=sky_images,
                               frame_masks=frame_masks, seed=args.seed,
                               duplicate_capacity=dup_cap,
                               callback=lambda f, loss, _: losses.append(
                                   loss), device=dev)

    out = os.path.join(ws, "checkpoint")
    state_to_ply(os.path.join(out, "point_cloud.ply"), final)

    # final renders for evaluation, the sky composited
    from PIL import Image
    rd = os.path.join(ws, "final_renders")
    gtd = os.path.join(ws, "gt")
    os.makedirs(rd, exist_ok=True)
    os.makedirs(gtd, exist_ok=True)
    for i, cam in enumerate(scene.train_cameras):
        with torch.no_grad():
            res = render(cam, final, bg, duplicate_capacity=dup_cap,
                         device=dev)
            img = res.render
            if sky_images is not None:
                img = img + sky_images[i] * (1.0 - res.rend_alpha)[..., None]
        img = np.clip(img.cpu().numpy(), 0, 1)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(rd, f"{i:05d}.png"))
        if scene.train_images[i] is not None:
            Image.fromarray((np.asarray(scene.train_images[i]) * 255
                             ).astype(np.uint8)).save(
                os.path.join(gtd, f"{i:05d}.png"))
    print(f"stage C: unveiled state at {out}; renders in {rd}; final loss "
          f"{losses[-1] if losses else float('nan'):.5f}")
    train_mask = torch.as_tensor(masks.trainable & ~masks.removed,
                                 device=dev)
    moved = (deltas.xyz[train_mask] != 0).any(dim=1)
    summary.update(
        removed=int(masks.removed.sum()), trainable=int(masks.trainable.sum()),
        trained=int(train_mask.sum()), moved=int(moved.sum()),
        mask_pixels={int(f): int(m.sum()) for f, m in frame_masks.items()},
        inpainted_frames=sorted(int(f) for f in targets),
        losses=losses, alive=int(final.num_alive))
    return summary


if __name__ == "__main__":
    main()
