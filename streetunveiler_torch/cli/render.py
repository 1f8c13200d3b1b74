"""Render CLI (counterpart of ``streetunveiler_tpu/cli/render.py``):

    python -m streetunveiler_torch.cli.render --model_path /tmp/model \
        [--semantics] [--mesh_res 512] [--device cuda]

Renders the train and test views of the newest checkpoint (or
``--iteration N``; the newest unveiled round's checkpoint when one exists,
unless ``--base``): RGB with the trained sky composited behind the
surfels, depth, world-space normals and, with ``--semantics``, the
semantic argmax, as PNGs under ``<model_path>/{train,test}/ours_<iter>/
{renders,gt,depth,normal,semantic}/`` with the per-split mean PSNR. Then
it TSDF-fuses every third train view into ``train/ours_<iter>/fuse.ply``
and its large-component filter ``fuse_post.ply`` (``--skip_mesh`` to
skip). Runs on the card by default (``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def _save_png(path, img):
    from PIL import Image
    if torch.is_tensor(img):
        img = img.detach().cpu().numpy()
    Image.fromarray((np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)
                    ).save(path)


@torch.no_grad()
def render_view(cam, state, bg, sky_params=None, duplicate_capacity=None,
                semantics: bool = False, device="cuda"):
    """One view as the render CLI writes it: (image [H, W, 3] with the sky
    composited as ``img + sky·(1 − α)``, surface depth [H, W], world-space
    normals [H, W, 3], semantic probabilities [H, W, 6] or None), tensors
    on ``device``. While tracing: the range ``view`` and its stages
    ``view.render``, ``view.sky``, ``view.normals``, ``view.semantic``."""
    from .. import trace
    from ..models.sky import render_sky
    from ..renderer import render, render_semantic
    with trace.span("view"):
        with trace.span("view.render"):
            res = render(cam, state, bg,
                         duplicate_capacity=duplicate_capacity,
                         device=device)
        img = res.render
        if sky_params is not None:
            with trace.span("view.sky"):
                sky = render_sky(sky_params, cam.height, cam.width, cam.K,
                                 torch.linalg.inv(cam.w2c))
                img = img + sky * (1.0 - res.rend_alpha)[..., None]
        with trace.span("view.normals"):
            nrm = res.rend_normal_world(cam)
        sem = None
        if semantics:
            with trace.span("view.semantic"):
                sem = render_semantic(cam, state,
                                      duplicate_capacity=duplicate_capacity,
                                      device=device)
        return img, res.surf_depth, nrm, sem


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--skip_train", action="store_true")
    ap.add_argument("--skip_test", action="store_true")
    ap.add_argument("--skip_mesh", action="store_true")
    ap.add_argument("--semantics", action="store_true")
    ap.add_argument("--voxel_size", type=float, default=0.05,
                    help="TSDF voxel size (scene units)")
    ap.add_argument("--mesh_res", type=int, default=0,
                    help="if >0, derive voxel size from bounds/res")
    ap.add_argument("--depth_ratio", type=float, default=0.0)
    ap.add_argument("--base", action="store_true",
                    help="render the base training checkpoint even when "
                         "unveiled rounds exist")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..config import load_config
    from ..device import resolve_device, strict_fp32
    from ..mesh import (estimate_bounds, fuse_views, keep_large_clusters,
                        volume_mesh)
    from ..ops.tsdf import save_mesh_ply
    from ..renderer import measure_duplicate_capacity
    from ..scene.scene import Scene
    from ..train.checkpoint import (latest_unveiled_checkpoint,
                                    load_sky_for_iteration,
                                    search_max_iteration)
    from ..train.losses import psnr
    from ..utils.ply import state_from_ply
    from ..utils.semantics import CONCERNED_COLORS
    from .common import load_scene_info, scene_background

    dev = resolve_device(args.device)
    strict_fp32()
    cfg = load_config(args.model_path)
    model = cfg["model"]
    info = load_scene_info(model, seed=args.seed, device=dev)
    scene = Scene(info, model_path=args.model_path,
                  resolution=model.resolution, device=dev)

    iteration = args.iteration
    if iteration < 0:
        iteration = search_max_iteration(
            os.path.join(args.model_path, "point_cloud"))
        if iteration is None:
            raise SystemExit(f"no point_cloud/iteration_N under "
                             f"{args.model_path}")
    # the newest unveiled round when one exists (cameras and sky still
    # come from the model dir); --base renders the training checkpoint
    unveiled = None if args.base else \
        latest_unveiled_checkpoint(args.model_path)
    if unveiled is not None:
        state = state_from_ply(unveiled, spatial_scale=scene.cameras_extent,
                               device=dev)
        print(f"loaded unveiled checkpoint {unveiled}: "
              f"{int(state.num_alive)} surfels")
    else:
        state = scene.load(iteration)
        print(f"loaded iteration {iteration}: "
              f"{int(state.num_alive)} surfels")

    # the trained sky, composited behind the surfels when the checkpoint
    # holds one
    sky_params = load_sky_for_iteration(args.model_path, iteration,
                                        device=dev)
    bg = scene_background(scene, model.white_background, device=dev)

    # demand-measured duplicate capacity: a trained state easily exceeds
    # the default, and a truncated stream drops the farthest surfels
    dup_cap = measure_duplicate_capacity(scene.train_cameras, state,
                                         device=dev)
    print(f"duplicate capacity (measured): {dup_cap}")
    summary = {"iteration": iteration, "unveiled": unveiled,
               "duplicate_capacity": dup_cap}

    def render_split(split, cameras, images):
        out_dir = os.path.join(args.model_path, split, f"ours_{iteration}")
        for sub in ["renders", "gt", "depth", "normal", "semantic"]:
            os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
        psnrs = []
        for i, cam in enumerate(cameras):
            img, depth_v, nrm, sem = render_view(
                cam, state, bg, sky_params, dup_cap, args.semantics, dev)
            img = torch.clamp(img, 0, 1)
            _save_png(os.path.join(out_dir, "renders", f"{i:05d}.png"), img)
            gt = images[i] if i < len(images) else None
            if gt is not None:
                _save_png(os.path.join(out_dir, "gt", f"{i:05d}.png"), gt)
                psnrs.append(float(psnr(img, torch.as_tensor(
                    np.asarray(gt, np.float32), device=dev))))
            d = depth_v.cpu().numpy()
            _save_png(os.path.join(out_dir, "depth", f"{i:05d}.png"),
                      np.repeat((d / max(d.max(), 1e-6))[..., None], 3, -1))
            _save_png(os.path.join(out_dir, "normal", f"{i:05d}.png"),
                      nrm * 0.5 + 0.5)
            if sem is not None:
                sem_rgb = CONCERNED_COLORS[sem.argmax(-1).cpu().numpy()]
                _save_png(os.path.join(out_dir, "semantic", f"{i:05d}.png"),
                          sem_rgb / 255.0)
        if psnrs:
            print(f"{split}: mean PSNR over {len(psnrs)} views: "
                  f"{np.mean(psnrs):.2f} dB")
        print(f"wrote {out_dir}")
        summary[f"{split}_psnr"] = float(np.mean(psnrs)) if psnrs else None
        summary[f"{split}_views"] = len(cameras)

    if not args.skip_train:
        render_split("train", scene.train_cameras, scene.train_images)
    if not args.skip_test and scene.test_cameras:
        render_split("test", scene.test_cameras, scene.test_images)

    if not args.skip_mesh:
        mesh_dir = os.path.join(args.model_path, "train",
                                f"ours_{iteration}")
        os.makedirs(mesh_dir, exist_ok=True)
        # the reference fuses every third train camera
        fuse_cams = scene.train_cameras[::3]
        voxel = args.voxel_size
        if args.mesh_res > 0:
            lo, hi = estimate_bounds(state)
            voxel = float(np.max(hi - lo) / args.mesh_res)
        t0 = time.perf_counter()
        vol = fuse_views(fuse_cams, state, bg=bg, voxel_size=voxel,
                         depth_ratio=args.depth_ratio,
                         duplicate_capacity=dup_cap, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        verts, faces, colors = volume_mesh(vol)
        del vol
        t2 = time.perf_counter()
        save_mesh_ply(os.path.join(mesh_dir, "fuse.ply"), verts, faces,
                      colors)
        if faces.shape[0]:
            pv, pf, pc = keep_large_clusters(verts, faces, colors, 0.02)
        else:
            pv, pf, pc = verts, faces, colors
        t3 = time.perf_counter()
        save_mesh_ply(os.path.join(mesh_dir, "fuse_post.ply"), pv, pf, pc)
        print(f"mesh: {verts.shape[0]} verts / {faces.shape[0]} faces → "
              f"{os.path.join(mesh_dir, 'fuse.ply')} (+ fuse_post.ply: "
              f"{pv.shape[0]} / {pf.shape[0]}); voxel {voxel:.4g}, fusion "
              f"{t1 - t0:.2f} s, surface nets {t2 - t1:.2f} s, clusters "
              f"{t3 - t2:.2f} s")
        summary.update(
            voxel_size=voxel, mesh_vertices=int(verts.shape[0]),
            mesh_faces=int(faces.shape[0]),
            post_vertices=int(pv.shape[0]), post_faces=int(pf.shape[0]),
            fusion_s=t1 - t0, surface_nets_s=t2 - t1, clusters_s=t3 - t2)
    return summary


if __name__ == "__main__":
    main()
