"""BASELINE config 2 end to end through the port's CLIs (counterpart of
the repo-root ``tools/e2e_config2.py``): train → render → unveil →
evaluate in one process, the reference pipeline's shape (``train.py`` →
``render.py`` → ``unveil.sh`` → ``eval_lpips_fid.sh``), at config 2's
scale: 100k initial surfels, 40 cameras at 800×600, the full training loop
with densification, one card. It asserts the held-out PSNR gate and writes
its record, with each stage's time, to ``docs/e2e_config2_torch.json``.

    python -m streetunveiler_torch.tools.e2e_config2 [--model_path DIR] \
        [--iterations N] [--device cuda]

Stages:
  1. train    — cli.train on the synthetic street, held-out views
                ``i % 8 == 0``, the densify/prune/reset schedule on;
  2. render   — cli.render: the test split and the TSDF mesh;
  3. unveil   — cli.unveil: every vehicle instance removed, the diffuse
                inpainter, the delta re-optimization;
  4. evaluate — LPIPS and Inception FID over ``final_renders`` against
                ``gt`` (``evaluation/lpips.py``, ``evaluation/inception.py``).

The evaluation networks run on deterministic random-init weights of the
real architectures' shapes (``np.random.default_rng(0)``, as the JAX tool
draws them), built as torch state dicts and written through the port's
weight writer (``tools/export_eval_weights.py``), the path real checkpoints
take. The LPIPS and FID values exercise the whole protocol but are not
comparable to published numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np

PSNR_GATE = 24.0   # held-out PSNR the trained scene must clear

VGG_CFG = ((64, 3), (64, 64), (128, 64), (128, 128), (256, 128), (256, 256),
           (256, 256), (512, 256), (512, 512), (512, 512), (512, 512),
           (512, 512), (512, 512))


def random_eval_state_dicts(seed: int = 0):
    """(vgg16 features state dict, LPIPS heads state dict, pytorch_fid
    InceptionV3 state dict) of random tensors, drawn from
    ``np.random.default_rng(seed)`` in the JAX tool's order."""
    import torch

    from ..evaluation.inception import conv_shapes
    from .export_eval_weights import VGG_CONV_IDS
    rng = np.random.default_rng(seed)

    def g(*s):
        return torch.from_numpy(rng.normal(0, 0.05, s).astype(np.float32))

    vgg = {}
    for c, (o, i) in zip(VGG_CONV_IDS, VGG_CFG):
        vgg[f"features.{c}.weight"] = g(o, i, 3, 3)
        vgg[f"features.{c}.bias"] = g(o)
    lins = {f"lin{i}.model.1.weight": torch.abs(g(1, c, 1, 1))
            for i, c in enumerate([64, 128, 256, 512, 512])}
    sd = {}
    for name, (o, i, kh, kw) in conv_shapes().items():
        sd[f"{name}.conv.weight"] = g(o, i, kh, kw)
        sd[f"{name}.bn.weight"] = torch.from_numpy(
            rng.uniform(0.5, 1.5, o).astype(np.float32))
        sd[f"{name}.bn.bias"] = g(o)
        sd[f"{name}.bn.running_mean"] = g(o)
        sd[f"{name}.bn.running_var"] = torch.from_numpy(
            rng.uniform(0.5, 1.5, o).astype(np.float32))
    return vgg, lins, sd


def make_eval_weights(out_dir: str, seed: int = 0):
    """Write the random-init artifacts through the weight writer's
    checkpoint path. Returns (lpips_vgg.npz, inception_fid.npz)."""
    import torch

    from .export_eval_weights import export_inception, export_lpips_from_pth
    vgg, lins, sd = random_eval_state_dicts(seed)
    vgg_pth = os.path.join(out_dir, "vgg16_synth.pth")
    lins_pth = os.path.join(out_dir, "lpips_lins_synth.pth")
    inc_pth = os.path.join(out_dir, "pt_inception_synth.pth")
    torch.save(vgg, vgg_pth)
    torch.save(lins, lins_pth)
    torch.save(sd, inc_pth)
    lpips_npz = os.path.join(out_dir, "lpips_vgg.npz")
    inc_npz = os.path.join(out_dir, "inception_fid.npz")
    export_lpips_from_pth(vgg_pth, lins_pth, lpips_npz)
    export_inception(inc_pth, inc_npz)
    return lpips_npz, inc_npz


# the launch counters of K3, K1 and K2 (ungated and gated), the record
# scatter and the conic cull
PATH_KERNELS = ("expand", "blend_fwd", "blend_bwd", "blend_fwd_gated",
                "blend_bwd_gated", "record_scatter", "cull")


def _kernel_launches():
    from .. import trace
    return {k: trace.launch_counts[k] for k in PATH_KERNELS}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", default=os.path.join(
        tempfile.gettempdir(), "e2e_config2_torch"))
    ap.add_argument("--iterations", type=int, default=1200)
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--cameras", type=int, default=40)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--reopt_iterations", type=int, default=300)
    ap.add_argument("--psnr_gate", type=float, default=PSNR_GATE,
                    help="held-out PSNR to clear (config 2's is 24.0)")
    # the unveil CLI's clustering and neighbourhood radii; its defaults
    # assume the reference's normalized units, which config 2 keeps
    ap.add_argument("--unveil_args", default="",
                    help="more unveil CLI flags, space-separated")
    ap.add_argument("--mesh_args", default="",
                    help="more render CLI flags, space-separated")
    ap.add_argument("--out", default="docs/e2e_config2_torch.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..cli.common import load_scene_info, scene_background
    from ..cli.render import main as render_main
    from ..cli.train import main as train_main
    from ..cli.unveil import main as unveil_main
    from ..config import load_config
    from ..device import resolve_device
    from ..evaluation.inception import inception_feature_fn
    from ..evaluation.metrics import evaluate_dirs, fid_from_dirs
    from ..scene.scene import Scene
    from ..train.loop import evaluate_views
    from ..utils.ply import state_from_ply
    from ..utils.semantics import CONCERNED_IND
    from .timing import card

    dev = resolve_device(args.device)
    mp = args.model_path
    # stale artifacts of an earlier run would steer the checkpoint and
    # workspace discovery: the gate always starts clean
    if os.path.isdir(mp):
        shutil.rmtree(mp)
    os.makedirs(mp, exist_ok=True)
    dev_flag = ["--device", str(dev)]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    record = {
        "config": "BASELINE config 2",
        "scene": f"synthetic street, {args.points} init pts, "
                 f"{args.cameras} cams @ {args.width}x{args.height}, "
                 f"holdout i%8==0",
        "device": card() if dev.type == "cuda" else "cpu",
        "iterations": args.iterations,
        "psnr_gate": args.psnr_gate,
        "command": "python -m streetunveiler_torch.tools.e2e_config2",
        "launches_by_stage": {},
    }
    synth = ["--synthetic_points", str(args.points),
             "--synthetic_cameras", str(args.cameras),
             "--synthetic_width", str(args.width),
             "--synthetic_height", str(args.height),
             # config 2's f = 700 at 800 px wide, the field of view kept
             "--synthetic_focal", str(700.0 * args.width / 800.0)]

    def stage(name, fn):
        before = _kernel_launches()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        record[f"{name}_s"] = round(time.perf_counter() - t0, 1)
        after = _kernel_launches()
        record["launches_by_stage"][name] = {
            k: after[k] - before[k] for k in after}
        return out

    # ---- stage 1: train (sh_degree 0: the synthetic ground truth is
    # Lambertian; densify and opacity resets until 1000, then refinement
    # on the fixed set, as the JAX tool's schedule)
    stage("train", lambda: train_main(
        ["--model_path", mp, "--scene", "synthetic", "--eval",
         "--iterations", str(args.iterations),
         "--capacity", str(int(args.points * 2.0)),
         "--sh_degree", "0", "--max_screen_size", "100",
         "--densify_until_iter", "1000", "--eval_every", "500",
         "--log_every", "100",
         "--save_every", str(args.iterations)] + synth + dev_flag))

    # held-out PSNR of the trained checkpoint (the gate) and of the init
    cfg = load_config(mp)
    info = load_scene_info(cfg["model"], device=dev)
    scene = Scene(info, model_path=mp, device=dev)
    bg = scene_background(scene, device=dev)
    init_psnr, _ = evaluate_views(
        scene.create_state(capacity=int(args.points * 2.0), sh_degree=0),
        scene.test_cameras, scene.test_images, bg)
    state = scene.load(args.iterations)
    test_psnr, test_l1 = evaluate_views(state, scene.test_cameras,
                                        scene.test_images, bg)
    record.update(init_test_psnr=round(float(init_psnr), 2),
                  test_psnr=round(float(test_psnr), 2),
                  test_l1=round(float(test_l1), 4),
                  n_surfels_trained=int(state.num_alive))
    print(f"[e2e] held-out PSNR {test_psnr:.2f} (init {init_psnr:.2f}, "
          f"gate {args.psnr_gate})", flush=True)
    assert test_psnr > args.psnr_gate, (test_psnr, args.psnr_gate)
    assert test_psnr > init_psnr + 1.0, "training must beat the init render"

    # ---- stage 2: render the held-out views, then the TSDF mesh
    summary = stage("render_mesh", lambda: render_main(
        ["--model_path", mp, "--skip_train",
         "--iteration", str(args.iterations)] + args.mesh_args.split()
        + dev_flag))
    mesh_path = os.path.join(mp, "train", f"ours_{args.iterations}",
                             "fuse.ply")
    assert os.path.exists(mesh_path), \
        "TSDF mesh extraction must produce fuse.ply"
    record["mesh_bytes"] = os.path.getsize(mesh_path)
    record["render_mesh_split_s"] = {
        k: round(float(summary[k]), 2)
        for k in ("fusion_s", "surface_nets_s", "clusters_s")
        if k in summary}

    # ---- stage 3: unveil (every vehicle; the diffuse inpainter)
    unveiled = stage("unveil", lambda: unveil_main(
        ["--model_path", mp, "--semantic_class", "vehicle", "--all",
         "--key_stride", "4",
         "--reopt_iterations", str(args.reopt_iterations)]
        + args.unveil_args.split() + dev_flag))
    record["unveil_split_s"] = {k: round(float(v), 2) for k, v in
                                unveiled["stage_s"].items()}
    ws = os.path.join(mp, "instance_workspace_1")
    st1 = state_from_ply(os.path.join(ws, "checkpoint", "point_cloud.ply"),
                         spatial_scale=scene.cameras_extent, device=dev)
    veh_bit = 1 << CONCERNED_IND["vehicle"]
    n_veh_before = int(torch.sum(state.semantic_mask(veh_bit) & state.alive))
    n_veh_after = int(torch.sum(st1.semantic_mask(veh_bit) & st1.alive))
    record.update(vehicles_before=n_veh_before, vehicles_after=n_veh_after)
    assert n_veh_after < n_veh_before, "unveil must remove vehicle surfels"

    # ---- stage 4: LPIPS and FID over final_renders against gt
    def evaluate():
        lpips_npz, inc_npz = make_eval_weights(mp)
        ev = evaluate_dirs(os.path.join(ws, "final_renders"),
                           os.path.join(ws, "gt"), lpips_weights=lpips_npz,
                           device=dev)
        fid = fid_from_dirs(os.path.join(ws, "final_renders"),
                            os.path.join(ws, "gt"),
                            inception_feature_fn(inc_npz, device=dev))
        return ev, fid
    ev, fid = stage("evaluate", evaluate)
    record["unveil_eval"] = {
        **{k: (round(v, 4) if isinstance(v, float) else v)
           for k, v in ev.items()},
        "fid": round(float(fid), 4),
        "weight_provenance": "deterministic random-init (no published "
                             "checkpoint in reach; NOT comparable to "
                             "published values — see module docstring)",
    }

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record, indent=1), flush=True)
    print(f"[e2e] PASS — wrote {args.out}", flush=True)
    return record


if __name__ == "__main__":
    main()
