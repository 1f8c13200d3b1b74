"""One full late-phase sharded training step on an n-rank mesh (the
counterpart of ``__graft_entry__.dryrun_multichip``), and the rank entries
that run a sharded step or the sharded loop from a saved bundle and save
what they produce (the CPU tests spawn gloo ranks on them, so that a rank
imports nothing but the port).

    python -m streetunveiler_torch.parallel.dryrun --devices 4 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..config import OptimizationParams
from .multihost import launch_local


def _rank_device(device_type: str) -> torch.device:
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def tiny_state(n=96, capacity=128, seed=0, device="cuda"):
    """The dryrun's surfels: ``n`` random points in front of the camera
    (``__graft_entry__._tiny_state``'s draws)."""
    from ..models.gaussians import create_from_pcd
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(3, 9, n)], 1).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    sem = rng.integers(0, 6, n)
    return create_from_pcd(pts, cols, sem, spatial_scale=4.0,
                           capacity=capacity, sh_degree=3, device=device)


def dryrun_rank(n_devices: int, device_type: str) -> float:
    """This rank's part of the dryrun: a (2 × n/2) mesh when n is even,
    else (1 × n); W 32, H 16 per tile slab, one camera per ``data`` row;
    the full late-phase step (photometric, normal, distortion, semantic
    cross entropy and the gated per-class distortion). Returns the loss."""
    from ..train.step import init_optimizer
    from .multihost import make_global_batch
    from .shard import make_mesh, make_sharded_train_step
    dev = _rank_device(device_type)
    n_data = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_tile = n_devices // n_data
    mesh = make_mesh(n_data, n_tile, dev)
    W, H, f = 32, 16 * n_tile, 30.0
    state = tiny_state(n=48, capacity=64, device=dev)
    opt_state = init_optimizer(state)
    opt = OptimizationParams()
    step = make_sharded_train_step(mesh, opt, W, H,
                                   duplicate_capacity=128 * 64,
                                   semantics=True, class_dist=True)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    w2c_b, k_b, gt_b, sem_b = make_global_batch(
        mesh, np.eye(4, dtype=np.float32)[None], K[None],
        np.zeros((1, H, W, 3), np.float32), np.zeros((1, H, W), np.int32),
        device=dev)
    state, opt_state, metrics = step(
        state, opt_state, w2c_b, k_b, gt_b, torch.zeros(3),
        opt.semantic_dist_from_iter + 1, sem_b)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    if dist.get_rank() == 0:
        print(f"dryrun_multichip({n_devices}): mesh=({n_data}x{n_tile}) "
              f"loss={loss:.4f} ok", flush=True)
    return loss


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One late-phase sharded step on ``n_devices`` ranks: in this process
    group when it has that many ranks, else on ranks started here."""
    dtype = torch.device(device).type
    if dist.is_initialized() and dist.get_world_size() == n_devices:
        dryrun_rank(n_devices, dtype)
    else:
        launch_local(dryrun_rank, n_devices, dtype, (n_devices, dtype))


# --------------------------------------------------------- saved bundles

def run_step_bundles(cases) -> None:
    """Rank entry: ``run_step_bundle(*case)`` for each case in turn."""
    for case in cases:
        run_step_bundle(*case)


def run_step_bundle(in_path: str, out_dir: str, n_data: int, n_tile: int,
                    flags: dict) -> None:
    """Rank entry: one sharded step from a ``torch.save`` bundle (``state``,
    ``opt_state``, the global ``w2c`` [B,4,4], ``K``, ``gt`` [B,H,W,3],
    ``gt_sem`` or None, ``bg``, ``iteration``, ``sky`` or None, ``opt``
    overrides) with ``make_sharded_train_step(**flags)``; every rank saves
    the whole updated state, moments, sky and metrics to
    ``out_dir/rank{r}.pt``."""
    from .multihost import data_slice, make_global_batch
    from .shard import gather_surfels, make_mesh, make_sharded_train_step
    from .shard import shard_surfels as shard_rows
    b = torch.load(in_path, weights_only=False)
    dev = _rank_device(dist.get_backend() == "nccl" and "cuda" or "cpu")
    mesh = make_mesh(n_data, n_tile, dev)
    state, opt_state = b["state"].to(dev), b["opt_state"].to(dev)
    h, w = b["gt"].shape[1:3]
    step = make_sharded_train_step(mesh, OptimizationParams(**b.get(
        "opt", {})), w, h, **flags)
    sl = data_slice(mesh, b["w2c"].shape[0])
    arrays = make_global_batch(
        mesh, b["w2c"][sl], b["K"][sl], b["gt"][sl],
        None if b["gt_sem"] is None else b["gt_sem"][sl], device=dev)
    zero = flags.get("shard_surfels", False)
    if zero:
        state, opt_state = shard_rows(mesh, state, opt_state)
    args = (state, opt_state, *arrays[:3], b["bg"], b["iteration"],
            arrays[3] if len(arrays) > 3 else None)
    if flags.get("sky", False):
        sky = b["sky"].to(dev)
        from ..train.optim import adam_init
        sky_opt = adam_init(sky)
        state, opt_state, sky, sky_opt, metrics = step(*args, sky, sky_opt)
    else:
        state, opt_state, metrics = step(*args)
        sky = None
    if zero:
        state, opt_state = gather_surfels(mesh, state, opt_state)
    torch.save({"state": state.to("cpu"), "opt_state": opt_state.to("cpu"),
                "sky": None if sky is None else sky.to("cpu"),
                "metrics": {k: torch.as_tensor(v).cpu()
                            for k, v in metrics.items()}},
               os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))


def run_loop_bundles(cases) -> None:
    """Rank entry: ``run_loop_bundle(*case)`` for each case in turn."""
    for case in cases:
        run_loop_bundle(*case)


def run_loop_bundle(spec: dict, out_dir: str) -> None:
    """Rank entry: ``train_scene_sharded`` on synthetic street scenes
    (``spec["scenes"]``: ``make_synthetic_street`` keyword sets, their
    cameras pooled), the state from the first scene (``spec["capacity"]``),
    ``spec["opt"]`` overrides and ``spec["loop"]`` keywords (``n_tile``,
    ``n_data``, ...); every rank saves its reports and its final state to
    ``out_dir/rank{r}.pt``."""
    from types import SimpleNamespace

    from ..models.sky import init_sky
    from ..scene.readers import make_synthetic_street
    from ..scene.scene import Scene
    from ..train.loop import train_scene_sharded
    dev = _rank_device(dist.get_backend() == "nccl" and "cuda" or "cpu")
    scenes = [Scene(make_synthetic_street(**kw, device=dev), device=dev)
              for kw in spec["scenes"]]
    if len(scenes) == 1:
        scene = scenes[0]
    else:
        scene = SimpleNamespace(
            train_cameras=sum((s.train_cameras for s in scenes), []),
            train_images=sum((s.train_images for s in scenes), []),
            train_semantics=sum((s.train_semantics for s in scenes), []),
            test_cameras=[], test_images=[], model_path=None)
    state = scenes[0].create_state(capacity=spec["capacity"])
    xyz0 = state.params.xyz.clone()   # the loop updates it in place
    sky = (init_sky(torch.Generator().manual_seed(0), device=dev)
           if spec.get("sky") else None)
    state2, sky2, reps = train_scene_sharded(
        scene, state, OptimizationParams(**spec.get("opt", {})),
        sky_params=sky, device=dev, **spec["loop"])
    torch.save({"reports": [dataclasses.asdict(r) for r in reps],
                "xyz0": xyz0.cpu(), "state": state2.to("cpu"),
                "sky_moved": (None if sky is None else any(
                    not torch.equal(a, b) for a, b in zip(
                        init_sky(torch.Generator().manual_seed(0),
                                 device=dev).named_tensors().values(),
                        sky2.named_tensors().values())))},
               os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.devices, args.device)


if __name__ == "__main__":
    main()
