"""Stage-1 reconstruction loop (counterpart of ``streetunveiler_tpu/train/
loop.py``): camera order without replacement, the densify / prune /
opacity-reset schedule, the late phase (the gated per-class distortion
past ``semantic_dist_from_iter``) and the late semantic-aware prune, the
jointly trained sky, demand-driven duplicate capacity, held-out
evaluation, PLY saves and logging around ``train_step``. Multi-device
training (``train_scene_sharded``) comes with the multi-device slice.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..config import OptimizationParams
from ..device import resolve_device, strict_fp32
from ..models.gaussians import (SurfelState, densify_and_prune, prune_mask,
                                reset_opacity)
from ..ops.rasterizer.api import default_duplicate_capacity
from ..models.sky import render_sky
from ..renderer import render, round_capacity
from ..utils.semantics import SKY_BIT, VEGETATION_BIT
from .losses import psnr as psnr_fn
from .optim import adam_init
from .step import bin_step, init_optimizer, train_step


@dataclasses.dataclass
class TrainReport:
    iteration: int
    loss: float
    psnr: float
    n_alive: int
    iters_per_s: float
    overflow_frac: float = 0.0   # the window's last step overflowed
    test_psnr: float = float("nan")
    test_l1: float = float("nan")
    dup_capacity: int = 0        # duplicate capacity in effect


@torch.no_grad()
def _eval_view(state, cam, gt, bg, sky_params=None, duplicate_capacity=None,
               n_slabs: int = 1):
    """Render + PSNR/L1 for one held-out view, the sky composited behind
    the surfels when ``sky_params`` is given; with ``n_slabs > 1`` the
    view renders in that many row slabs (an exact crop each: the principal
    point moves up by the slab's first row), which bounds the duplicate
    stream's memory (``duplicate_capacity`` is then per slab). Returns
    (psnr, l1, overflow_any, demand_max) as host numbers."""
    def render_rows(camera):
        res = render(camera, state, bg,
                     duplicate_capacity=duplicate_capacity,
                     device=state.device)
        img = res.render
        if sky_params is not None:
            sky = render_sky(sky_params, camera.height, camera.width,
                             camera.K, torch.linalg.inv(camera.w2c))
            img = img + sky * (1.0 - res.rend_alpha)[..., None]
        return img, bool(res.overflow), int(res.demand)

    if n_slabs <= 1:
        img, ovf, dem = render_rows(cam)
    else:
        slab = -(-cam.height // n_slabs)
        parts, ovf, dem = [], False, 0
        for s in range(n_slabs):
            row0 = s * slab
            h = min(slab, cam.height - row0)
            if h <= 0:
                break
            k_slab = cam.K.clone()
            k_slab[1, 2] -= float(row0)
            part, o, d = render_rows(dataclasses.replace(cam, K=k_slab,
                                                         height=h))
            parts.append(part)
            ovf = ovf or o
            dem = max(dem, d)
        img = torch.cat(parts, dim=0)
    img = torch.clamp(img, 0.0, 1.0)
    return (float(psnr_fn(img, gt)), float(torch.mean(torch.abs(img - gt))),
            ovf, dem)


def _default_slab_capacity(n_surfels: int, width: int, height: int,
                           n_slabs: int) -> int:
    """Per-slab capacity: twice the even split of the full default."""
    full = default_duplicate_capacity(n_surfels, width, height)
    if n_slabs <= 1:
        return full
    return -(-(2 * full // n_slabs) // 128) * 128


def evaluate_views(state, cameras, images, bg, sky_params=None,
                   max_views: int = 8, duplicate_capacity=None,
                   n_slabs: int = 1):
    """Mean held-out PSNR/L1 over up to ``max_views`` cameras, on the
    state's device, with the sky composited when ``sky_params`` is given.
    A view whose duplicate stream overflows is rendered again at a
    demand-sized capacity (kept for the later views), so no truncated
    render is scored."""
    dev = state.device
    if sky_params is not None:
        sky_params = sky_params.to(dev)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    psnrs, l1s = [], []
    cap = duplicate_capacity
    for cam, img in list(zip(cameras, images))[:max_views]:
        if img is None:
            continue
        cam = cam.to(dev)
        gt = torch.as_tensor(np.asarray(img, np.float32), device=dev)
        eff = cap if cap is not None else _default_slab_capacity(
            state.capacity, cam.width, cam.height, n_slabs)
        p, l, ovf, dem = _eval_view(state, cam, gt, bg, sky_params,
                                    duplicate_capacity=eff, n_slabs=n_slabs)
        if ovf:
            cap = max(round_capacity(dem, headroom=1.2), cap or 0)
            p, l, _, _ = _eval_view(state, cam, gt, bg, sky_params,
                                    duplicate_capacity=cap, n_slabs=n_slabs)
        psnrs.append(p)
        l1s.append(l)
    if not psnrs:
        return float("nan"), float("nan")
    return float(np.mean(psnrs)), float(np.mean(l1s))


def train_scene(scene, state: SurfelState, opt: OptimizationParams,
                sky_params=None, bg=None, start_iteration: int = 0,
                iterations: Optional[int] = None,
                save_iterations=(), log_every: int = 200,
                duplicate_capacity: Optional[int] = None,
                use_semantics: bool = False,
                seed: int = 0, callback=None, logger=None,
                panel_every: int = 0, eval_every: int = 0,
                eval_max_views: int = 8, opt_state=None, sky_opt_state=None,
                device="cuda"):
    """Run the stage-1 loop on ``device`` (default the card; it raises
    without one unless ``device="cpu"``). Returns (state, sky_params,
    reports); ``sky_params`` (a ``SkyParams``) is trained jointly and
    updated in place. Pass ``opt_state``/``sky_opt_state`` from a loaded
    checkpoint to resume with its Adam moments. With a ``logger``, every
    ``panel_every`` iterations (0 = never) at a log point, the first
    camera's render goes to it as the panel ``panels/render``. Turns TF32
    off for matmuls
    and cuDNN convolutions (SSIM's blur, the sky's MLP), so the step
    computes in full float32.
    """
    dev = resolve_device(device)
    strict_fp32()
    iterations = iterations or opt.iterations
    state = state.to(dev)
    cams = [c.to(dev) for c in scene.train_cameras]
    images = [torch.as_tensor(np.asarray(img, np.float32), device=dev)
              for img in scene.train_images]
    semantics = None
    if use_semantics and opt.enable_semantic_loss:
        semantics = [None if s is None
                     else torch.as_tensor(np.asarray(s), device=dev)
                     for s in scene.train_semantics]
    n_cams = len(cams)
    # the reference sets the densify interval from the camera count
    densification_interval = max(1, int(1.15 * n_cams))

    bg = torch.zeros(3, device=dev) if bg is None else torch.as_tensor(
        bg, dtype=torch.float32, device=dev)
    opt_state = init_optimizer(state) if opt_state is None \
        else opt_state.to(dev)
    if sky_params is not None:
        sky_params = sky_params.to(dev)
        sky_opt_state = adam_init(sky_params) if sky_opt_state is None \
            else sky_opt_state.to(dev)

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    order: list[int] = []
    reports: list[TrainReport] = []
    t_window = time.perf_counter()
    window_iters = 0

    # demand-driven duplicate capacity: the init state's true demand over
    # a camera sample (exact at any probe capacity), with densification
    # headroom, before the first step
    dup_cap = duplicate_capacity
    if dup_cap is None:
        dup_cap = default_duplicate_capacity(state.capacity, cams[0].width,
                                             cams[0].height)
    need = 0
    for i in sorted({0, n_cams // 2, n_cams - 1}):
        b = bin_step(state, cams[i], duplicate_capacity=2048, device=dev)
        need = max(need, int(b.demand))
    if need * 1.15 > dup_cap:
        dup_cap = round_capacity(need, headroom=1.5)
        print(f"NOTE: init duplicate demand {need} exceeds capacity; "
              f"sized duplicate_capacity={dup_cap}", flush=True)

    metrics = None
    for iteration in range(start_iteration + 1, iterations + 1):
        if not order:
            order = list(rng.permutation(n_cams))
        idx = int(order.pop())

        gt_sem = semantics[idx] if semantics is not None else None
        binning = bin_step(state, cams[idx], duplicate_capacity=dup_cap,
                           device=dev)
        state, opt_state, sky_params, sky_opt_state, metrics = train_step(
            state, opt_state, cams[idx], images[idx], bg, iteration, opt,
            sky_params=sky_params, sky_opt_state=sky_opt_state,
            gt_semantic=gt_sem,
            class_dist=iteration > opt.semantic_dist_from_iter,
            duplicate_capacity=dup_cap, binning=binning, device=dev)
        window_iters += 1

        # densification
        if iteration < opt.densify_until_iter:
            if (iteration > opt.densify_from_iter
                    and iteration % densification_interval == 0):
                size_threshold = (opt.max_screen_size or None
                                  if iteration > opt.opacity_reset_interval
                                  else None)
                state, mu, nu = densify_and_prune(
                    state, opt_state.mu, opt_state.nu,
                    opt.densify_grad_threshold, opt.opacity_cull,
                    size_threshold, generator=gen,
                    percent_dense=opt.percent_dense)
                opt_state = opt_state._replace(mu=mu, nu=nu)
            if iteration % opt.opacity_reset_interval == 0:
                state, mu, nu = reset_opacity(state, opt_state.mu,
                                              opt_state.nu)
                opt_state = opt_state._replace(mu=mu, nu=nu)

        # late semantic-aware prune: low-opacity surfels go, except the
        # sky and vegetation classes
        if (opt.prune_from_iter < iteration < opt.prune_until_iter
                and iteration % opt.prune_interval == 0):
            low = state.get_opacity()[:, 0] < opt.prune_opacity
            protected = state.semantic_mask(SKY_BIT | VEGETATION_BIT)
            state = prune_mask(state, low & ~protected)

        if iteration in save_iterations and scene.model_path:
            scene.save(state, iteration)

        # overflow, read every 10 iterations: a truncated stream damages
        # the model, so the capacity grows to the measured demand × 1.5
        if iteration % 10 == 0 and bool(metrics["overflow"]):
            new_cap = round_capacity(int(metrics["demand"]), headroom=1.5)
            if new_cap > dup_cap:
                print(f"NOTE: duplicate stream overflowed at iteration "
                      f"{iteration}; raising duplicate_capacity "
                      f"{dup_cap} -> {new_cap}", flush=True)
                dup_cap = new_cap

        if iteration % log_every == 0 or iteration == iterations:
            # the window ends when the card has finished its steps, not
            # when the host has queued them
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t_window
            ovf = bool(metrics["overflow"])
            test_psnr, test_l1 = float("nan"), float("nan")
            if (eval_every and scene.test_cameras
                    and (iteration % eval_every == 0
                         or iteration == iterations)):
                test_psnr, test_l1 = evaluate_views(
                    state, scene.test_cameras, scene.test_images, bg,
                    sky_params=sky_params, max_views=eval_max_views,
                    duplicate_capacity=dup_cap)
            rep = TrainReport(iteration=iteration,
                              loss=float(metrics["loss"]),
                              psnr=float(metrics["psnr"]),
                              n_alive=int(metrics["n_alive"]),
                              iters_per_s=window_iters / max(dt, 1e-9),
                              overflow_frac=float(ovf),
                              test_psnr=test_psnr, test_l1=test_l1,
                              dup_capacity=dup_cap)
            reports.append(rep)
            if callback:
                callback(rep)
            if logger is not None:
                cam = cams[idx]
                scalars = {
                    "train/loss": rep.loss, "train/psnr": rep.psnr,
                    "train/l1": float(metrics["l1"]),
                    "train/ssim": float(metrics["ssim"]),
                    "train/semantic": float(metrics["semantic"]),
                    "model/n_alive": rep.n_alive,
                    "model/overflow": rep.overflow_frac,
                    "perf/iters_per_s": rep.iters_per_s,
                    "perf/rays_per_s": rep.iters_per_s * cam.width
                    * cam.height}
                if np.isfinite(rep.test_psnr):
                    scalars["test/psnr"] = rep.test_psnr
                    scalars["test/l1"] = rep.test_l1
                logger.scalars(iteration, scalars)
                if panel_every and iteration % panel_every == 0:
                    with torch.no_grad():
                        res = render(cams[0], state, bg,
                                     duplicate_capacity=dup_cap, device=dev)
                    logger.image(iteration, "panels/render",
                                 torch.clamp(res.render, 0.0, 1.0))
            t_window = time.perf_counter()
            window_iters = 0

    return state, sky_params, reports
