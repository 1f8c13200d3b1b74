"""Stage-1 reconstruction loop (counterpart of ``streetunveiler_tpu/train/
loop.py``): camera order without replacement, the densify / prune /
opacity-reset schedule, the late phase (the gated per-class distortion
past ``semantic_dist_from_iter``) and the late semantic-aware prune, the
jointly trained sky, demand-driven duplicate capacity, held-out
evaluation, PLY saves and logging around ``train_step``; and
``train_scene_sharded``, the same loop over a ``("data", "tile")`` mesh of
ranks (``parallel/shard.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import trace
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


class _Schedule:
    """What both stage-1 loops do around their steps: the densify, opacity
    reset and semantic prune schedule, PLY saves, the duplicate-capacity
    check and the log window's report. ``whole`` maps this rank's
    (state, opt_state) to the whole ones (a collective under ZeRO) and
    ``reshard`` maps them back; both are the identity on one device. Only a
    ``writer`` saves PLYs."""

    def __init__(self, scene, opt, n_cams, dev, seed, iterations,
                 save_iterations, log_every, eval_every, eval_max_views,
                 callback, logger, whole=None, reshard=None, writer=True):
        self.scene, self.opt, self.dev = scene, opt, dev
        # the reference sets the densify interval from the camera count
        self.interval = max(1, int(1.15 * n_cams))
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed)
        self.iterations, self.save_iterations = iterations, save_iterations
        self.log_every, self.eval_every = log_every, eval_every
        self.eval_max_views = eval_max_views
        self.callback, self.logger, self.writer = callback, logger, writer
        self.whole = whole or (lambda st, os_: (st, os_))
        self.reshard = reshard or (lambda st, os_: (st, os_))
        self.reports: list[TrainReport] = []
        self.t_window = time.perf_counter()
        self.window_iters = 0

    def after_step(self, iteration, state, opt_state):
        """Densify, reset, prune and save after step ``iteration``."""
        opt = self.opt
        self.window_iters += 1
        if iteration < opt.densify_until_iter:
            if (iteration > opt.densify_from_iter
                    and iteration % self.interval == 0):
                size_threshold = (opt.max_screen_size or None
                                  if iteration > opt.opacity_reset_interval
                                  else None)
                full, full_opt = self.whole(state, opt_state)
                full, mu, nu = densify_and_prune(
                    full, full_opt.mu, full_opt.nu,
                    opt.densify_grad_threshold, opt.opacity_cull,
                    size_threshold, generator=self.gen,
                    percent_dense=opt.percent_dense)
                state, opt_state = self.reshard(
                    full, full_opt._replace(mu=mu, nu=nu))
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

        if iteration in self.save_iterations and self.scene.model_path:
            full, _ = self.whole(state, opt_state)
            if self.writer:
                self.scene.save(full, iteration)
        return state, opt_state

    def log_due(self, iteration):
        return iteration % self.log_every == 0 or iteration == self.iterations

    def grown_capacity(self, iteration, metrics, cap):
        """The duplicate capacity after step ``iteration``: every 10
        iterations and at each log point, an overflowed stream (a truncated
        one damages the model) grows it to the measured demand × 1.5."""
        if ((iteration % 10 == 0 or self.log_due(iteration))
                and bool(metrics["overflow"])):
            new_cap = round_capacity(int(metrics["demand"]), headroom=1.5)
            if new_cap > (cap or 0):
                if self.writer:
                    print(f"NOTE: duplicate stream overflowed at iteration "
                          f"{iteration}; raising duplicate_capacity "
                          f"{cap} -> {new_cap}", flush=True)
                return new_cap
        return cap

    def report(self, iteration, metrics, evaluate, dup_cap, rays_per_step,
               panel=None):
        """At a log point: the window's report, held-out ``evaluate()`` when
        due, the callback and the logger's scalars (and ``panel()``'s
        image, when given)."""
        # the window ends when the card has finished its steps, not when
        # the host has queued them
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        dt = time.perf_counter() - self.t_window
        test_psnr, test_l1 = float("nan"), float("nan")
        if (self.eval_every and self.scene.test_cameras
                and (iteration % self.eval_every == 0
                     or iteration == self.iterations)):
            test_psnr, test_l1 = evaluate()
        rep = TrainReport(iteration=iteration, loss=float(metrics["loss"]),
                          psnr=float(metrics["psnr"]),
                          n_alive=int(metrics["n_alive"]),
                          iters_per_s=self.window_iters / max(dt, 1e-9),
                          overflow_frac=float(bool(metrics["overflow"])),
                          test_psnr=test_psnr, test_l1=test_l1,
                          dup_capacity=int(dup_cap or 0))
        self.reports.append(rep)
        if self.callback:
            self.callback(rep)
        if self.logger is not None:
            scalars = {
                "train/loss": rep.loss, "train/psnr": rep.psnr,
                "train/l1": float(metrics["l1"]),
                "train/ssim": float(metrics["ssim"]),
                "train/semantic": float(metrics["semantic"]),
                "model/n_alive": rep.n_alive,
                "model/overflow": rep.overflow_frac,
                "perf/iters_per_s": rep.iters_per_s,
                "perf/rays_per_s": rep.iters_per_s * rays_per_step}
            if np.isfinite(rep.test_psnr):
                scalars["test/psnr"] = rep.test_psnr
                scalars["test/l1"] = rep.test_l1
            self.logger.scalars(iteration, scalars)
            if panel is not None:
                self.logger.image(iteration, "panels/render", panel())
        self.t_window = time.perf_counter()
        self.window_iters = 0


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
    # each call's start-up: the targets' upload, the capacity probe
    with trace.span("train.start"):
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

        bg = torch.zeros(3, device=dev) if bg is None else torch.as_tensor(
            bg, dtype=torch.float32, device=dev)
        opt_state = init_optimizer(state) if opt_state is None \
            else opt_state.to(dev)
        if sky_params is not None:
            sky_params = sky_params.to(dev)
            sky_opt_state = adam_init(sky_params) if sky_opt_state is None \
                else sky_opt_state.to(dev)

        rng = np.random.default_rng(seed)
        sched = _Schedule(scene, opt, n_cams, dev, seed, iterations,
                          save_iterations, log_every, eval_every,
                          eval_max_views, callback, logger)
        order: list[int] = []

        # demand-driven duplicate capacity: the init state's true demand
        # over a camera sample (exact at any probe capacity), with
        # densification headroom, before the first step
        dup_cap = duplicate_capacity
        if dup_cap is None:
            dup_cap = default_duplicate_capacity(
                state.capacity, cams[0].width, cams[0].height)
        need = 0
        for i in sorted({0, n_cams // 2, n_cams - 1}):
            b = bin_step(state, cams[i], duplicate_capacity=2048, device=dev)
            need = max(need, int(b.demand))
        if need * 1.15 > dup_cap:
            dup_cap = round_capacity(need, headroom=1.5)
            print(f"NOTE: init duplicate demand {need} exceeds capacity; "
                  f"sized duplicate_capacity={dup_cap}", flush=True)

    for iteration in range(start_iteration + 1, iterations + 1):
        if not order:
            order = list(rng.permutation(n_cams))
        idx = int(order.pop())

        gt_sem = semantics[idx] if semantics is not None else None
        with trace.span("train.iteration"):
            binning = bin_step(state, cams[idx], duplicate_capacity=dup_cap,
                               device=dev)
            state, opt_state, sky_params, sky_opt_state, metrics = \
                train_step(state, opt_state, cams[idx], images[idx], bg,
                           iteration, opt, sky_params=sky_params,
                           sky_opt_state=sky_opt_state, gt_semantic=gt_sem,
                           class_dist=iteration > opt.semantic_dist_from_iter,
                           duplicate_capacity=dup_cap, binning=binning,
                           device=dev)
            state, opt_state = sched.after_step(iteration, state, opt_state)
            dup_cap = sched.grown_capacity(iteration, metrics, dup_cap)

        if sched.log_due(iteration):
            def panel():
                with torch.no_grad():
                    res = render(cams[0], state, bg,
                                 duplicate_capacity=dup_cap, device=dev)
                return torch.clamp(res.render, 0.0, 1.0)
            sched.report(
                iteration, metrics,
                lambda: evaluate_views(
                    state, scene.test_cameras, scene.test_images, bg,
                    sky_params=sky_params, max_views=eval_max_views,
                    duplicate_capacity=dup_cap),
                dup_cap, cams[idx].width * cams[idx].height,
                panel=(panel if panel_every and iteration % panel_every == 0
                       else None))

    return state, sky_params, sched.reports


def train_scene_sharded(scene, state: SurfelState, opt: OptimizationParams,
                        n_tile: int = 1, n_data: int = 1, sky_params=None,
                        bg=None, start_iteration: int = 0,
                        iterations: Optional[int] = None,
                        save_iterations=(), log_every: int = 200,
                        duplicate_capacity: Optional[int] = None,
                        shard_surfels: bool = False, seed: int = 0,
                        callback=None, logger=None, opt_state=None,
                        use_semantics: bool = False, eval_every: int = 0,
                        eval_max_views: int = 8, device="cuda"):
    """The stage-1 loop on this rank of an ``n_data × n_tile`` mesh; every
    rank of the process group calls it with the same scene and state
    (``parallel.multihost.bootstrap`` first).

    Each step takes a batch of ``n_data`` cameras, one per ``data`` row,
    each rank rendering its row slab; the gradients are averaged over the
    mesh, and densify, reset and prune run replicated between steps: every
    rank draws the same camera order from ``seed`` and the same split
    samples from one generator seeded alike, so the replicas stay equal.
    Under ``shard_surfels`` each rank keeps its ``data`` share of the
    surfels and moments; densify gathers them whole, densifies, and shards
    them again. Mixed camera sizes train in buckets by (width, height),
    each batch from one bucket, buckets drawn in proportion to their size.
    An overflowing slab stream raises the per-slab capacity to the mesh's
    largest slab demand × 1.5, checked as ``train_scene`` checks its own.
    Returns (state, sky_params, reports) with the whole state on every
    rank; only rank 0 writes PLYs.
    """
    import torch.distributed as dist

    from ..parallel.multihost import make_global_batch
    from ..parallel.shard import (gather_surfels, make_mesh,
                                  make_sharded_train_step,
                                  shard_surfels as shard_rows)
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    strict_fp32()
    iterations = iterations or opt.iterations
    cams = scene.train_cameras
    bg = torch.zeros(3, device=dev) if bg is None else torch.as_tensor(
        bg, dtype=torch.float32, device=dev)
    state = state.to(dev)
    opt_state = init_optimizer(state) if opt_state is None \
        else opt_state.to(dev)

    mesh = make_mesh(n_data, n_tile, dev)
    use_sem = (use_semantics and opt.enable_semantic_loss
               and getattr(scene, "train_semantics", None) is not None
               and all(s is not None for s in scene.train_semantics))
    use_sky = sky_params is not None
    sky_opt_state = None
    if use_sky:
        sky_params = sky_params.to(dev)
        sky_opt_state = adam_init(sky_params)

    # camera-size buckets: this rank's share of every camera of a bucket
    # (its slab rows) on the device, and an order per bucket
    buckets: dict = {}
    for i, c in enumerate(cams):
        buckets.setdefault((c.width, c.height), {"idx": []})["idx"].append(i)
    for b in buckets.values():
        ii = b["idx"]
        sems = (np.stack([np.asarray(scene.train_semantics[i]) for i in ii])
                if use_sem else None)
        b["arrays"] = make_global_batch(
            mesh, np.stack([np.asarray(_host(cams[i].w2c)) for i in ii]),
            np.stack([np.asarray(_host(cams[i].K)) for i in ii]),
            np.stack([np.asarray(_host(scene.train_images[i]), np.float32)
                      for i in ii]), sems, device=dev)
        b["order"] = []
    steps: dict = {}
    # the per-slab capacity; None: the 2×/n_tile default of the step
    dup_cap = duplicate_capacity

    def step_for(size, late):
        if (size, late) not in steps:
            w, h = size
            steps[size, late] = make_sharded_train_step(
                mesh, opt, w, h, duplicate_capacity=dup_cap,
                shard_surfels=shard_surfels,
                semantics=(True if late else use_sem), class_dist=late,
                sky=use_sky)
        return steps[size, late]

    if shard_surfels:
        state, opt_state = shard_rows(mesh, state, opt_state)

        def whole(st, os_):
            return gather_surfels(mesh, st, os_)

        def reshard(st, os_):
            return shard_rows(mesh, st, os_)
    else:
        whole = reshard = None
    sched = _Schedule(scene, opt, len(cams), dev, seed, iterations,
                      save_iterations, log_every, eval_every, eval_max_views,
                      callback, logger, whole=whole, reshard=reshard,
                      writer=dist.get_rank() == 0)

    rng = np.random.default_rng(seed)
    bucket_keys = sorted(buckets.keys())
    bucket_p = np.array([len(buckets[k]["idx"]) for k in bucket_keys],
                        np.float64)
    bucket_p /= bucket_p.sum()
    d_row = mesh.get_local_rank("data")

    for iteration in range(start_iteration + 1, iterations + 1):
        size = bucket_keys[int(rng.choice(len(bucket_keys), p=bucket_p))]
        b = buckets[size]
        batch = []
        for _ in range(n_data):
            if not b["order"]:
                b["order"] = list(rng.permutation(len(b["idx"])))
            batch.append(int(b["order"].pop()))
        mine = torch.tensor([batch[d_row]], device=dev)
        arrays = [a.index_select(0, mine) for a in b["arrays"]]
        w2c_b, k_b, gt_b = arrays[:3]
        sem_b = arrays[3] if use_sem else None
        late = bool(use_sem and iteration > opt.semantic_dist_from_iter)
        stp = step_for(size, late)
        if use_sky:
            state, opt_state, sky_params, sky_opt_state, metrics = stp(
                state, opt_state, w2c_b, k_b, gt_b, bg, iteration, sem_b,
                sky_params, sky_opt_state)
        else:
            state, opt_state, metrics = stp(state, opt_state, w2c_b, k_b,
                                            gt_b, bg, iteration, sem_b)
        state, opt_state = sched.after_step(iteration, state, opt_state)
        # metrics["demand"] is the mesh's largest slab demand; the steps
        # are rebuilt at the grown capacity
        new_cap = sched.grown_capacity(iteration, metrics, dup_cap)
        if new_cap != dup_cap:
            dup_cap = new_cap
            steps.clear()

        if sched.log_due(iteration):
            # every rank scores the same held-out views on its copy of the
            # whole state, in n_tile row slabs (each slab's peak memory is
            # a training slab's)
            sched.report(
                iteration, metrics,
                lambda: evaluate_views(
                    sched.whole(state, opt_state)[0], scene.test_cameras,
                    getattr(scene, "test_images", []), bg,
                    sky_params=sky_params, max_views=eval_max_views,
                    duplicate_capacity=dup_cap, n_slabs=n_tile),
                dup_cap, size[0] * size[1] * n_data)

    state, _ = sched.whole(state, opt_state)
    return state, sky_params, sched.reports


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x
