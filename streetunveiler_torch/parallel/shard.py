"""Multi-device training over ``torch.distributed`` (counterpart of
``streetunveiler_tpu/parallel/shard.py``).

The scaling axes of this workload are pixels (H×W) and surfels (N). The
mesh is a ``torch.distributed.device_mesh`` with dims ``("data",
"tile")``, one rank per device:

* **tile parallelism** — each rank of a ``tile`` row renders one row slab
  of the image with a principal-point-shifted camera (``K[1,2] -= row0``,
  an exact crop), binned slab-locally, holding the full surfel set;
* **data parallelism** — each ``data`` row takes its own cameras of the
  batch;
* the gradients are the batch mean, then the mean over the mesh
  (``all_reduce``); the screen radii, the overflow and the duplicate
  demand are maxima over the mesh; PSNR comes from the mesh-mean MSE;
* ``shard_surfels`` (ZeRO): each rank keeps only its ``data`` share of
  the per-surfel arrays and of the Adam moments; a step all-gathers the
  parameters, reduces the gradients, keeps its shard of them and runs
  Adam on the shard;
* ``shard_preprocess``: with ``tile`` > 1 each rank preprocesses and packs
  only its ``tile`` share of the surfels with the full camera, the packed
  records are all-gathered over ``tile`` by an autograd-aware all-gather
  (its backward sums the ranks' cotangents) and re-expressed for the slab
  by ``shift_packT``.

The binning is slab-local and gradient-free. The per-camera loop replaces
the JAX package's ``vmap``; its two-phase split (a TPU workaround) is not
ported. Windowed SSIM is computed per slab (windows do not cross slab
boundaries), the JAX package's documented approximation.

Every rank calls the step with its own share of the batch
(``multihost.make_global_batch``): its ``data`` row's cameras and its
``tile`` slab of the images.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..config import OptimizationParams
from ..models.gaussians import (SurfelParams, SurfelState,
                                add_densification_stats)
from ..models.sky import render_sky
from ..ops.rasterizer.api import (_gather_records, bin_inputs_for_camera,
                                  bin_slab_from_inputs,
                                  default_duplicate_capacity, encode_extra,
                                  rasterize_stream, shift_packT)
from ..ops.rasterizer.kernel import NQ, TILE_H, pack_geometry_T
from ..ops.rasterizer.preprocess import preprocess_surfels
from ..ops.rasterizer.types import RasterizeSettings
from ..renderer import finalize_render, render, semantic_class_mask, \
    surfel_colors
from ..scene.cameras import Camera
from ..train.losses import l1_loss, ssim
from ..train.optim import AdamState, adam_update
from ..train.step import DIST_CLASSES, make_lrs, semantic_ce_loss
from ..utils.semantics import CONCERNED_IND, NUM_CONCERNED

PARAM_NAMES = tuple(f.name for f in dataclasses.fields(SurfelParams))
# the per-surfel arrays of a SurfelState besides its parameters
STATE_ROWS = ("semantics", "alive", "max_radii2d", "grad_accum", "denom")


def make_mesh(n_data: int, n_tile: int, device="cuda"):
    """The ``("data", "tile")`` device mesh over the process group (which
    ``multihost.bootstrap`` starts); its size must be the world size."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.multihost."
                           "bootstrap first")
    ws = dist.get_world_size()
    if ws != n_data * n_tile:
        raise ValueError(f"a {n_data}x{n_tile} mesh needs "
                         f"{n_data * n_tile} ranks, the group has {ws}")
    return init_device_mesh(torch.device(device).type, (n_data, n_tile),
                            mesh_dim_names=("data", "tile"))


def _rank_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def surfel_sharding(mesh, capacity: int) -> slice:
    """This rank's rows of a surfel-axis array under ``shard_surfels``: an
    even split over ``data`` (``capacity`` a multiple of its size)."""
    n_data = mesh.size(0)
    if capacity % n_data:
        raise ValueError(f"capacity {capacity} is not a multiple of data "
                         f"{n_data}")
    per = capacity // n_data
    d = mesh.get_local_rank("data")
    return slice(d * per, (d + 1) * per)


def _map_rows(state: SurfelState, fn) -> SurfelState:
    return dataclasses.replace(
        state,
        params=SurfelParams(**{n: fn(getattr(state.params, n))
                               for n in PARAM_NAMES}),
        **{n: fn(getattr(state, n)) for n in STATE_ROWS})


def shard_surfels(mesh, state: SurfelState, opt_state: AdamState | None):
    """(state, opt_state) → this rank's ``data`` share of every per-surfel
    array and moment (copies)."""
    sl = surfel_sharding(mesh, state.capacity)
    cut = lambda t: t[sl].clone()
    state = _map_rows(state, cut)
    if opt_state is not None:
        opt_state = AdamState(step=opt_state.step,
                              mu=_params_rows(opt_state.mu, cut),
                              nu=_params_rows(opt_state.nu, cut))
    return state, opt_state


def _params_rows(p: SurfelParams, fn) -> SurfelParams:
    return SurfelParams(**{n: fn(getattr(p, n)) for n in PARAM_NAMES})


def _all_gather_rows(t, group):
    """Concatenate the ranks' ``t`` along dim 0 over ``group``."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(torch.bool) if t.dtype == torch.bool else out


class _AllGatherRows(torch.autograd.Function):
    """``_all_gather_rows`` with a backward that sums the ranks' cotangents
    of each rank's rows (the transpose of an all-gather: a reduce-scatter;
    gloo takes an all-reduce and this rank's rows, since its scatter of a
    subgroup's tensors is not usable here)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        return _all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        group, n = ctx.group, ctx.rows
        g = g.contiguous()
        if dist.get_world_size(group) == 1:
            return g, None
        if dist.get_backend(group) == "nccl":
            out = torch.empty((n,) + tuple(g.shape[1:]), dtype=g.dtype,
                              device=g.device)
            dist.reduce_scatter_tensor(out, g, group=group)
            return out, None
        g = g.clone()
        dist.all_reduce(g, group=group)
        me = dist.get_group_rank(group, dist.get_rank())
        return g[me * n:(me + 1) * n], None


def gather_surfels(mesh, state: SurfelState, opt_state: AdamState | None):
    """The inverse of ``shard_surfels``: whole per-surfel arrays and
    moments on every rank (an all-gather over ``data``)."""
    g = mesh.get_group("data")
    cat = lambda t: _all_gather_rows(t, g)
    state = _map_rows(state, cat)
    if opt_state is not None:
        opt_state = AdamState(step=opt_state.step,
                              mu=_params_rows(opt_state.mu, cat),
                              nu=_params_rows(opt_state.nu, cat))
    return state, opt_state


def make_sharded_train_step(mesh, opt: OptimizationParams, width: int,
                            height: int,
                            duplicate_capacity: int | None = None,
                            shard_surfels: bool = False,
                            semantics: bool = False,
                            class_dist: bool = False,
                            sky: bool = False,
                            sky_lr: float = 1e-4,
                            shard_preprocess: bool = True):
    """Build this rank's training step on ``mesh``.

    Step signature (each rank passes its own share of the batch):
        step(state, opt_state, w2c [B,4,4], K [B,3,3], gt [B,slab,W,3],
             bg [3], iteration[, gt_sem [B,slab,W] int with semantics,
             sky_params, sky_opt_state])
            -> (state, opt_state[, sky_params, sky_opt_state], metrics)
    B is the cameras of this rank's ``data`` row (the same on every row);
    ``height`` splits into ``tile`` slabs of a multiple of 16 rows. The
    parameter tensors and the moments are updated in place, as
    ``train_step`` updates them.

    ``semantics``/``class_dist`` add the semantic cross entropy and the
    fused per-class gated distortion (the late phase); slab means of both
    equal the global means over equal slabs. ``sky`` trains the sky
    jointly: each slab renders its rows of the sky through the shifted
    principal point, and the replicated sky's gradients are averaged with
    the surfels'. ``shard_surfels``: ``state`` and ``opt_state`` are this
    rank's shard (``shard_surfels``/``gather_surfels``).
    """
    n_tile = mesh.size(1)
    slab = height // n_tile
    if slab * n_tile != height or slab % TILE_H:
        raise ValueError(f"height {height} must split into {n_tile} slabs "
                         f"of a multiple of {TILE_H} rows")
    row0 = mesh.get_local_rank("tile") * slab
    g_tile = mesh.get_group("tile")
    g_data = mesh.get_group("data")
    world = dist.get_world_size()
    dev = _rank_device(mesh)

    def slab_capacity(n_surfels: int) -> int:
        """Per-slab static duplicate capacity: 2× the even share of the
        full default over ``tile``, rounded up to 128 (each slab bins only
        the surfels its crop sees; the factor absorbs uneven density)."""
        if duplicate_capacity is not None:
            return duplicate_capacity
        full = default_duplicate_capacity(n_surfels, width, height)
        if n_tile == 1:
            return full
        return -(-(2 * full // n_tile) // 128) * 128

    def use_shard_pre(n_surfels: int) -> bool:
        return shard_preprocess and n_tile > 1 and n_surfels % n_tile == 0

    def render_shard_pre(state, w2c, K, cam_slab, bg, active_sh, c2d_off,
                         extra, gates, cap):
        """The slab render with the per-surfel preprocess sharded over
        ``tile``: preprocess and pack this rank's share with the full
        camera, all-gather the records (autograd-aware: the backward sums
        the ranks' cotangents, so each rank's preprocess backward runs on
        its share only), shift them to the slab."""
        ns = state.capacity // n_tile
        sl = slice(mesh.get_local_rank("tile") * ns,
                   (mesh.get_local_rank("tile") + 1) * ns)
        state_s = dataclasses.replace(
            state, params=_params_rows(state.params, lambda t: t[sl]),
            alive=state.alive[sl])
        st_full = RasterizeSettings(width=width, height=height, znear=0.2,
                                    zfar=100.0)
        opac = state_s.get_opacity()[:, 0]
        inputs_s = bin_inputs_for_camera(
            state_s.params.xyz, state_s.get_scaling(),
            state_s.get_rotation(), opac, w2c, K, st_full)
        inputs = [_all_gather_rows(x, g_tile) for x in inputs_s]
        binning = bin_slab_from_inputs(inputs, row0, width, slab, cap)

        cam_full = Camera(w2c=w2c, K=K, width=width, height=height)
        colors = surfel_colors(state_s, cam_full, active_sh)
        pack_extra, gates_n = encode_extra(extra, gates)
        sur = preprocess_surfels(
            state_s.params.xyz, state_s.get_scaling(),
            state_s.get_rotation(), opac, colors, w2c, K, st_full,
            center2d_offset=c2d_off[sl])
        packT_s = pack_geometry_T(
            sur, ns, None if pack_extra is None else pack_extra[sl],
            pad_column=False)
        packT = _AllGatherRows.apply(packT_s.T.contiguous(), g_tile).T
        packT = torch.cat([packT, torch.zeros((packT.shape[0], 1),
                                              device=packT.device)], dim=1)
        radii = _all_gather_rows(sur.radius.detach(), g_tile)
        recT = _gather_records(shift_packT(packT, row0),
                               binning.sorted_surfel)
        st_slab = RasterizeSettings(width=width, height=slab, znear=0.2,
                                    zfar=100.0)
        nq = NQ + (0 if extra is None else extra.shape[1])
        out = rasterize_stream(recT, radii, st_slab, binning, bg=bg, nq=nq,
                               gates_n=gates_n)
        return finalize_render(out, cam_slab)

    def local_loss(state, w2c, K, gt_slab, gt_sem_slab, bg, iteration,
                   c2d_off, sky_p):
        """One camera's slab loss on this rank → (loss, image, radii,
        stats)."""
        k_slab = K.clone()
        k_slab[1, 2] = K[1, 2] - float(row0)
        cam = Camera(w2c=w2c, K=k_slab, width=width, height=slab)
        active_sh = min(iteration // 1000, state.sh_degree)
        extra = gates = None
        if semantics:
            extra = F.one_hot(state.semantics.long(), NUM_CONCERNED
                              ).to(torch.float32)
        if semantics and class_dist:
            gates = torch.stack([semantic_class_mask(state, 1 << ci,
                                                     reverse=True)
                                 for ci in DIST_CLASSES], dim=1)
        cap = slab_capacity(state.capacity)
        if use_shard_pre(state.capacity):
            res = render_shard_pre(state, w2c, K, cam, bg, active_sh,
                                   c2d_off, extra, gates, cap)
        else:
            res = render(cam, state, bg, active_sh_degree=active_sh,
                         center2d_offset=c2d_off, duplicate_capacity=cap,
                         extra_payload=extra, class_gates=gates,
                         device=dev)
        image = res.render
        if sky_p is not None:
            sky_img = render_sky(sky_p, slab, width, k_slab,
                                 torch.linalg.inv(w2c))
            image = image + sky_img * (1.0 - res.rend_alpha)[..., None]
        ll1 = l1_loss(image, gt_slab)
        lssim = ssim(image, gt_slab)
        loss = (1.0 - opt.lambda_dssim) * ll1 \
            + opt.lambda_dssim * (1.0 - lssim)
        if iteration > opt.normal_consist_from_iter:
            normal_err = 1.0 - torch.sum(res.rend_normal * res.surf_normal,
                                         dim=-1)
            loss = loss + opt.lambda_normal * torch.mean(normal_err)
        if iteration > opt.semantic_dist_from_iter:
            loss = loss + opt.lambda_dist * torch.mean(res.rend_dist)
        sem_loss = torch.zeros((), device=image.device)
        if semantics:
            sky_prior = F.one_hot(torch.tensor(CONCERNED_IND["sky"]),
                                  NUM_CONCERNED).to(torch.float32).to(
                                      image.device)
            probs = res.extra + sky_prior * (1.0 - res.rend_alpha)[..., None]
            sem_loss = semantic_ce_loss(probs, gt_sem_slab)
            loss = loss + opt.semantic_loss_ratio * sem_loss
            if class_dist:
                loss = loss + opt.lambda_dist * torch.sum(
                    torch.mean(res.class_dist, dim=(0, 1)))
        with torch.no_grad():
            mse = torch.mean((torch.clamp(image, 0.0, 1.0) - gt_slab) ** 2)
            stats = torch.stack([
                ll1.detach(), lssim.detach(), sem_loss.detach(), mse])
            peaks = torch.stack([
                torch.as_tensor(res.overflow, device=image.device
                                ).to(torch.float32),
                torch.as_tensor(res.demand if res.demand is not None else 0,
                                device=image.device).to(torch.float32)])
        return loss, res.radii.detach(), stats, peaks

    def sharded_grads(state, w2c_b, k_b, gt_b, gt_sem_b, bg, iteration,
                      sky_params):
        """This rank's cameras × its slab → the mesh-mean loss, surfel and
        screen gradients (and the sky's), the mesh-max radii, and the
        stats."""
        leaves = {n: getattr(state.params, n).detach().requires_grad_(True)
                  for n in PARAM_NAMES}
        st = dataclasses.replace(state, params=SurfelParams(**leaves))
        c2d = torch.zeros((state.capacity, 2), dtype=torch.float32,
                          device=dev, requires_grad=True)
        sky_leaves = None
        inputs = [leaves[n] for n in PARAM_NAMES] + [c2d]
        if sky_params is not None:
            sky_leaves = sky_params.map(
                lambda t: t.detach().requires_grad_(True))
            inputs += list(sky_leaves.named_tensors().values())
        nb = w2c_b.shape[0]
        grads = [torch.zeros_like(x) for x in inputs]
        loss_sum = torch.zeros((), device=dev)
        stats_sum = torch.zeros(4, device=dev)
        peaks = torch.zeros(2, device=dev)
        radii = torch.zeros(state.capacity, device=dev)
        for b in range(nb):
            loss, r, stats, pk = local_loss(
                st, w2c_b[b], k_b[b], gt_b[b],
                None if gt_sem_b is None else gt_sem_b[b], bg, iteration,
                c2d, sky_leaves)
            gs = torch.autograd.grad(loss, inputs, allow_unused=True)
            for acc, g in zip(grads, gs):
                if g is not None:
                    acc.add_(g)
            loss_sum += loss.detach()
            stats_sum += stats
            peaks = torch.maximum(peaks, pk)
            radii = torch.maximum(radii, torch.where(r > 0, r,
                                                     torch.zeros_like(r)))
        # batch mean, then the mean over the mesh, in one all_reduce
        flat = torch.cat([g.reshape(-1) / nb for g in grads]
                         + [(loss_sum / nb)[None], stats_sum / nb])
        dist.all_reduce(flat)
        flat = flat / world
        mx = torch.cat([radii, peaks])
        dist.all_reduce(mx, op=dist.ReduceOp.MAX)
        out, o = [], 0
        for x in inputs:
            out.append(flat[o:o + x.numel()].view_as(x))
            o += x.numel()
        loss = flat[o]
        l1, lssim, sem, mse = flat[o + 1:o + 5]
        stats = dict(
            l1=l1, ssim=lssim, semantic=sem,
            psnr=20.0 * torch.log10(1.0 / torch.sqrt(
                torch.clamp(mse, min=1e-12))),
            overflow=mx[-2] > 0.0, demand=mx[-1].to(torch.int32))
        pgrads = SurfelParams(**dict(zip(PARAM_NAMES, out[:6])))
        sky_grads = None
        if sky_params is not None:
            it = iter(out[7:])
            sky_grads = sky_params.map(lambda _: next(it))
        return loss, pgrads, out[6], mx[:-2], sky_grads, stats

    def step(state: SurfelState, opt_state: AdamState, w2c_b, k_b, gt_b,
             bg, iteration, gt_sem_b=None, sky_params=None,
             sky_opt_state=None):
        iteration = int(iteration)
        bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
        loss, pgrads, sgrads, radii, skg, stats = sharded_grads(
            state, w2c_b, k_b, gt_b, gt_sem_b, bg, iteration,
            sky_params if sky else None)
        lrs = make_lrs(opt, iteration, state.spatial_scale)
        params, opt_state = adam_update(pgrads, opt_state, state.params,
                                        lrs)
        state = dataclasses.replace(state, params=params)
        if sky:
            sky_params, sky_opt_state = adam_update(
                skg, sky_opt_state, sky_params, sky_lr, eps=1e-8)
        visible = (radii > 0) & (iteration < opt.densify_until_iter)
        state = add_densification_stats(state, sgrads, radii, visible)
        metrics = dict(loss=loss, n_alive=state.num_alive, **stats)
        if sky:
            return state, opt_state, sky_params, sky_opt_state, metrics
        return state, opt_state, metrics

    def step_zero(state: SurfelState, opt_state: AdamState, w2c_b, k_b,
                  gt_b, bg, iteration, gt_sem_b=None, sky_params=None,
                  sky_opt_state=None):
        """``state``/``opt_state`` are this rank's surfel shards: gather
        the parameters (and the alive and class masks) over ``data``,
        reduce the gradients as the replicated step does, keep this
        rank's shard of them, and run Adam on the shard."""
        iteration = int(iteration)
        bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
        full = dataclasses.replace(
            state,
            params=_params_rows(state.params,
                                lambda t: _all_gather_rows(t, g_data)),
            semantics=_all_gather_rows(state.semantics, g_data),
            alive=_all_gather_rows(state.alive, g_data))
        loss, pgrads, sgrads, radii, skg, stats = sharded_grads(
            full, w2c_b, k_b, gt_b, gt_sem_b, bg, iteration,
            sky_params if sky else None)
        sl = surfel_sharding(mesh, full.capacity)
        g_shard = _params_rows(pgrads, lambda t: t[sl])
        lrs = make_lrs(opt, iteration, state.spatial_scale)
        params, opt_state = adam_update(g_shard, opt_state, state.params,
                                        lrs)
        state = dataclasses.replace(state, params=params)
        if sky:
            sky_params, sky_opt_state = adam_update(
                skg, sky_opt_state, sky_params, sky_lr, eps=1e-8)
        visible = (radii[sl] > 0) & (iteration < opt.densify_until_iter)
        state = add_densification_stats(state, sgrads[sl], radii[sl],
                                        visible)
        metrics = dict(loss=loss, n_alive=full.num_alive, **stats)
        if sky:
            return state, opt_state, sky_params, sky_opt_state, metrics
        return state, opt_state, metrics

    return step_zero if shard_surfels else step
