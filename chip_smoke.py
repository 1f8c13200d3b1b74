"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``streetunveiler_torch/ops/
rasterizer/csrc/`` (nvcc, sm_90a), holds each one against its plain
PyTorch version at the shapes of the full-width render and step, then
drives the two paths of the port on the 300k-surfel street scene at
1920x1280:

* the forward render — ``measure_duplicate_capacity`` and
  ``renderer.render`` — checked and timed by stage with CUDA events and
  over three frames under ``torch.profiler`` (the card's busy and idle
  share, kernels by time);
* stage-1 training — ``bin_step`` + ``train_step`` with real Adam updates
  and densification statistics (phases ``k2_vs_plain``,
  ``train_main_path``, ``train_time``), then the training CLI on the
  synthetic street scene for 300 iterations (``train_scene_synthetic``);
* the late-phase step — semantics, the gated per-class distortion (G = 5
  gated chains in K1 and K2) and the sky trained jointly (phases
  ``reference_small_gated``, ``k1_vs_plain_gated_*``,
  ``k2_vs_plain_gated_*``, ``train_late_path``, ``train_late_time``,
  ``train_late_profile``), then the CLI with ``--semantics --sky``
  through a compressed schedule (``train_scene_synthetic_late``);
* the measurement tools (phase group 9, ``streetunveiler_torch/tools/``):
  every variant of the bisection kernels T1 (K1's) and T2 (K2's), at the
  photometric (nq 6) and late (nq 12, G 5) configurations, against its
  plain version on a dense-occlusion stack, ``full`` bit for bit against
  the production K1/K2 at full width, then every variant timed on the
  main path's streams; the micro-probes T3 (``micro_reduce``) and T4
  (``micro_prefix``) against their plain versions and timed at the TPU
  tools' sizes.

Each phase prints one JSON line; any failure raises and the script exits
non-zero. The last two lines are the kernels table and
``{"ok": true, "device": {...}}``.

Needs one CUDA device and nvcc (``CUDA_HOME`` or ``/usr/local/cuda``); it
imports nothing of JAX. Without a CUDA device it exits 2 and prints no
result.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks: HBM bandwidth, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
K1_OPS_PER_PAIR = 30
K3_OPS_PER_SLOT = 10
# K2 (the count in csrc/blend_bwd.cuh's note): ~33 f32 operations for
# every evaluated pair (the forward recompute); ~20 + 4 per payload
# channel for each pair the main chain kept (its scan), ~20 for each pair
# a gated chain kept (that chain's scan), and ~62 for each pair some chain
# kept (the pair VJP and the 14 sums): 82 + 4·nq per kept pair ungated
K2_OPS_EVALUATED, K2_OPS_SCAN, K2_OPS_KEPT_CHANNEL, K2_OPS_VJP = 33, 20, 4, 62
K1_OPS_GATED_KEPT = 8   # a gated chain's composite: T, w, α_g, m1_g, m2_g
TRAIN_ITER0 = 5000   # the schedule point of the full-width steps: SH
#                      degree 3 active, densification statistics on
TRAIN_STEPS = 20
LATE_ITER0 = 31_001  # the late phase: past semantic_dist_from_iter,
#                      normal_consist_from_iter and shrinking_from_iter
G_LATE = 5           # gated chains of the late loss: every class but sky
W, H, FOCAL, N_SURFELS = 1920, 1280, 1000.0, 300_000   # tools/street.py

# the tolerances of tests/test_kernel.py, per accumulator channel
TOL_PAYLOAD, TOL_ALPHA, TOL_DEPTH, TOL_MOMENT, TOL_MEDIAN = \
    5e-5, 2e-5, 5e-4, 5e-5, 1e-5
FLIP_FRACTION = 1e-3     # knife-edge pixels allowed at t_eps > 0
# K2 against its plain version. Per surfel, after the record scatter: the
# gradient tolerance of tests/test_kernel.py:86. Per record row (before
# the scatter), the largest error relative to the row's largest gradient:
# both versions sum f32 terms that cancel heavily (the pair VJP through
# the cross products, and the 512-pixel sums in another order), and a
# float64 emulation of the kernel's arithmetic differs from the plain
# version by up to 2.6e-4 of a row's maximum on random cotangents.
GRAD_ATOL_REL, GRAD_RTOL, ROW_TOL_REL = 2e-4, 1e-3, 1e-3


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def small_scene(torch, n=300, seed=0, w=64, h=48, f=50.0):
    """The kernel-test scene of tests/test_kernel.py, on the card."""
    import numpy as np
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                      rng.uniform(3.0, 12.0, n)], axis=1)
    arrays = (means, rng.uniform(0.05, 0.6, (n, 2)), rng.normal(size=(n, 4)),
              rng.uniform(0.05, 0.95, n), rng.uniform(0, 1, (n, 3)))
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    cuda = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                     device="cuda")
    return tuple(map(cuda, arrays)), cuda(np.eye(4)), cuda(K)


def cuda_ms(torch, fn, reps):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events), after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def profile_frames(torch, frame, frames):
    """Device activity over ``frames`` back-to-back calls of ``frame``
    under ``torch.profiler``: the union of the device's busy intervals
    against the host wall time, launches per frame and the kernels that
    take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for lo, hi, name in spans:
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (hi - lo) / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return dict(
        frames=frames, wall_ms_per_frame=wall_ms / frames,
        device_busy_ms_per_frame=busy_us / 1e3 / frames,
        device_idle_share=1.0 - busy_us / 1e3 / wall_ms,
        device_ops_per_frame=len(spans) / frames,
        top_kernels=[dict(name=name[:90], ms_per_frame=ms / frames,
                          calls_per_frame=n / frames)
                     for name, (ms, n) in top])


def check_blend(torch, acc, lk, want_acc, want_lk, nq, label, n_gates=0,
                **fields):
    """K1 against its plain version: lk mismatch fraction, and per channel
    the max abs error over the pixels whose lk agrees; with gated chains
    the same per class over the pixels whose lk_g agrees (α_g, m1_g, m2_g
    and the class's distortion α_g·m2_g − m1_g²). Returns the largest
    error of a checked channel."""
    ch = nq + 6
    same = (lk == want_lk)[..., 0]
    mismatch = 1.0 - float(same.float().mean())
    errs = (acc[..., :ch] - want_acc[..., :ch]).abs()[same].amax(
        dim=0).tolist()
    alpha_c = nq
    dist = lambda a: a[..., alpha_c] * a[..., nq + 4] - a[..., nq + 3] ** 2
    dist_err = float((dist(acc) - dist(want_acc)).abs()[same].max())
    med, want_med = acc[..., nq + 5][same], want_acc[..., nq + 5][same]
    med_err = (med - want_med).abs()
    med_far = float((med_err > TOL_MEDIAN).float().mean())
    med_rel = float((med_err / want_med.abs().clamp(min=1.0)).max())
    tol = ([TOL_PAYLOAD] * nq
           + [TOL_ALPHA, TOL_DEPTH, 0.0, TOL_MOMENT, TOL_MOMENT])
    ok = (mismatch <= FLIP_FRACTION and dist_err <= TOL_MOMENT
          and med_far <= FLIP_FRACTION and med_rel <= 1e-5
          and all(e <= t for e, t in zip(errs, tol)))
    worst = max(errs[:nq + 5] + [dist_err])
    gated = []
    for g in range(n_gates):
        c0 = ch + 4 * g
        same_g = acc[..., c0 + 3] == want_acc[..., c0 + 3]
        mism_g = 1.0 - float(same_g.float().mean())
        errs_g = (acc[..., c0:c0 + 3] - want_acc[..., c0:c0 + 3]).abs()[
            same_g].amax(dim=0).tolist()
        dist_g = lambda a: a[..., c0] * a[..., c0 + 2] - a[..., c0 + 1] ** 2
        dist_g_err = float((dist_g(acc) - dist_g(want_acc)).abs()[
            same_g].max())
        ok_g = (mism_g <= FLIP_FRACTION and dist_g_err <= TOL_MOMENT
                and all(e <= t for e, t in zip(
                    errs_g, (TOL_ALPHA, TOL_MOMENT, TOL_MOMENT))))
        gated.append(dict(lk_g_mismatch_frac=mism_g,
                          max_abs_err_alpha_m1_m2=errs_g,
                          distortion_max_abs_err=dist_g_err,
                          alpha_g_max=float(want_acc[..., c0].max()),
                          within_tolerance=ok_g))
        ok = ok and ok_g
        worst = max([worst, dist_g_err] + errs_g)
    emit(label, nq=nq, n_gates=n_gates, lk_mismatch_frac=mismatch,
         max_abs_err_per_channel=errs, distortion_max_abs_err=dist_err,
         median_frac_over_tol=med_far, median_max_rel_err=med_rel,
         gated=gated, **fields, within_tolerance=ok)
    if not ok:
        raise AssertionError(f"{label}: K1 disagrees with its plain version")
    return worst


class capture_blend_backward:
    """Within the block, ``kernel.blend_backward`` (what the blend's
    autograd backward calls) records its arguments and, with ``plain``,
    runs the plain version instead of K2 — so one real loss gives K2's
    exact inputs, and the same loss backpropagated through the plain
    version gives the reference gradients."""

    def __init__(self, kernel, plain=False):
        self.kernel, self.plain, self.args = kernel, plain, None

    def __enter__(self):
        self.orig = self.kernel.blend_backward
        fn = self.kernel.blend_backward_plain if self.plain else self.orig

        def record(*a):
            self.args = a
            return fn(*a)
        self.kernel.blend_backward = record
        return self

    def __exit__(self, *exc):
        self.kernel.blend_backward = self.orig
        return False


def loss_grads(torch, state, cam, gt, bg, opt, iteration, cap,
               gt_semantic=None, class_dist=False, sky=None):
    """stage1_loss of ``state`` and its gradients (the six parameter
    leaves, then center2d_offset, then the sky's tensors as ``sky.…``),
    as ``train_step`` takes them."""
    import dataclasses
    from streetunveiler_torch.models.gaussians import SurfelParams
    from streetunveiler_torch.train.step import stage1_loss
    names = [f.name for f in dataclasses.fields(SurfelParams)]
    leaves = {n: getattr(state.params, n).detach().requires_grad_(True)
              for n in names}
    off = torch.zeros((state.capacity, 2), device="cuda",
                      requires_grad=True)
    st = dataclasses.replace(state, params=SurfelParams(**leaves))
    sky_leaves = None if sky is None else sky.map(
        lambda t: t.detach().requires_grad_(True))
    loss, aux = stage1_loss(st, cam, gt, bg, iteration, opt,
                            sky_params=sky_leaves, gt_semantic=gt_semantic,
                            class_dist=class_dist, center2d_offset=off,
                            duplicate_capacity=cap)
    inputs = dict(zip(names, (leaves[n] for n in names)))
    inputs["center2d_offset"] = off
    if sky_leaves is not None:
        inputs.update({"sky" + k: t
                       for k, t in sky_leaves.named_tensors().items()})
    grads = torch.autograd.grad(loss, list(inputs.values()))
    return loss.detach(), dict(zip(inputs, grads)), aux


def k2_ops(counts, nq):
    """K2's f32 operations on one call's data (csrc/blend_bwd.cuh's note):
    the recompute of every evaluated pair, the main chain's scan of each
    pair it kept, a gated chain's scan of each pair it kept, and the pair
    VJP with the 14 sums of each pair some chain kept."""
    return (K2_OPS_EVALUATED * counts["evaluated"]
            + (K2_OPS_SCAN + K2_OPS_KEPT_CHANNEL * nq) * counts["kept"]
            + K2_OPS_SCAN * counts["gated_kept"]
            + K2_OPS_VJP * counts["any_kept"])


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over the f32 rate."""
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return max(b_ms, o_ms), "operations" if o_ms >= b_ms else "bytes"


def check_k2(torch, kernel, a, g_k2, g_plain, label, reps=20, **fields):
    """K2 against its plain version on the captured arguments ``a`` of a
    real loss's backward: per record row, then per surfel (the loss's
    gradients through K2 against those through the plain version, after
    the record scatter). Times both and bounds K2 on these inputs."""
    recT, off, _, _, _, _, lk, _, nq, n_gates = a
    got = kernel.blend_backward_cuda(*a)
    want, counts = kernel.blend_backward_plain(*a, count_pairs=True)
    torch.cuda.synchronize()
    row_scale = want.abs().amax(dim=1)
    row_err = ((got - want).abs().amax(dim=1)
               / row_scale.clamp(min=1e-30)).tolist()
    rows_ok = all(e <= ROW_TOL_REL for e in row_err)
    surfel = {}
    for name, gk in g_k2.items():
        gp = g_plain[name]
        scale = float(gp.abs().max())
        ok = bool(torch.allclose(gk, gp, atol=GRAD_ATOL_REL * scale,
                                 rtol=GRAD_RTOL))
        surfel[name] = dict(max_abs=scale,
                            max_abs_err=float((gk - gp).abs().max()),
                            finite=bool(torch.isfinite(gk).all()),
                            within_tolerance=ok)
    ms = cuda_ms(torch, lambda: kernel.blend_backward_cuda(*a), reps)
    plain_ms = cuda_ms(torch, lambda: kernel.blend_backward_plain(*a), 1)
    rec, capp = recT.shape
    filled = int(off[-1])
    # what K2 reads (csrc/blend_bwd.cuh) and writes: record rows 0..9+nq
    # and the gate row of each filled slot; of acc, α and each (α_g, lk_g);
    # of dacc, the payload, α, depth, m1 and m2 cotangents and each
    # (α_g, m1_g, m2_g); lk; all of dgrad
    pix = lk.numel()
    nbytes = 4 * ((kernel.Q_ROW0 + nq + (1 if n_gates else 0)) * filled
                  + off.numel() + pix * (1 + 2 * n_gates) + pix
                  + pix * (nq + 4 + 3 * n_gates) + rec * capp)
    ops = k2_ops(counts, nq)
    bound_ms, bound_by = bound(nbytes, ops)
    ok = (rows_ok and bool(torch.isfinite(got).all())
          and all(v["within_tolerance"] and v["finite"]
                  for v in surfel.values()))
    emit(label, nq=nq, n_gates=n_gates, record_rows=rec,
         row_max_abs_err_rel=row_err, row_tolerance_rel=ROW_TOL_REL,
         per_surfel=surfel, grad_tolerance=dict(atol_rel=GRAD_ATOL_REL,
                                                rtol=GRAD_RTOL),
         evaluated_pairs=counts["evaluated"], kept_pairs=counts["kept"],
         gated_kept_pairs=counts["gated_kept"],
         vjp_pairs=counts["any_kept"], duplicates=filled, ms=ms,
         plain_ms=plain_ms, bytes=nbytes, operations=ops,
         bound_ms_bytes=nbytes / HBM_BYTES_PER_S * 1e3,
         bound_ms_ops=ops / F32_OPS_PER_S * 1e3, **fields,
         within_tolerance=ok)
    if not ok:
        raise AssertionError(f"{label}: K2 disagrees with its plain version")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, counts=counts,
                max_abs_err=float((got - want).abs().max()))


def k2_vs_plain(torch, kernel, state, cam, gt, gt_sem, bg, cap, opt, nq):
    """K2 against its plain version on the inputs of the step's real loss
    (every stage-1 loss term on), at full width: per record row, then per
    surfel after the record scatter."""
    sem = gt_sem if nq == 12 else None
    with capture_blend_backward(kernel) as cap_k2:
        loss, g_k2, _ = loss_grads(torch, state, cam, gt, bg, opt,
                                   TRAIN_ITER0, cap, sem)
    with capture_blend_backward(kernel, plain=True):
        _, g_plain, _ = loss_grads(torch, state, cam, gt, bg, opt,
                                   TRAIN_ITER0, cap, sem)
    a = tuple(t.detach() if torch.is_tensor(t) else t for t in cap_k2.args)
    if a[8] != nq:
        raise AssertionError(f"the loss ran the blend at nq={a[8]}, "
                             f"not {nq}")
    return dict(check_k2(torch, kernel, a, g_k2, g_plain,
                         f"k2_vs_plain_nq{nq}", loss=float(loss)), args=a)


def gated_vs_plain(torch, kernel, loss_fn, case):
    """Gated K1 and K2 against their plain versions on one loss's blend:
    ``loss_fn()`` → (loss, grads) runs the loss and its gradients; it runs
    twice, its backward through K2, then through the plain version. K1's
    inputs are the forward's records (the captured arguments)."""
    with capture_blend_backward(kernel) as cb:
        loss, g_k2 = loss_fn()
    with capture_blend_backward(kernel, plain=True):
        _, g_plain = loss_fn()
    # the captured records require grad: detached, the plain versions
    # below build no graph
    a = tuple(t.detach() if torch.is_tensor(t) else t for t in cb.args)
    recT, off, tx, ty, settings, _, _, _, nq, n_gates = a
    k1_args = (recT, off, tx, ty, settings, nq, n_gates)
    acc, lk = kernel.blend_forward_cuda(*k1_args)
    want_acc, want_lk, counts = kernel.blend_forward_plain(
        *k1_args, count_pairs=True)
    # the pairs the ungated blend of the same records evaluates
    main_evaluated = kernel.blend_forward_plain(
        *k1_args[:6], count_pairs=True)[2]["evaluated"]
    torch.cuda.synchronize()
    ms = cuda_ms(torch, lambda: kernel.blend_forward_cuda(*k1_args), 10)
    plain_ms = cuda_ms(torch, lambda: kernel.blend_forward_plain(*k1_args),
                       1)
    nbytes = 4 * (recT.shape[0] * int(off[-1]) + off.numel() + acc.numel()
                  + lk.numel())
    ops = (K1_OPS_PER_PAIR * counts["evaluated"]
           + K1_OPS_GATED_KEPT * counts["gated_kept"])
    k1_bound, k1_by = bound(nbytes, ops)
    k1_err = check_blend(
        torch, acc, lk, want_acc, want_lk, nq, f"k1_vs_plain_gated_{case}",
        n_gates, evaluated_pairs=counts["evaluated"],
        ungated_evaluated_pairs=main_evaluated,
        kept_pairs=counts["kept"], gated_kept_pairs=counts["gated_kept"],
        duplicates=int(off[-1]), ms=ms, plain_ms=plain_ms, bytes=nbytes,
        operations=ops, bound_ms=k1_bound)
    k2 = check_k2(torch, kernel, a, g_k2, g_plain,
                  f"k2_vs_plain_gated_{case}", reps=10, loss=float(loss))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=k1_bound, bound_by=k1_by,
                max_abs_err=k1_err, counts=counts,
                ungated_evaluated=main_evaluated), k2, a


def dense_gated_loss(torch, rasterize, settings_cls):
    """A dense-occlusion stack (tests/test_torch_blend.py's dense scene:
    1500 mostly opaque surfels, 128×96) whose nearest third is class 0 and
    the rest classes 1 and 2 at random, so that the gated chains of
    classes 1 and 2 outlive the main chain; loss = Σ colour² + Σ
    distortion + Σ class_dist over the three classes."""
    import numpy as np
    rng = np.random.default_rng(0)
    n, w, h, f = 1500, 128, 96, 110.0
    z = rng.uniform(2.0, 30.0, n)
    means = np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(-2, 2, n), z],
                     1)
    cls = np.where(z < np.quantile(z, 1 / 3), 0, rng.integers(1, 3, n))
    cuda = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                     device="cuda")
    args = [cuda(means), cuda(rng.uniform(0.2, 0.9, (n, 2))),
            cuda(rng.normal(size=(n, 4))), cuda(rng.uniform(0.5, 0.98, n)),
            cuda(rng.uniform(0, 1, (n, 3)))]
    gates = torch.as_tensor(np.stack([cls == g for g in range(3)], 1),
                            device="cuda")
    K = cuda([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    st = settings_cls(width=w, height=h)

    def loss_fn():
        leaves = [t.clone().requires_grad_(True) for t in args[:4]]
        out = rasterize(*leaves, args[4], cuda(np.eye(4)), K, st,
                        class_gates=gates)
        loss = ((out.color ** 2).sum() + out.distortion.sum()
                + out.class_dist.sum())
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), dict(zip(("means", "scales", "quats",
                                        "opacities"), grads))
    return loss_fn


def finite_state(torch, state, opt_state, sky=None, sky_opt=None):
    import dataclasses
    tensors = [getattr(t, f.name) for t in (state.params, opt_state.mu,
                                            opt_state.nu)
               for f in dataclasses.fields(t)]
    for t in (sky, *(() if sky_opt is None else (sky_opt.mu, sky_opt.nu))):
        if t is not None:
            tensors += list(t.named_tensors().values())
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def ground_truth(torch, state, cam, cap):
    """The training target: a render of a perturbed copy (opacity logits
    raised by 1.5) on a black background, and its semantic argmax as the
    label map."""
    import dataclasses
    from streetunveiler_torch import renderer
    bg = torch.zeros(3, device="cuda")
    gt_state = dataclasses.replace(state, params=dataclasses.replace(
        state.params, opacity=state.params.opacity + 1.5))
    with torch.no_grad():
        gt = renderer.render(cam, gt_state, bg, duplicate_capacity=cap,
                             device="cuda").render.clamp(0.0, 1.0)
        gt_sem = renderer.render_semantic(cam, gt_state,
                                          duplicate_capacity=cap,
                                          device="cuda"
                                          ).argmax(dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    return bg, gt, gt_sem


def host_ms(torch, fn, reps):
    """Host-clock milliseconds of ``fn``, each call between
    synchronisations."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def step_stages(torch, state, cam, cap, bg, gt, opt, it, gt_sem=None,
                class_dist=False, sky=None):
    """The stages of one step, each alone on the inputs of the step (CUDA
    events), and the loss with its gradients in one call. Returns (stages,
    loss_and_grads_ms)."""
    import dataclasses
    import torch.nn.functional as F
    from streetunveiler_torch import renderer
    from streetunveiler_torch.models.gaussians import add_densification_stats
    from streetunveiler_torch.models.sky import render_sky
    from streetunveiler_torch.ops.rasterizer import kernel
    from streetunveiler_torch.ops.rasterizer.api import encode_extra
    from streetunveiler_torch.ops.rasterizer.preprocess import \
        preprocess_surfels
    from streetunveiler_torch.train.losses import photometric_loss
    from streetunveiler_torch.train.optim import adam_init, adam_update
    from streetunveiler_torch.train.step import (DIST_CLASSES, SKY_EPS,
                                                 SKY_LR, bin_step,
                                                 init_optimizer, make_lrs)
    with capture_blend_backward(kernel) as cb:
        _, g, aux = loss_grads(torch, state, cam, gt, bg, opt, it, cap,
                               gt_sem, class_dist, sky)
    a = tuple(t.detach() if torch.is_tensor(t) else t for t in cb.args)
    b = bin_step(state, cam, duplicate_capacity=cap, device="cuda")
    names = [f.name for f in dataclasses.fields(state.params)]
    extra = (None if gt_sem is None else F.one_hot(
        state.semantics.long(), 6).to(torch.float32))
    gates = (torch.stack([renderer.semantic_class_mask(state, 1 << ci)
                          for ci in DIST_CLASSES], dim=1)
             if class_dist else None)

    def forward():
        leaves = {n: getattr(state.params, n).detach().requires_grad_(True)
                  for n in names}
        st = dataclasses.replace(state, params=type(state.params)(**leaves))
        return renderer.render(cam, st, bg, active_sh_degree=3,
                               duplicate_capacity=cap, binning=b,
                               extra_payload=extra, class_gates=gates,
                               device="cuda", center2d_offset=torch.zeros(
                                   (state.capacity, 2), device="cuda",
                                   requires_grad=True))

    img = aux["image"].clone().requires_grad_(True)

    def losses_fwd_bwd():
        return torch.autograd.grad(
            photometric_loss(img, gt, opt.lambda_dssim), img)

    recT, off, tx, ty, settings, _, _, _, nq, n_gates = a
    k1_args = (recT, off, tx, ty, settings, nq, n_gates)
    drecT = kernel.blend_backward_cuda(*a)
    idx = b.sorted_surfel
    n_cols = state.capacity + 1

    def record_scatter():
        # what autograd runs for _gather_records' index_select backward
        return torch.zeros((drecT.shape[0], n_cols),
                           device="cuda").index_add_(1, idx, drecT)

    # the preprocess and SH decode as the render builds them, up to the
    # packed records; its backward alone on a retained graph, fed the
    # scattered record gradients of the captured K2 call
    leaves = {n: getattr(state.params, n).detach().requires_grad_(True)
              for n in names}
    off2d = torch.zeros((state.capacity, 2), device="cuda",
                        requires_grad=True)
    st = dataclasses.replace(state, params=type(state.params)(**leaves))
    sur = preprocess_surfels(
        st.params.xyz, st.get_scaling(), st.get_rotation(),
        st.get_opacity()[:, 0], renderer.surfel_colors(st, cam, 3), cam.w2c,
        cam.K, renderer._settings_for(cam, 1.0), center2d_offset=off2d)
    packT = kernel.pack_geometry_T(sur, state.capacity,
                                   encode_extra(extra, gates)[0])
    dpackT = record_scatter()
    bwd_inputs = list(leaves.values()) + [off2d]

    def preprocess_sh_backward():
        return torch.autograd.grad(packT, bwd_inputs, dpackT,
                                   retain_graph=True, allow_unused=True)
    p_copy = type(state.params)(**{n: getattr(state.params, n).clone()
                                   for n in names})
    o_copy = init_optimizer(state)
    lrs = make_lrs(opt, it, state.spatial_scale)
    g_params = type(state.params)(**{n: g[n] for n in names})
    visible = aux["radii"] > 0
    stage = dict(
        binning=cuda_ms(torch, lambda: bin_step(
            state, cam, duplicate_capacity=cap, device="cuda"), 10),
        forward_render=cuda_ms(torch, forward, 10),
        k1=cuda_ms(torch, lambda: kernel.blend_forward_cuda(*k1_args), 10),
        losses_fwd_bwd=cuda_ms(torch, losses_fwd_bwd, 10),
        k2=cuda_ms(torch, lambda: kernel.blend_backward_cuda(*a), 10),
        record_scatter=cuda_ms(torch, record_scatter, 10),
        preprocess_sh_backward=cuda_ms(torch, preprocess_sh_backward, 10),
        adam=cuda_ms(torch, lambda: adam_update(g_params, o_copy, p_copy,
                                                lrs), 10),
        densification_stats=cuda_ms(torch, lambda: add_densification_stats(
            state, g["center2d_offset"], aux["radii"], visible), 10))
    if sky is not None:
        c2w = torch.linalg.inv(cam.w2c)

        def sky_fwd_bwd():
            s = sky.map(lambda t: t.detach().requires_grad_(True))
            out = render_sky(s, cam.height, cam.width, cam.K, c2w)
            return torch.autograd.grad(out, list(
                s.named_tensors().values()), torch.ones_like(out))
        s_copy = sky.map(torch.clone)
        s_opt = adam_init(s_copy)
        it_g = iter([g["sky" + k] for k in sky.named_tensors()])
        s_grads = sky.map(lambda _: next(it_g))
        stage["sky_fwd_bwd"] = cuda_ms(torch, sky_fwd_bwd, 10)
        stage["sky_adam"] = cuda_ms(torch, lambda: adam_update(
            s_grads, s_opt, s_copy, SKY_LR, eps=SKY_EPS), 10)
    full = cuda_ms(torch, lambda: loss_grads(torch, state, cam, gt, bg, opt,
                                             it, cap, gt_sem, class_dist,
                                             sky), 5)
    return stage, full


def train_phases(torch, state, cam, cap, bg, gt, gt_sem):
    """The training slice at full width; returns what the kernels line
    needs of it."""
    from streetunveiler_torch.config import OptimizationParams
    from streetunveiler_torch.models.gaussians import densify_and_prune
    from streetunveiler_torch.ops.rasterizer import cuda_lib, kernel
    from streetunveiler_torch.train.step import (bin_step, init_optimizer,
                                                 train_step)

    # ---- K2 against its plain version, nq 6 and 12, every loss term on
    opt_all = OptimizationParams(normal_consist_from_iter=0,
                                 semantic_dist_from_iter=0,
                                 shrinking_from_iter=0)
    k2 = {nq: k2_vs_plain(torch, kernel, state, cam, gt, gt_sem, bg, cap,
                          opt_all, nq) for nq in (6, 12)}

    # ---- the training main path: one semantic (nq=12) step, then
    # TRAIN_STEPS photometric steps, with the schedule's loss at
    # TRAIN_ITER0, real Adam updates and densification statistics
    opt = OptimizationParams()
    opt_state = init_optimizer(state)
    cuda_lib.reset_launch_counts()
    losses, overflow = [], False
    for i in range(TRAIN_STEPS + 1):
        it = TRAIN_ITER0 + i
        b = bin_step(state, cam, duplicate_capacity=cap, device="cuda")
        state, opt_state, _, _, m = train_step(
            state, opt_state, cam, gt, bg, it, opt, duplicate_capacity=cap,
            binning=b, gt_semantic=gt_sem if i == 0 else None,
            device="cuda")
        losses.append(float(m["loss"]))
        overflow = overflow or bool(m["overflow"])
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launch_counts)
    steps = TRAIN_STEPS + 1
    finite = finite_state(torch, state, opt_state)
    tracked = int((state.denom > 0).sum())
    falls = losses[-1] < losses[1]
    ok = (finite and falls and not overflow and tracked > 0
          and all(launches[k] >= steps
                  for k in ("expand", "blend_fwd", "blend_bwd")))
    emit("train_main_path", steps=steps, first_step_nq=12, iteration0=
         TRAIN_ITER0, losses=losses, loss_falls=falls, overflow=overflow,
         launches=launches, finite=finite, surfels_with_stats=tracked,
         semantic_step_loss=losses[0])
    if not ok:
        raise AssertionError("the full-width training steps failed their "
                             "checks")

    # densify and prune at full capacity, with the gradient threshold at
    # the 90th percentile of the nonzero accumulated screen gradients, so
    # that thousands of surfels want to clone or split: nothing can be
    # placed, so no split parent may be pruned
    n_alive = int(state.num_alive)
    grads = state.grad_accum / state.denom.clamp(min=1)
    threshold = float(torch.quantile(grads[grads > 0], 0.9))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    d_state, mu, nu = densify_and_prune(
        state, opt_state.mu, opt_state.nu, threshold, opt.opacity_cull,
        None, generator=gen, percent_dense=opt.percent_dense)
    high = int((grads >= threshold).sum())
    d_ok = (int(d_state.num_alive) == n_alive == state.capacity
            and high > 0
            and finite_state(torch, d_state, opt_state._replace(mu=mu,
                                                                nu=nu)))
    emit("densify_full_capacity", capacity=state.capacity,
         alive_before=n_alive, alive_after=int(d_state.num_alive),
         grad_threshold=threshold, high_gradient=high, finite=d_ok)
    if not d_ok:
        raise AssertionError("densify_and_prune at full capacity changed "
                             "the surfel count or went non-finite")

    # ---- the step's time: host clock between synchronisations
    counter = [TRAIN_ITER0 + steps]

    def step(gt_semantic=None):
        nonlocal state, opt_state
        b = bin_step(state, cam, duplicate_capacity=cap, device="cuda")
        state, opt_state, _, _, _ = train_step(
            state, opt_state, cam, gt, bg, counter[0], opt,
            duplicate_capacity=cap, binning=b, gt_semantic=gt_semantic,
            device="cuda")
        counter[0] += 1

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = host_ms(torch, step, 12)
    step_ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the semantic step (nq=12), one warm-up, then 5
    step(gt_sem)
    sem_times = host_ms(torch, lambda: step(gt_sem), 5)

    it = TRAIN_ITER0 + steps + 20
    stage, full = step_stages(torch, state, cam, cap, bg, gt, opt, it)
    emit("train_time", step_ms_median=step_ms, step_ms_all=times,
         rays_per_s=W * H / (step_ms / 1e3),
         semantic_step_ms_median=statistics.median(sem_times),
         semantic_step_ms_all=sem_times, stages_ms=stage,
         loss_and_grads_ms=full,
         stages_sum_ms=sum(v for k, v in stage.items() if k != "k1"),
         peak_mem_gib=peak, iteration=it,
         note="step = bin_step + train_step; loss_and_grads = binning, "
              "stage1_loss and its gradients; each stage alone in CUDA "
              "events; k1 is inside forward_render and left out of the "
              "sum; the backward of the image assembly and "
              "finalize_render is not timed alone")
    emit("train_profile", **profile_frames(torch, step, 3))
    return k2, launches


def late_phases(torch, state, cam, cap, bg, gt, gt_sem):
    """The late-phase step at full width: gated K1/K2 against their plain
    versions (the late loss, and a dense-occlusion stack), then
    TRAIN_STEPS + 1 late steps with the sky, their time by stage and
    their profile. Returns what the kernels line needs of it."""
    from streetunveiler_torch.config import OptimizationParams
    from streetunveiler_torch.models.sky import init_sky
    from streetunveiler_torch.ops.rasterizer import (RasterizeSettings,
                                                     cuda_lib, kernel,
                                                     rasterize)
    from streetunveiler_torch.train.step import (bin_step, init_optimizer,
                                                 train_step)
    opt = OptimizationParams()
    sky = init_sky(torch.Generator().manual_seed(0), device="cuda")

    # ---- gated K1 and K2 against their plain versions
    def late_loss():
        loss, g, _ = loss_grads(torch, state, cam, gt, bg, opt, LATE_ITER0,
                                cap, gt_sem, True, sky)
        return loss, g
    k1_full, k2_full, a = gated_vs_plain(torch, kernel, late_loss,
                                         "full_width")
    if (a[8], a[9]) != (12, G_LATE):
        raise AssertionError(f"the late loss ran the blend at nq={a[8]}, "
                             f"G={a[9]}")
    k1_dense, k2_dense, _ = gated_vs_plain(
        torch, kernel, dense_gated_loss(torch, rasterize, RasterizeSettings),
        "dense")
    if not (k1_dense["counts"]["evaluated"]
            > 1.1 * k1_dense["ungated_evaluated"]):
        raise AssertionError("the dense case's gated chains did not outlive "
                             "the main chain")

    # ---- the late path: TRAIN_STEPS + 1 steps, every loss term on
    opt_state = init_optimizer(state)
    sky_opt = None
    cuda_lib.reset_launch_counts()
    losses, overflow = [], False
    for i in range(TRAIN_STEPS + 1):
        b = bin_step(state, cam, duplicate_capacity=cap, device="cuda")
        state, opt_state, sky, sky_opt, m = train_step(
            state, opt_state, cam, gt, bg, LATE_ITER0 + i, opt,
            sky_params=sky, sky_opt_state=sky_opt, gt_semantic=gt_sem,
            class_dist=True, duplicate_capacity=cap, binning=b,
            device="cuda")
        losses.append(float(m["loss"]))
        overflow = overflow or bool(m["overflow"])
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launch_counts)
    steps = TRAIN_STEPS + 1
    finite = finite_state(torch, state, opt_state, sky, sky_opt)
    falls = losses[-1] < losses[1]
    ok = (finite and falls and not overflow and sky_opt.step == steps
          and all(launches[k] >= steps for k in
                  ("expand", "blend_fwd_gated", "blend_bwd_gated")))
    emit("train_late_path", steps=steps, iteration0=LATE_ITER0,
         n_gates=G_LATE, losses=losses, loss_falls=falls,
         overflow=overflow, launches=launches, finite=finite,
         sky_adam_steps=sky_opt.step)
    if not ok:
        raise AssertionError("the full-width late steps failed their checks")

    # ---- the late step's time: host clock between synchronisations
    counter = [LATE_ITER0 + steps]

    def step():
        nonlocal state, opt_state, sky, sky_opt
        b = bin_step(state, cam, duplicate_capacity=cap, device="cuda")
        state, opt_state, sky, sky_opt, _ = train_step(
            state, opt_state, cam, gt, bg, counter[0], opt, sky_params=sky,
            sky_opt_state=sky_opt, gt_semantic=gt_sem, class_dist=True,
            duplicate_capacity=cap, binning=b, device="cuda")
        counter[0] += 1

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = host_ms(torch, step, 12)
    step_ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    stage, full = step_stages(torch, state, cam, cap, bg, gt, opt,
                              counter[0], gt_sem, True, sky)
    emit("train_late_time", step_ms_median=step_ms, step_ms_all=times,
         rays_per_s=W * H / (step_ms / 1e3), stages_ms=stage,
         loss_and_grads_ms=full,
         stages_sum_ms=sum(v for k, v in stage.items() if k != "k1"),
         peak_mem_gib=peak, iteration=counter[0], n_gates=G_LATE,
         note="step = bin_step + train_step with semantics, class_dist and "
              "the sky; k1 and k2 are the gated kernels (k1 inside "
              "forward_render, left out of the sum); sky_fwd_bwd is "
              "render_sky and its backward; each stage alone in CUDA events")
    emit("train_late_profile", **profile_frames(torch, step, 3))
    return dict(k1=dict(k1_full, max_abs_err=max(k1_full["max_abs_err"],
                                                 k1_dense["max_abs_err"])),
                k2=dict(k2_full, max_abs_err=max(k2_full["max_abs_err"],
                                                 k2_dense["max_abs_err"])),
                launches=launches, args=a)


def bench_fwd_bwd(torch, state, cam, iters=10):
    """The fwd+bwd time of ``bench.py:155-159``'s loss on the same scene:
    binning, then the gradient of Σ(color − 0)² + 0.01·Σ distortion +
    0.01·Σ normal² through ``rasterize`` at the default capacity, with a
    data dependence from step to step; mean over ``iters`` after warm-up."""
    from streetunveiler_torch import renderer
    from streetunveiler_torch.ops.rasterizer import rasterize
    from streetunveiler_torch.ops.rasterizer.api import (
        bin_for_camera, default_duplicate_capacity)
    settings = renderer._settings_for(cam, 1.0)
    args = [state.params.xyz.detach().clone(), state.get_scaling().detach(),
            state.get_rotation().detach(), state.get_opacity()[:, 0].detach(),
            torch.rand((state.capacity, 3), device="cuda",
                       generator=torch.Generator(device="cuda")
                       .manual_seed(0))]
    dup_cap = default_duplicate_capacity(state.capacity, W, H)
    bg = torch.zeros(3, device="cuda")

    def one(m):
        b = bin_for_camera(m, *args[1:4], cam.w2c, cam.K, settings,
                           duplicate_capacity=dup_cap)
        m = m.detach().requires_grad_(True)
        out = rasterize(m, *args[1:], cam.w2c, cam.K, settings, bg=bg,
                        duplicate_capacity=dup_cap, binning=b)
        loss = ((out.color ** 2).sum() + 0.01 * out.distortion.sum()
                + 0.01 * (out.normal ** 2).sum())
        (gm,) = torch.autograd.grad(loss, m)
        return (m + 1e-12 * gm).detach(), bool(out.overflow)

    m = args[0]
    for _ in range(2):
        m, _ = one(m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        m, ovf = one(m)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    emit("bench_fwd_bwd", definition="bench.py:155-159: binning + "
         "gradient of sum(color^2) + 0.01 sum(distortion) + 0.01 "
         "sum(normal^2) through rasterize, default capacity",
         ms_per_iter=dt * 1e3, rays_per_s=W * H / dt, iters=iters,
         overflow=ovf, capacity=dup_cap)


def ptxas_summary(log):
    """Registers and spills from the build log's ptxas lines: the
    production instantiations the paths run (every K1, K2 at nq 6, 9 and
    12, K2 gated at (6, 3) and (12, 5), K3), and every instantiation of the
    measurement tools (T1<G,variant>, T2<nq,G,variant>, T3 and T4 kernels),
    named by the translation unit that built them."""
    import re
    from streetunveiler_torch.tools import bisect_bwd, bisect_fwd
    keep = {"K1<%d>" % g for g in range(7)} | {
        "K2<6,0>", "K2<9,0>", "K2<12,0>", "K2<6,3>", "K2<12,5>", "K3"}
    out, name, unit = {}, None, ""
    for line in log.splitlines():
        if line.startswith("== nvcc "):
            unit = line.split()[2]
        elif "Compiling entry function" in line:
            ints = lambda m: [int(x) for x in m.groups()]
            fwd = re.search(r"blend_fwd_kernelILi(\d+)ELi(\d+)E", line)
            bwd = re.search(r"blend_bwd_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                            line)
            # the kernel's name follows its length in the mangled name
            probe = re.search(r"\d(reduce_[a-z]+|prefix_[a-z]+)(?:ILi(\d+)E)?",
                              line)
            if fwd and unit.startswith("bisect"):
                g, v = ints(fwd)
                name = f"T1<{g},{bisect_fwd.VARIANTS[v]}>"
            elif fwd:
                name = f"K1<{ints(fwd)[0]}>"
            elif bwd and unit.startswith("bisect"):
                q, g, v = ints(bwd)
                name = f"T2<{q},{g},{bisect_bwd.VARIANTS[v]}>"
            elif bwd:
                q, g, _ = ints(bwd)
                name = f"K2<{q},{g}>"
            elif probe:
                tag = "T3" if unit.startswith("micro_reduce") else "T4"
                name = f"{tag} {probe.group(1)}" + (
                    f"<{probe.group(2)}>" if probe.group(2) else "")
            else:
                name = "K3" if "expand_kernel" in line else None
            if name and not name.startswith("T") and name not in keep:
                name = None
        elif name and ("spill" in line or "registers" in line):
            out.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return out


def reference_small_gated(torch, rasterize, settings_cls):
    """``rasterize(class_gates=...)`` with 3 gates on the card at 64×48
    against three separately gated renders through the port's own path
    (opacity masked per class), as tests/test_kernel.py:124-165:
    class_dist at 5e-5 and the main channels unchanged; the gradients of
    Σ class_dist against the sum of the separate renders' distortion
    gradients at atol 2e-4·max|g|, rtol 1e-3."""
    import numpy as np
    args, w2c, K = small_scene(torch)
    st = settings_cls(width=64, height=48)
    cls = np.random.default_rng(11).integers(0, 3, args[0].shape[0])
    gates = torch.as_tensor(np.stack([cls == g for g in range(3)], 1),
                            device="cuda")
    masked = lambda op, g: torch.where(gates[:, g], op, torch.zeros_like(op))
    out = rasterize(*args, w2c, K, st, class_gates=gates)
    base = rasterize(*args, w2c, K, st)
    fwd_err = [float((out.class_dist[..., g] - rasterize(
        *args[:3], masked(args[3], g), args[4], w2c, K, st).distortion
    ).abs().max()) for g in range(3)]
    main_err = {f: float((getattr(out, f) - getattr(base, f)).abs().max())
                for f in ("color", "alpha", "distortion")}

    def grads(fused):
        leaves = [args[i].clone().requires_grad_(True) for i in (0, 1, 3)]
        p, sc, op = leaves
        if fused:
            loss = rasterize(p, sc, args[2], op, args[4], w2c, K, st,
                             class_gates=gates).class_dist.sum()
        else:
            loss = sum(rasterize(p, sc, args[2], masked(op, g), args[4], w2c,
                                 K, st).distortion.sum() for g in range(3))
        return torch.autograd.grad(loss, leaves)

    bwd = {}
    for name, a, b in zip(("means", "scales", "opacities"), grads(True),
                          grads(False)):
        scale = float(b.abs().max())
        bwd[name] = dict(max_abs=scale, max_abs_err=float((a - b).abs().max()),
                         within_tolerance=bool(torch.allclose(
                             a, b, atol=2e-4 * scale, rtol=1e-3)))
    ok = (all(e <= TOL_MOMENT for e in fwd_err)
          and main_err["color"] <= TOL_PAYLOAD
          and main_err["alpha"] <= TOL_ALPHA
          and main_err["distortion"] <= TOL_MOMENT
          and float(out.class_dist.abs().max()) > 0
          and all(v["within_tolerance"] for v in bwd.values()))
    emit("reference_small_gated", class_dist_max_abs_err=fwd_err,
         class_dist_max=float(out.class_dist.abs().max()),
         main_vs_ungated_max_abs_err=main_err, gradients=bwd,
         within_tolerance=ok)
    if not ok:
        raise AssertionError("gated render on the card disagrees with the "
                             "separately gated renders")


def train_scene_synthetic(torch, late=False):
    """The training CLI on the synthetic street scene at its defaults
    (4,000 points, 12 cameras, 160x112, every 8th view held out) for 300
    iterations with densification from iteration 100 at a gradient
    threshold of 5e-5 (at the default 2e-4 no surfel of this scene clones
    or splits in 300 iterations); held-out PSNR before and after, the
    surfel count growing, and the checkpoint read back. With ``late``:
    ``--semantics --sky`` and the late phase from iteration 150
    (``--semantic_dist_from_iter 150``), the sky composited in the
    held-out PSNR and read back from the checkpoint."""
    import dataclasses
    from streetunveiler_torch.cli import train as cli_train
    from streetunveiler_torch.cli.common import scene_background
    from streetunveiler_torch.config import ModelParams
    from streetunveiler_torch.cli.common import load_scene_info
    from streetunveiler_torch.models.sky import init_sky
    from streetunveiler_torch.scene.scene import Scene
    from streetunveiler_torch.train.checkpoint import load_checkpoint
    from streetunveiler_torch.train.loop import evaluate_views
    from streetunveiler_torch.ops.rasterizer import cuda_lib

    iters = 300
    scene = Scene(load_scene_info(ModelParams(eval=True), seed=0,
                                  device="cuda"), device="cuda")
    state0 = scene.create_state()
    bg = scene_background(scene, device="cuda")
    # the CLI's initial sky (--seed 0)
    sky0 = init_sky(torch.Generator().manual_seed(0), device="cuda") \
        if late else None
    p0, _ = evaluate_views(state0, scene.test_cameras, scene.test_images, bg,
                           sky_params=sky0)
    flags = (["--semantics", "--sky", "--semantic_dist_from_iter", "150"]
             if late else [])
    cuda_lib.reset_launch_counts()
    with tempfile.TemporaryDirectory(dir=cuda_lib.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        state, reports = cli_train.main([
            "--model_path", tmp, "--iterations", str(iters), "--eval",
            "--log_every", "100", "--eval_every", "300", "--save_every",
            str(iters), "--densify_from_iter", "100",
            "--densify_grad_threshold", "5e-5", "--device", "cuda"] + flags)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ck, _, it, sky, _ = load_checkpoint(os.path.join(
            tmp, "checkpoint", f"iteration_{iters}"), device="cuda")
        same = all(torch.equal(getattr(ck.params, f.name),
                               getattr(state.params, f.name))
                   for f in dataclasses.fields(ck.params)) and torch.equal(
                       ck.alive, state.alive)
        ply = os.path.exists(os.path.join(tmp, "point_cloud",
                                          f"iteration_{iters}",
                                          "point_cloud.ply"))
    launches = dict(cuda_lib.launch_counts)
    sky_ok = (sky is None) if not late else (
        sky is not None and float((sky.mlp_b[-1] - sky0.mlp_b[-1]).abs()
                                  .max()) > 0)
    late_ok = not late or (launches["blend_fwd_gated"] >= iters - 150
                           and launches["blend_bwd_gated"] >= iters - 150)
    p1 = reports[-1].test_psnr
    grew = max(r.n_alive for r in reports) > int(state0.num_alive)
    ok = (same and ply and it == iters and p1 >= p0 + 1.0 and grew
          and sky_ok and late_ok)
    emit("train_scene_synthetic_late" if late else "train_scene_synthetic",
         iterations=iters, flags=flags, test_psnr_before=p0,
         test_psnr_after=p1, train_psnr=[r.psnr for r in reports],
         n_alive=[r.n_alive for r in reports],
         init_alive=int(state0.num_alive), densified=grew, wall_s=wall,
         checkpoint_roundtrip=same, ply_written=ply,
         checkpoint_sky_trained=sky_ok, launches=launches)
    if not ok:
        raise AssertionError("training on the synthetic street did not "
                             "raise held-out PSNR by 1 dB, did not "
                             "densify, did not run the late phase, or its "
                             "checkpoint (the sky included) did not read "
                             "back")


# ---- 9. the measurement tools (streetunveiler_torch/tools/)
# T1/T2 variants against their plain versions: per channel (record row)
# the largest error over that channel's (row's) largest magnitude, at
# least 1 for T1's non-floor channels; the floors are 1e-30-scaled values
# held relative to their own size. full_nopair's stand-in α is unbounded,
# so its sums reach ~1e7 and cancel. T1's median is the depth of the last
# pair before T falls to 0.5; the kernel's running product and the plain
# version's chunked cumprod round apart, so at a knife-edge pixel the
# median moves to a neighbouring pair: such pixels count with the lk
# mismatches against FLIP_FRACTION (as K1's knife-edge of early
# termination) and the channels are held on the rest. A stand-in whose α
# is tiny (full_nopair: ~1e-5) lowers T by about the products' rounding
# difference per pair, so its medians flip most.
VARIANT_TOL, NOPAIR_TOL = 1e-4, 1e-3
# T3/T4 against their plain versions, per output column (channel) relative
# to its largest magnitude: f32 sums in another order; the tensor-core
# modes' operands are rounded alike on both sides, but the tensor core
# accumulates in its own order and rounding
MICRO_TOL_F32, MICRO_TOL_MMA = 1e-4, 1e-3
T4_OPS_PER_PAIR = 50   # csrc/micro_prefix.cu's serial mode, counted:
#   the fake pair ~27, the epilogue ~17, the four running sums 6
TOOL_REPS = 10


def dense_streams(torch):
    """The dense-occlusion stack of ``dense_gated_loss`` (1,500 mostly
    opaque surfels at 128×96, the nearest third class 0, the rest classes
    1-4 at random), binned as ``rasterize`` does: the photometric records
    (nq 6) and the late ones (nq 12 with the one-hot classes, G = 5 gates).
    Returns {G: blend arguments}."""
    import numpy as np
    import torch.nn.functional as F
    from streetunveiler_torch.ops.rasterizer import (RasterizeSettings,
                                                     kernel, tiles)
    from streetunveiler_torch.ops.rasterizer.api import (
        _gather_records, default_duplicate_capacity, encode_extra)
    from streetunveiler_torch.ops.rasterizer.preprocess import \
        preprocess_surfels
    rng = np.random.default_rng(0)
    n, w, h, f = 1500, 128, 96, 110.0
    z = rng.uniform(2.0, 30.0, n)
    means = np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(-2, 2, n), z],
                     1)
    cls = np.where(z < np.quantile(z, 1 / 3), 0, rng.integers(1, 5, n))
    cuda = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                     device="cuda")
    args = [cuda(means), cuda(rng.uniform(0.2, 0.9, (n, 2))),
            cuda(rng.normal(size=(n, 4))), cuda(rng.uniform(0.5, 0.98, n)),
            cuda(rng.uniform(0, 1, (n, 3)))]
    st = RasterizeSettings(width=w, height=h)
    K = cuda([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    sur = preprocess_surfels(*args, cuda(np.eye(4)), K, st)
    b = tiles.bin_surfels_stream(sur.center2d, sur.ext, sur.depth,
                                 sur.valid, w, h, kernel.TILE_W,
                                 kernel.TILE_H,
                                 default_duplicate_capacity(n, w, h),
                                 cull=sur.cull)
    if bool(b.overflow):
        raise AssertionError("the dense stack overflowed its capacity")
    cls_t = torch.as_tensor(cls, device="cuda")
    out = {}
    for late in (False, True):
        extra = F.one_hot(cls_t, 6).float() if late else None
        gates = torch.stack([cls_t == g for g in range(5)], 1) if late \
            else None
        pack, n_gates = encode_extra(extra, gates)
        recT = _gather_records(kernel.pack_geometry_T(sur, n, pack),
                               b.sorted_surfel)
        out[n_gates] = (recT, b.tile_offsets, b.tiles_x, b.tiles_y, st,
                        12 if late else 6, n_gates)
    return out


def rel_err(got, want, dims, floor):
    """Largest |got − want| over ``dims`` relative to max(|want|, floor),
    per remaining index; returns the largest."""
    scale = want.abs().amax(dim=dims).clamp(min=max(floor, 1e-38))
    return float(((got - want).abs().amax(dim=dims) / scale).max())


def t1_vs_plain(torch, bf, k1_args):
    """Every T1 variant against its plain version on ``k1_args``: lk,
    every lk_g and the median (within TOL_MEDIAN) on all but FLIP_FRACTION
    of pixels, each channel within its tolerance over the pixels where they
    all agree (mismatch_frac counts the rest). Each entry also holds the
    median flips, the channel of the largest error, the largest absolute
    error and the pairs the plain version evaluated."""
    nq, n_gates = k1_args[5], k1_args[6]
    ch = nq + 6
    out, ok = {}, True
    for v in bf.VARIANTS:
        acc, lk = bf.bisect_forward_cuda(v, *k1_args)
        want_acc, want_lk, count = bf.bisect_forward_plain(
            v, *k1_args, count_pairs=True)
        torch.cuda.synchronize()
        same = torch.ones(acc.shape[:2], dtype=torch.bool, device="cuda")
        if lk is not None:
            same &= (lk == want_lk)[..., 0]
        floor = v in bf.FLOORS
        for g in range(0 if floor else n_gates):   # a floor has no lk_g
            same &= acc[..., ch + 4 * g + 3] == want_acc[..., ch + 4 * g + 3]
        med = nq + 5
        flips = torch.zeros_like(same)
        if not floor and v != "full_nomed":
            flips = same & ((acc[..., med] - want_acc[..., med]).abs()
                            > TOL_MEDIAN * want_acc[..., med].abs().clamp(
                                min=1.0))
            same &= ~flips
        scale = want_acc[same].abs().amax(dim=0).clamp(
            min=1e-38 if floor else 1.0)
        per_channel = (acc[same] - want_acc[same]).abs().amax(dim=0) / scale
        err = float(per_channel.max())
        tol = NOPAIR_TOL if v == "full_nopair" else VARIANT_TOL
        mism = 1.0 - float(same.float().mean())
        v_ok = (mism <= FLIP_FRACTION and err <= tol
                and bool(torch.isfinite(acc).all())
                and (lk is None) == (want_lk is None))
        out[v] = dict(mismatch_frac=mism,
                      median_flip_frac=float(flips.float().mean()),
                      max_rel_err=err, worst_channel=int(per_channel.argmax()),
                      tolerance=tol,
                      max_abs_err=float((acc[same] - want_acc[same]).abs()
                                        .max()),
                      evaluated_pairs=count["evaluated"],
                      within_tolerance=v_ok)
        ok = ok and v_ok
    return out, ok


def t2_vs_plain(torch, bb, a):
    """Every T2 variant against its plain version on the arguments ``a``
    of a backward: per record row 0..9+nq, the largest error over the
    row's largest gradient (ROW_TOL_REL, as K2)."""
    nq = a[8]
    out, ok = {}, True
    for v in bb.VARIANTS:
        got = bb.bisect_backward_cuda(v, *a)
        want = bb.bisect_backward_plain(v, *a)
        torch.cuda.synchronize()
        rows = 10 + nq
        err = rel_err(got[:rows], want[:rows], 1, 0.0)
        v_ok = (err <= ROW_TOL_REL and bool(torch.isfinite(got).all())
                and not bool(got[rows:].any()))
        out[v] = dict(max_rel_err_per_row=err, tolerance=ROW_TOL_REL,
                      max_abs_err=float((got - want).abs().max()),
                      within_tolerance=v_ok)
        ok = ok and v_ok
    return out, ok


def tool_phases(torch, photo_args, late_args, k2_photo):
    """Phase group 9: the measurement tools T1-T4. Every T1/T2 variant
    against its plain version on the dense stack and at full width, T1/T2
    ``full`` bit for bit against the production K1/K2, and every variant
    and mode timed at full width. ``photo_args``/``late_args`` are the
    captured arguments of the photometric (nq 6) and late (nq 12, G 5)
    backward at full width; ``k2_photo`` K2's line on the former. Returns
    the kernels-line rows."""
    from streetunveiler_torch.ops.rasterizer import cuda_lib, kernel
    from streetunveiler_torch.tools import (bisect_bwd, bisect_fwd,
                                            micro_prefix, micro_reduce,
                                            timing)
    cuda_lib.reset_launch_counts()
    t_start = time.perf_counter()

    # ---- against the plain versions, on the dense stack
    dense = dense_streams(torch)
    all_ok = True
    for n_gates, label in ((0, "photometric"), (5, "late")):
        k1_args = dense[n_gates]
        acc, lk = kernel.blend_forward_cuda(*k1_args)
        nq = k1_args[5]
        a = k1_args[:5] + (acc, lk, bisect_bwd.cotangents(acc, nq, n_gates),
                           nq, n_gates)
        f_res, f_ok = t1_vs_plain(torch, bisect_fwd, k1_args)
        emit(f"bisect_fwd_vs_plain_{label}_dense", nq=nq, n_gates=n_gates,
             duplicates=int(k1_args[1][-1]), variants=f_res,
             within_tolerance=f_ok)
        b_res, b_ok = t2_vs_plain(torch, bisect_bwd, a)
        emit(f"bisect_bwd_vs_plain_{label}_dense", nq=nq, n_gates=n_gates,
             variants=b_res, within_tolerance=b_ok)
        all_ok = all_ok and f_ok and b_ok

    # ---- at full width on the main path's streams: full bit for bit
    # against the production kernels, every variant against its plain
    # version, then every variant timed
    rows = {}
    for a, label in ((photo_args, "photometric"), (late_args, "late")):
        nq, n_gates = a[8], a[9]
        k1_args = a[:5] + (nq, n_gates)
        acc_t, lk_t = bisect_fwd.bisect_forward_cuda("full", *k1_args)
        acc_k, lk_k = kernel.blend_forward_cuda(*k1_args)
        d_t = bisect_bwd.bisect_backward_cuda("full", *a)
        d_k = kernel.blend_backward_cuda(*a)
        torch.cuda.synchronize()
        fwd_equal = torch.equal(acc_t, acc_k) and torch.equal(lk_t, lk_k)
        bwd_equal = torch.equal(d_t, d_k)
        emit(f"bisect_fwd_full_{label}", nq=nq, n_gates=n_gates,
             bit_exact=fwd_equal)
        emit(f"bisect_bwd_full_{label}", nq=nq, n_gates=n_gates,
             bit_exact=bwd_equal)
        del acc_t, lk_t, acc_k, lk_k, d_t, d_k
        all_ok = all_ok and fwd_equal and bwd_equal

        f_res, f_ok = t1_vs_plain(torch, bisect_fwd, k1_args)
        emit(f"bisect_fwd_vs_plain_{label}_full_width", nq=nq,
             n_gates=n_gates, duplicates=int(a[1][-1]), variants=f_res,
             within_tolerance=f_ok)
        b_res, b_ok = t2_vs_plain(torch, bisect_bwd, a)
        emit(f"bisect_bwd_vs_plain_{label}_full_width", nq=nq,
             n_gates=n_gates, variants=b_res, within_tolerance=b_ok)
        all_ok = all_ok and f_ok and b_ok

        fwd = {}
        for v in bisect_fwd.VARIANTS:
            ms = timing.median_ms(
                lambda: bisect_fwd.bisect_forward_cuda(v, *k1_args),
                TOOL_REPS)
            fwd[v] = dict(ms=ms, evaluated_pairs=f_res[v]["evaluated_pairs"])
        for v in bisect_fwd.VARIANTS:
            fwd[v]["ms_minus_full"] = fwd[v]["ms"] - fwd["full"]["ms"]
        emit(f"bisect_fwd_{label}", nq=nq, n_gates=n_gates,
             duplicates=int(a[1][-1]), reps=TOOL_REPS, variants=fwd,
             note="median of CUDA-event times; evaluated_pairs from the "
                  "plain version's count")
        # the kernel stores only the slots it walks into a zeroed dgrad:
        # each variant's launches share one buffer zeroed before them, and
        # the memset that a fresh dgrad costs is timed alone
        bwd = {}
        for v in bisect_bwd.VARIANTS:
            buf = torch.zeros_like(a[0])
            ms = timing.median_ms(
                lambda: bisect_bwd.bisect_backward_cuda(v, *a, out=buf),
                TOOL_REPS)
            bwd[v] = dict(ms=ms, evaluated_pairs=bisect_bwd.evaluated_pairs(
                v, a[1], a[5], a[6], nq, n_gates))
            del buf
        for v in bisect_bwd.VARIANTS:
            bwd[v]["ms_minus_full"] = bwd[v]["ms"] - bwd["full"]["ms"]
        zero_ms = timing.median_ms(lambda: torch.zeros_like(a[0]), TOOL_REPS)
        emit(f"bisect_bwd_{label}", nq=nq, n_gates=n_gates, reps=TOOL_REPS,
             variants=bwd, dgrad_zero_fill_ms=zero_ms,
             dgrad_bytes=4 * a[0].numel(),
             note="median of CUDA-event times, dgrad zeroed outside the "
                  "timed launches; a fresh dgrad (as K2's wrapper makes) "
                  "adds dgrad_zero_fill_ms")
        if label == "photometric":
            t1_plain_ms = timing.median_ms(
                lambda: bisect_fwd.bisect_forward_plain("full", *k1_args), 1)
            nbytes = 4 * (a[0].shape[0] * int(a[1][-1]) + a[1].numel()
                          + a[5].numel() + a[6].numel())
            t1_bound, t1_by = bound(
                nbytes, K1_OPS_PER_PAIR * fwd["full"]["evaluated_pairs"])
            t2_plain_ms = timing.median_ms(
                lambda: bisect_bwd.bisect_backward_plain("full", *a), 1)
            rows["T1"] = dict(ms=fwd["full"]["ms"], plain_ms=t1_plain_ms,
                              bound_ms=t1_bound, bound_by=t1_by,
                              max_abs_err=f_res["full"]["max_abs_err"])
            rows["T2"] = dict(ms=bwd["full"]["ms"], plain_ms=t2_plain_ms,
                              bound_ms=k2_photo["bound_ms"],
                              bound_by=k2_photo["bound_by"],
                              max_abs_err=b_res["full"]["max_abs_err"])

    # ---- T3: micro_reduce at the TPU tool's size
    x = micro_reduce.make_input()
    nbytes = x.numel() * 4
    modes, t3_ok = {}, True
    for mode, k in micro_reduce.MODES:
        got = micro_reduce.micro_reduce_cuda(mode, k, x)
        want = micro_reduce.micro_reduce_plain(mode, k, x)
        torch.cuda.synchronize()
        cols = 1 if mode == "pair" else k
        err = rel_err(got[:, :cols], want[:, :cols], 0, 0.0)
        tol = MICRO_TOL_MMA if mode == "mma" else MICRO_TOL_F32
        m_ok = err <= tol and not bool(got[:, cols:].any())
        ms = timing.median_ms(lambda: micro_reduce.micro_reduce_cuda(
            mode, k, x), TOOL_REPS)
        modes[f"{mode}_k{k}"] = dict(
            ms=ms, ns_per_block=ms * 1e6 / micro_reduce.NV,
            precision=micro_reduce.PRECISION[mode], max_rel_err=err,
            tolerance=tol, within_tolerance=m_ok)
        t3_ok = t3_ok and m_ok
    t3_plain_ms = timing.median_ms(
        lambda: micro_reduce.micro_reduce_plain("thread", 13, x), 1)
    t3_lib_ms = timing.median_ms(
        lambda: micro_reduce.micro_reduce_library(13, x), TOOL_REPS)
    t3_err = float((micro_reduce.micro_reduce_cuda("thread", 13, x)
                    - micro_reduce.micro_reduce_plain("thread", 13, x)
                    ).abs().max())
    # the most operations: the pair chain's 50 per element
    t3_bound, t3_by = bound(nbytes, 50 * x.numel())
    emit("micro_reduce", nv=micro_reduce.NV, bytes=nbytes, modes=modes,
         plain_ms_thread_k13=t3_plain_ms, library_ms=t3_lib_ms,
         library_call="x.view(512, NV, 128).sum(-1).sum(-1)[:, None] * w",
         bound_ms=t3_bound, bound_by=t3_by, within_tolerance=t3_ok)
    rows["T3"] = dict(ms=modes["thread_k13"]["ms"], plain_ms=t3_plain_ms,
                      bound_ms=t3_bound, bound_by=t3_by, max_abs_err=t3_err,
                      library_ms=t3_lib_ms)
    del x
    all_ok = all_ok and t3_ok

    # ---- T4: micro_prefix at the TPU tool's size
    rec = micro_prefix.make_input()
    n_chunks = micro_prefix.NCHUNK
    pairs = n_chunks * micro_prefix.S * micro_prefix.P
    modes, t4_ok = {}, True
    for mode in micro_prefix.MODES:
        got = micro_prefix.micro_prefix_cuda(mode, rec)
        want = micro_prefix.micro_prefix_plain(mode, rec)
        torch.cuda.synchronize()
        err = rel_err(got, want, (0, 1), 0.0)
        tol = MICRO_TOL_MMA if mode.startswith("mma") else MICRO_TOL_F32
        m_ok = err <= tol and bool(torch.isfinite(got).all())
        ms = timing.median_ms(lambda: micro_prefix.micro_prefix_cuda(
            mode, rec), TOOL_REPS)
        modes[mode] = dict(ms=ms, ns_per_chunk=ms * 1e6 / n_chunks,
                           precision=micro_prefix.PRECISION[mode],
                           max_rel_err=err, tolerance=tol,
                           within_tolerance=m_ok)
        t4_ok = t4_ok and m_ok
    t4_plain_ms = timing.median_ms(
        lambda: micro_prefix.micro_prefix_plain("serial", rec), 1)
    t4_err = float((micro_prefix.micro_prefix_cuda("serial", rec)
                    - micro_prefix.micro_prefix_plain("serial", rec)
                    ).abs().max())
    # what the function reads: rows 0-2 of each chunk; writes: out
    t4_bytes = 4 * (3 * n_chunks * micro_prefix.S
                    + n_chunks // micro_prefix.CPT * micro_prefix.P * 16)
    t4_bound, t4_by = bound(t4_bytes, T4_OPS_PER_PAIR * pairs)
    # the library yardstick, the scan alone: torch.cumsum over the four
    # prefix operands (4 × 4.4 GB in and out), when the card has room
    t4_lib_ms = None
    torch.cuda.empty_cache()
    if torch.cuda.mem_get_info()[0] > 48 * 2 ** 30:
        ops = micro_prefix.prefix_operands(rec)
        t4_lib_ms = timing.median_ms(lambda: torch.cumsum(ops, dim=-1), 3)
        del ops
        torch.cuda.empty_cache()
    emit("micro_prefix", chunks=n_chunks, pairs=pairs, modes=modes,
         plain_ms_serial=t4_plain_ms, library_ms=t4_lib_ms,
         library_call="torch.cumsum(prefix_operands(rec), dim=-1): the scan "
                      "of the four operands alone",
         bytes=t4_bytes, operations=T4_OPS_PER_PAIR * pairs,
         bound_ms=t4_bound, bound_by=t4_by, within_tolerance=t4_ok)
    rows["T4"] = dict(ms=modes["serial"]["ms"], plain_ms=t4_plain_ms,
                      bound_ms=t4_bound, bound_by=t4_by, max_abs_err=t4_err,
                      library_ms=t4_lib_ms)
    all_ok = all_ok and t4_ok
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launch_counts)
    emit("tools_summary", seconds=time.perf_counter() - t_start,
         tool_launches={k: launches[k] for k in ("bisect_fwd", "bisect_bwd",
                                                 "micro_reduce",
                                                 "micro_prefix")},
         within_tolerance=all_ok)
    if not all_ok:
        raise AssertionError("a measurement tool's kernel disagrees with its "
                             "plain version or with the production kernel")
    for key, name in (("T1", "bisect_fwd"), ("T2", "bisect_bwd"),
                      ("T3", "micro_reduce"), ("T4", "micro_prefix")):
        rows[key]["tool_launches"] = launches[name]
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from streetunveiler_torch import renderer
    from streetunveiler_torch.ops.rasterizer import (RasterizeSettings,
                                                     cuda_lib, rasterize,
                                                     rasterize_oracle)
    from streetunveiler_torch.ops.rasterizer import kernel, tiles
    from streetunveiler_torch.ops.rasterizer.api import (_gather_records,
                                                         rasterize_stream)
    from streetunveiler_torch.ops.rasterizer.preprocess import \
        preprocess_surfels
    from streetunveiler_torch.scene.cameras import Camera
    from streetunveiler_torch.tools.street import street_state
    from streetunveiler_torch.utils.ply import state_from_ply, state_to_ply

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, kind=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # ---- 2. build
    t0 = time.perf_counter()
    cuda_lib.load_library()
    build_s = time.perf_counter() - t0
    emit("build", seconds=build_s, library=os.path.relpath(
        cuda_lib.library_path(), ROOT),
        ptxas=ptxas_summary(cuda_lib.build_log()))

    # ---- small-input reference: tiled path on the card vs untiled oracle
    args, w2c, K = small_scene(torch)
    st_small = RasterizeSettings(width=64, height=48)
    bg = torch.tensor([0.1, 0.2, 0.3], device="cuda")
    out = rasterize(*args, w2c, K, st_small, bg=bg)
    ref = rasterize_oracle(*args, w2c, K, st_small, bg=bg, chunk_surfels=64,
                           pixel_block=1024)
    small_err = {f: float((getattr(out, f) - getattr(ref, f)).abs().max())
                 for f in ("color", "alpha", "expected_depth", "normal",
                           "distortion", "median_depth")}
    small_tol = dict(color=5e-5, alpha=2e-5, expected_depth=5e-4,
                     normal=5e-5, distortion=5e-5, median_depth=1e-5)
    small_ok = all(small_err[f] <= small_tol[f] for f in small_tol)
    emit("reference_small", max_abs_err=small_err, within_tolerance=small_ok,
         alpha_max=float(ref.alpha.max()))
    if not small_ok or float(ref.alpha.max()) <= 0.5:
        raise AssertionError("tiled render on the card disagrees with the "
                             "untiled oracle")
    reference_small_gated(torch, rasterize, RasterizeSettings)

    # ---- the full-width scene, through a PLY round trip
    t0 = time.perf_counter()
    state0 = street_state(device="cuda")
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_lib.BUILD_DIR) as tmp:
        path = os.path.join(tmp, "street.ply")
        state_to_ply(path, state0)
        state = state_from_ply(path, spatial_scale=30.0, capacity=N_SURFELS,
                               device="cuda")
    for name in ("xyz", "features_dc", "features_rest", "scaling",
                 "rotation", "opacity"):
        if not torch.equal(getattr(state.params, name),
                           getattr(state0.params, name)):
            raise AssertionError(f"PLY round trip changed {name}")
    cam = Camera(w2c=torch.eye(4, device="cuda"),
                 K=torch.tensor([[FOCAL, 0, W / 2], [0, FOCAL, H / 2],
                                 [0, 0, 1]], device="cuda"),
                 width=W, height=H)
    bg = torch.zeros(3, device="cuda")
    torch.cuda.synchronize()
    emit("scene", surfels=N_SURFELS, width=W, height=H, focal=FOCAL,
         sh_degree=state.sh_degree, setup_s=time.perf_counter() - t0)

    # ---- 5a. the main path, once, with the launch counts read around it
    cuda_lib.reset_launch_counts()
    cap = renderer.measure_duplicate_capacity([cam], state, device="cuda")
    res = renderer.render(cam, state, bg, duplicate_capacity=cap,
                          device="cuda")
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launch_counts)
    fields = ("render", "rend_alpha", "rend_normal", "rend_dist",
              "surf_depth", "surf_normal", "expected_depth", "median_depth")
    finite = {f: bool(torch.isfinite(getattr(res, f)).all()) for f in fields}
    shapes_ok = (tuple(res.render.shape) == (H, W, 3)
                 and tuple(res.rend_alpha.shape) == (H, W))
    alpha_max = float(res.rend_alpha.max())
    overflow = bool(res.overflow)
    emit("main_path", duplicate_capacity=cap, demand=int(res.demand),
         overflow=overflow, launches=launches, finite=finite,
         alpha_max=alpha_max, alpha_mean=float(res.rend_alpha.mean()),
         shapes_ok=shapes_ok)
    if not (all(finite.values()) and shapes_ok and alpha_max > 0.5
            and not overflow
            and all(launches[k] > 0 for k in ("expand", "blend_fwd"))):
        raise AssertionError("the full-width render failed its checks")

    # stage inputs of that render, for the kernel comparisons and timings
    settings = renderer._settings_for(cam, 1.0)
    opac = state.get_opacity()[:, 0]
    colors = renderer.surfel_colors(state, cam, 3)
    geo = (state.params.xyz, state.get_scaling(), state.get_rotation(), opac)
    sur = preprocess_surfels(*geo, colors, cam.w2c, cam.K, settings)
    bin_args = (sur.center2d, sur.ext, sur.depth, sur.valid, W, H,
                kernel.TILE_W, kernel.TILE_H)
    tbl, dup_start = tiles.ranked_table(*bin_args, cull=sur.cull)
    binning = tiles.bin_surfels_stream(*bin_args, cap, cull=sur.cull)
    n_tiles = binning.tiles_x * binning.tiles_y
    demand = int(binning.demand)

    # ---- 3. K3 against its plain version (exact)
    k3_args = (tbl, dup_start, cap, binning.tiles_x, n_tiles, True)
    got = tiles.expand_duplicates_cuda(*k3_args)
    want = tiles.expand_duplicates_plain(*k3_args)
    torch.cuda.synchronize()
    k3_equal = all(torch.equal(g, w) for g, w in zip(got, want))
    # and at a capacity far below the demand: the overflow path, where
    # only slots below the capacity are written
    k3_over = (tbl, dup_start, 64 * 1024, binning.tiles_x, n_tiles, True)
    over_equal = all(torch.equal(g, w) for g, w in zip(
        tiles.expand_duplicates_cuda(*k3_over),
        tiles.expand_duplicates_plain(*k3_over)))
    k3_ms = cuda_ms(torch, lambda: tiles.expand_duplicates_cuda(*k3_args),
                    50)
    k3_plain_ms = cuda_ms(torch,
                          lambda: tiles.expand_duplicates_plain(*k3_args), 5)
    capp = got[0].numel()
    k3_bytes = 4 * (tbl.numel() + dup_start.numel() + 2 * capp)
    k3_bound = max(k3_bytes / HBM_BYTES_PER_S,
                   K3_OPS_PER_SLOT * capp / F32_OPS_PER_S) * 1e3
    emit("k3_vs_plain", exact=k3_equal, exact_at_overflow=over_equal,
         slots=capp, duplicates=demand, ms=k3_ms, plain_ms=k3_plain_ms,
         bytes=k3_bytes, bound_ms=k3_bound)
    if not (k3_equal and over_equal):
        raise AssertionError("K3 differs from its plain version")

    # ---- 4. K1 against its plain version, nq=6 and nq=9
    packT = kernel.pack_geometry_T(sur, N_SURFELS)
    recT = _gather_records(packT, binning.sorted_surfel)
    off = binning.tile_offsets
    k1_args = (recT, off, binning.tiles_x, binning.tiles_y, settings, 6)
    acc, lk = kernel.blend_forward_cuda(*k1_args)
    want_acc, want_lk, counts = kernel.blend_forward_plain(
        *k1_args, count_pairs=True)
    pairs = counts["evaluated"]
    torch.cuda.synchronize()
    k1_err = check_blend(torch, acc, lk, want_acc, want_lk, 6,
                         "k1_vs_plain_nq6")
    onehot = torch.nn.functional.one_hot(state.semantics.long(), 6).float()
    recT9 = _gather_records(kernel.pack_geometry_T(sur, N_SURFELS,
                                                   onehot[:, 3:6]),
                            binning.sorted_surfel)
    k1_9 = (recT9, off, binning.tiles_x, binning.tiles_y, settings, 9)
    acc9, lk9 = kernel.blend_forward_cuda(*k1_9)
    want9 = kernel.blend_forward_plain(*k1_9)
    torch.cuda.synchronize()
    k1_err = max(k1_err, check_blend(torch, acc9, lk9, *want9, 9,
                                     "k1_vs_plain_nq9"))
    k1_ms = cuda_ms(torch, lambda: kernel.blend_forward_cuda(*k1_args), 20)
    k1_plain_ms = cuda_ms(torch,
                          lambda: kernel.blend_forward_plain(*k1_args), 1)
    # records: only the stream's filled slots are read
    k1_bytes = 4 * (recT.shape[0] * min(demand, cap) + off.numel()
                    + acc.numel() + lk.numel())
    k1_bound_bytes = k1_bytes / HBM_BYTES_PER_S * 1e3
    k1_bound_ops = K1_OPS_PER_PAIR * pairs / F32_OPS_PER_S * 1e3
    emit("k1_time", ms=k1_ms, plain_ms=k1_plain_ms, duplicates=demand,
         evaluated_pairs=pairs, bytes=k1_bytes, bound_ms_bytes=k1_bound_bytes,
         bound_ms_ops=k1_bound_ops)

    # ---- 5b. the slice at full width: frame time and stages
    def frame():
        return renderer.render(cam, state, bg, duplicate_capacity=cap,
                               device="cuda")
    for _ in range(3):
        frame()
    times = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    frame_ms = statistics.median(times)

    def preprocess():
        c = renderer.surfel_colors(state, cam, 3)
        g = (state.params.xyz, state.get_scaling(), state.get_rotation(),
             state.get_opacity()[:, 0])
        return preprocess_surfels(*g, c, cam.w2c, cam.K, settings)

    def assembly():
        out = rasterize_stream(recT, sur.radius, settings, binning, bg=bg)
        return renderer.finalize_render(out, cam)

    stage = dict(
        preprocess=cuda_ms(torch, preprocess, 10),
        binning=cuda_ms(torch, lambda: tiles.bin_surfels_stream(
            *bin_args, cap, cull=sur.cull), 10),
        k3=k3_ms,
        gather=cuda_ms(torch, lambda: _gather_records(
            kernel.pack_geometry_T(sur, N_SURFELS), binning.sorted_surfel),
            10),
        k1=k1_ms,
        blend_and_assembly=cuda_ms(torch, assembly, 10))
    stages_ms = {
        "preprocess": stage["preprocess"],
        "binning_excl_k3": stage["binning"] - stage["k3"],
        "k3": stage["k3"],
        "record_gather": stage["gather"],
        "k1": stage["k1"],
        "assembly": stage["blend_and_assembly"] - stage["k1"],
    }
    emit("render_time", frame_ms_median=frame_ms, frame_ms_all=times,
         rays_per_s=W * H / (frame_ms / 1e3), stages_ms=stages_ms,
         stages_sum_ms=sum(stages_ms.values()), duplicates=demand,
         evaluated_pairs=pairs,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    emit("profile", **profile_frames(torch, frame, 3))

    # ---- 7. the training slice at full width, the late phase, then the
    # training CLI without and with the late phase
    bg, gt, gt_sem = ground_truth(torch, state, cam, cap)
    k2, train_launches = train_phases(torch, state, cam, cap, bg, gt, gt_sem)
    late = late_phases(torch, state, cam, cap, bg, gt, gt_sem)
    bench_fwd_bwd(torch, state, cam)
    train_scene_synthetic(torch)
    train_scene_synthetic(torch, late=True)

    # ---- 9. the measurement tools
    tools = tool_phases(torch, k2[6]["args"], late["args"], k2[6])

    # ---- 8. kernels; launches are those of the training main path, and
    # of the late path for the gated variants
    k1g, k2g = late["k1"], late["k2"]
    kernels = [
        dict(name="K3 tile expansion", route="cuda",
             source="streetunveiler_torch/ops/rasterizer/csrc/expand.cu",
             replaces="streetunveiler_tpu/ops/rasterizer/tiles.py:160",
             launches=train_launches["expand"], max_abs_err=0.0, ms=k3_ms,
             plain_ms=k3_plain_ms, bound_ms=k3_bound, bound_by="bytes"
             if k3_bytes / HBM_BYTES_PER_S
             >= K3_OPS_PER_SLOT * capp / F32_OPS_PER_S else "operations",
             library_ms=None),
        dict(name="K1 blend forward", route="cuda",
             source="streetunveiler_torch/ops/rasterizer/csrc/blend_fwd.cu",
             replaces="streetunveiler_tpu/ops/rasterizer/kernel.py:217",
             launches=train_launches["blend_fwd"], max_abs_err=k1_err,
             ms=k1_ms, plain_ms=k1_plain_ms,
             bound_ms=max(k1_bound_bytes, k1_bound_ops),
             bound_by="operations" if k1_bound_ops >= k1_bound_bytes
             else "bytes", library_ms=None),
        dict(name="K2 blend backward", route="cuda",
             source="streetunveiler_torch/ops/rasterizer/csrc/blend_bwd.cuh",
             replaces="streetunveiler_tpu/ops/rasterizer/kernel.py:406",
             launches=train_launches["blend_bwd"],
             max_abs_err=max(k2[6]["max_abs_err"], k2[12]["max_abs_err"]),
             ms=k2[6]["ms"], plain_ms=k2[6]["plain_ms"],
             bound_ms=k2[6]["bound_ms"], bound_by=k2[6]["bound_by"],
             library_ms=None),
        dict(name="K1 blend forward, gated chains (G=5, nq=12)",
             route="cuda",
             source="streetunveiler_torch/ops/rasterizer/csrc/blend_fwd.cu",
             replaces="streetunveiler_tpu/ops/rasterizer/kernel.py:332",
             launches=late["launches"]["blend_fwd_gated"],
             max_abs_err=k1g["max_abs_err"], ms=k1g["ms"],
             plain_ms=k1g["plain_ms"], bound_ms=k1g["bound_ms"],
             bound_by=k1g["bound_by"], library_ms=None),
        dict(name="K2 blend backward, gated chains (G=5, nq=12)",
             route="cuda",
             source="streetunveiler_torch/ops/rasterizer/csrc/blend_bwd.cuh",
             replaces="streetunveiler_tpu/ops/rasterizer/kernel.py:518",
             launches=late["launches"]["blend_bwd_gated"],
             max_abs_err=k2g["max_abs_err"], ms=k2g["ms"],
             plain_ms=k2g["plain_ms"], bound_ms=k2g["bound_ms"],
             bound_by=k2g["bound_by"], library_ms=None),
    ]
    # the tools run on no main path: launches 0 there, their own count in
    # tool_launches; ms is T1/T2 full on the photometric stream, T3's
    # thread mode at k 13 and T4's serial mode (every variant and mode in
    # the lines of phase group 9)
    csrc = "streetunveiler_torch/ops/rasterizer/csrc/"
    for key, name, source, replaces in (
            ("T1", "T1 bisect_fwd variants of K1", csrc + "bisect_fwd.cu",
             "tools/bisect_fwd.py:281"),
            ("T2", "T2 bisect_bwd variants of K2", csrc + "bisect_bwd.cu",
             "tools/bisect_bwd.py:199"),
            ("T3", "T3 micro_reduce lane reductions",
             csrc + "micro_reduce.cu", "tools/micro_reduce.py:70"),
            ("T4", "T4 micro_prefix prefix sums", csrc + "micro_prefix.cu",
             "tools/micro_prefix.py:105")):
        r = tools[key]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=train_launches[{"T1": "bisect_fwd", "T2": "bisect_bwd",
                                     "T3": "micro_reduce",
                                     "T4": "micro_prefix"}[key]],
            tool_launches=r["tool_launches"], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r.get("library_ms")))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
