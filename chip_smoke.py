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
  every variant of the bisection kernels T1 (K1's) and T2 (K2's) on
  their first design, at the photometric (nq 6) and late (nq 12, G 5)
  configurations, against its plain version on a dense-occlusion stack,
  ``full`` bit for bit against the production K1/K2 at full width, then
  every variant timed on the main path's streams; the micro-probes T3
  (``micro_reduce``) and T4 (``micro_prefix``, its first design) against
  their plain versions and timed at the TPU tools' sizes;
* the probes (phase group 10): the per-step floors T5 and T6
  (``micro_floor``, every variant and width at the tool's sizes), the
  identity copies T7 and T8 (``probe_compose4``, ``probe_tax``) on the
  street's binning outputs and T9's split-precision contraction
  (``probe_mmt3``) against their plain versions; then the probes' path
  (binning → copy → gather → K1 on the street) with the launch counts
  read around it, the laundered blends bit for bit against the
  unlaundered, and every variant timed;
* the redesign (phase group 11): K1 and K2 (``csrc/blend_fwd_sm90.cuh``,
  ``csrc/blend_bwd_sm90.cuh``) in their six forms (nq 6, nq 12, and G 5
  at nq 12) bit for bit against their first design
  (``csrc/blend_fwd.cuh``, ``csrc/blend_bwd.cuh``, the bisection tools'
  ``full``) on the captured full-width streams, both timed, with bounds,
  registers, resident blocks and evaluated pairs (``k1_redesign``,
  ``k2_redesign``); the street's tile lengths (``tile_lengths``); and the
  kernels' guard against a tile order entry that names no tile
  (``tile_order_guard``);
* the probes' redesign (phase group 12): T3 (``csrc/micro_reduce_sm90.cuh``)
  in its nine (mode, k) and T9 (``csrc/mmt3_sm90.cuh``) bit for bit
  against their first design (``csrc/micro_reduce.cu``, ``csrc/mmt3.cu``),
  within their tolerances of the plain versions, both timed in turns
  beside the library yardsticks and the launch floor
  (``micro_reduce_redesign``, ``mmt3_redesign``);
* K3's device time and T2 on K2's H100 design (phase group 13): K3
  (``csrc/expand_sm90.cuh``: blocks of consecutive surfels, their slot
  range stored through shared memory with coalesced stores) bit for bit against its first design (``csrc/expand.cu``) and its plain
  version at the street's and the overflow capacity, both timed by
  CUDA-graph replays in turns (``k3_device_time`` in section 3,
  ``k3_redesign``); the binning stage split into its parts
  (``binning_split``); T2's variants rebuilt on ``csrc/blend_bwd_sm90.cuh``
  (``csrc/bisect_bwd_sm90*.cu``) against their plain versions on the dense
  stack, ``full`` bit for bit and register for register against the
  production K2 at nq 6, 12 and (12, 5), every variant timed in turns
  beside its first-design counterpart, and gated K2's time split by both
  designs' variants (``bisect_bwd_sm90``);
* T1 on K1's H100 design and T4's redesign (phase group 14): T1's
  variants rebuilt on ``csrc/blend_fwd_sm90.cuh``
  (``csrc/bisect_fwd_sm90*.cu``) against their plain versions on the dense
  stack and at full width, ``full`` bit for bit and register for register
  against the production K1 at nq 6, 12 and (12, 5), every variant of both
  designs timed in turns with both designs' evaluated pairs, and gated
  K1's time split by both designs' variants (``bisect_fwd_sm90``); T4's
  five modes on ``csrc/micro_prefix_sm90.cuh`` against its first design
  (``serial`` and ``warpscan`` bit for bit) and the plain version, both
  designs timed in turns, each tensor-core mode's gap to ``serial``, and
  the serial loop's instruction floor from its SASS
  (``micro_prefix_redesign``);
* T5 and T6 redesigned (phase group 15): the per-step floors on
  ``csrc/micro_floor_sm90.cuh`` (phase A the terms, a warp a step across
  the card; phase B the fold, a warp an output block, longest first,
  no-op steps skipped in bulk) bit for bit against their first design
  (``csrc/micro_floor.cu``'s ``floor_walk``) and within FLOOR_RTOL of
  their plain versions in all six variants and three widths, both designs
  timed in turns, the phases and tile 0's segment timed apart, ptxas
  (no stack frame in the redesign's kernels), the bounds of phase group
  10 and their shares, T6's library composite (``micro_floor_redesign``);
* T7/T8's copy redesigned (phase group 16): what a copy costs in a CUDA
  graph against ``clone``'s memcpy node, split (an empty kernel, the
  first design's body on other grids, the redesign, the launch floor;
  the graph nodes of each, ``identity_gap_split``), the same on the
  probes' own pad, copy and slice (``identity_path``), then
  ``csrc/identity_sm90.cuh`` bit for bit
  against its first design and the input at many lengths, both designs
  and ``clone`` in turns at the probes' sizes, ptxas and the bound
  (``identity_redesign``).

* the render and unveil paths (phase group 17): the render CLI
  (``streetunveiler_torch.cli.render --semantics``) on the late training
  CLI's model dir, its held-out PSNR against the training CLI's
  (``render_cli_synthetic``); the unveil CLI (``cli.unveil
  --semantic_class vehicle --all --inpainter diffuse``,
  ``unveil_cli_synthetic``) and the render CLI again, which must render
  the unveiled round (``render_cli_synthetic_unveiled``); the render
  CLI's view at full width, timed and profiled (``render_full_width``),
  a TSDF fusion of 4 street views at ``mesh_res`` 512 with its stages
  timed apart (``tsdf_full_width``), and the delta re-optimization step
  on the street with its vehicles removed (``reoptimize_full_width``),
  each path's K1/K2/K3 launches read around its own run.
* the data layer (phase group 18): the street scene written as a
  Waymo-layout segment (three front cameras over 50 frames, renders at
  1920x1280 as JPEGs, semantic masks, 150,000 LiDAR rays a frame), read
  back through ``read_waymo_info`` stage by stage on the host clock with
  the card's busy time of the colorization and the voxel downsample
  (``data_segment``, ``data_read``), both held bit for bit against their
  CPU runs and against a second run on the card
  (``data_device_vs_cpu``), then the training CLI on it (``cli.train
  --scene waymo --semantics``, 30 iterations at 1920x1280:
  ``data_train_cli``, its K1/K2/K3 launches in the kernels line's
  ``launches_by_path``).

* the evaluation networks (phase group 19): LPIPS-VGG and the FID
  InceptionV3 (``streetunveiler_torch/evaluation/``) on random-init
  weights written through the port's weight writer, one seeded pair of
  800x600 images on the card against the same modules on the CPU, and
  their time a pair (``eval_networks``);
* the end-to-end run (phase group 20): ``tools/e2e_config2.py`` at
  BASELINE config 2 (100k points, 40 cameras at 800x600, 1200 iterations
  with densification), train → render and mesh → unveil → LPIPS and FID
  through the port's CLIs, its held-out PSNR against the 24.0 gate, each
  stage's time and K1/K2/K3 launches (``e2e_config2``), then one
  training step on its trained state under ``torch.profiler``
  (``e2e_train_step_profile``);
* multi-device training at world size 1 (phase group 21): a one-rank
  NCCL group and a 1×1 mesh; the sharded late step on the street against
  ``train_step`` from the same state, replicated and surfel-sharded
  (``multi_step_vs_train_step``, ``_zero``), the slab split at full width
  into 2 and 4 slabs with slab-local binning and the ``shift_packT``
  records path (``multi_slab_split_2``, ``_4``), both steps timed in
  turns (``multi_step_time``), the dryrun (``multi_dryrun``). An exchange
  between two ranks needs two cards and is checked on gloo on the CPU;
* the record scatter (phase group 22, run after the render phases): the
  kernel of ``_gather_records``' backward on one view of the 1M-surfel
  street at rec 24, bit for bit against its plain version, itself and
  ``index_add_`` under the deterministic mode, timed beside its byte
  bound, the plain version and ``index_add_`` (``record_scatter``, and
  the kernels line's row);
* the binning's conic cull (phase group 23, after the record scatter):
  the kernel ``csrc/cull_sm90.cuh`` against its plain version
  (``tiles.cull_rects_plain``) on the
  1M-surfel street at the benchmark's view sizes, 1920x1280 and 1920x1080:
  the table, ``dup_start``, the ranked table and the whole stream bit for
  bit; then both timed by CUDA-graph replays in turns at 1920x1280 beside
  the byte and operation bound, and the binning whole with each
  (``conic_cull``, and the kernels line's row).

The late full-width checks (gated K1/K2, T1 and T2 of both designs) run
on two late streams: the street state as built (``*_late_full_width``)
and a state trained by the training phases' untimed steps under the
deterministic mode (``trained_state``, ``*_late_trained_full_width``),
both the same in every run. On the 16-step trained state
``c1_split_late_trained_steps16`` splits gated K2's largest per-surfel
``scaling`` error against its tolerance to a duplicate and a pixel, with
a float64 reference of that pair (ROADMAP C.1).

``python3 chip_smoke.py --only c1,paths,data,eval,e2e,multi,scatter,cull``
runs the build, the street scene and those groups alone, or any of them
(a quicker run while working on them).

Each phase prints one JSON line; any failure raises and the script exits
non-zero. The last two lines are the kernels table and
``{"ok": true, "device": {...}}``.

Needs one CUDA device and nvcc (``CUDA_HOME`` or ``/usr/local/cuda``); it
imports nothing of JAX. Without a CUDA device it exits 2 and prints no
result.
"""

import collections
import contextlib
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
# the conic cull's test of one (surfel, rect position) pair, counted from
# csrc/cull_sm90.cuh without its early exits: the tile's bounds 6, the disc
# 11, ρ3d at 9 points 19 each, the 4 edge criticals 6 each, the interior 6
CULL_OPS_PER_PAIR = 218
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


T_START = time.perf_counter()


def emit(phase, **fields):
    """One phase's JSON line, with the seconds since the script started
    (``at_s``)."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": round(time.perf_counter() - T_START, 1)}),
          flush=True)


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


def check_blend(torch, acc, lk, want_acc, want_lk, nq, label, tiles_x,
                n_gates=0, **fields):
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
         worst_pixel=worst_pixel(torch, (acc[..., :ch]
                                         - want_acc[..., :ch]).abs(), same,
                                 tiles_x),
         gated=gated, **fields, within_tolerance=ok)
    if not ok:
        raise AssertionError(f"{label}: K1 disagrees with its plain version")
    return worst


class capture_blend_backward:
    """Within the block, ``kernel.blend_backward`` (what the blend's
    autograd backward calls) records its arguments (``args``, and the
    binning's tile order as ``order``) and, with ``plain``, runs the plain
    version instead of K2 — so one real loss gives K2's exact inputs, and
    the same loss backpropagated through the plain version gives the
    reference gradients."""

    def __init__(self, kernel, plain=False):
        self.kernel, self.plain = kernel, plain
        self.args = self.order = None

    def __enter__(self):
        self.orig = self.kernel.blend_backward
        plain = self.kernel.blend_backward_plain

        def record(*a, tile_order):
            self.args, self.order = a, tile_order
            return plain(*a) if self.plain else self.orig(
                *a, tile_order=tile_order)
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


# the plain versions' count of the pairs the kernels evaluate (their exact
# skips applied); "evaluated" is the first design's, which the bounds'
# ``..._first_design_pairs`` fields count
EVALUATED = "evaluated_skip_rule"


def k1_ops(counts, evaluated=EVALUATED):
    """K1's f32 operations on one call's data (csrc/blend_fwd_sm90.cuh's
    note): the composite of every evaluated pair and a gated chain's
    composite of each pair it kept."""
    return (K1_OPS_PER_PAIR * counts[evaluated]
            + K1_OPS_GATED_KEPT * counts["gated_kept"])


def k2_ops(counts, nq, evaluated=EVALUATED):
    """K2's f32 operations on one call's data (csrc/blend_bwd_sm90.cuh's
    note): the recompute of every evaluated pair, the main chain's scan of
    each pair it kept, a gated chain's scan of each pair it kept, and the
    pair VJP with the 14 sums of each pair some chain kept."""
    return (K2_OPS_EVALUATED * counts[evaluated]
            + (K2_OPS_SCAN + K2_OPS_KEPT_CHANNEL * nq) * counts["kept"]
            + K2_OPS_SCAN * counts["gated_kept"]
            + K2_OPS_VJP * counts["any_kept"])


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over the f32 rate."""
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return max(b_ms, o_ms), "operations" if o_ms >= b_ms else "bytes"


def k1_bytes(a, acc, lk):
    """What K1 reads and writes on the blend arguments ``a``: every record
    row of the stream's filled slots, the offsets, the accumulator and lk
    (the bytes of the k1_vs_plain_gated lines)."""
    recT, off = a[0], a[1]
    return 4 * (recT.shape[0] * int(off[-1]) + off.numel() + acc.numel()
                + lk.numel())


def k2_bytes(kernel, a):
    """What K2 reads (csrc/blend_bwd_sm90.cuh) and writes on the backward
    arguments ``a``: record rows 0..9+nq and the gate row of each filled
    slot; of acc, α and each (α_g, lk_g); of dacc, the payload, α, depth,
    m1 and m2 cotangents and each (α_g, m1_g, m2_g); lk; all of dgrad."""
    recT, off, _, _, _, _, lk, _, nq, n_gates = a
    rec, capp = recT.shape
    pix = lk.numel()
    return 4 * ((kernel.Q_ROW0 + nq + (1 if n_gates else 0)) * int(off[-1])
                + off.numel() + pix * (1 + 2 * n_gates) + pix
                + pix * (nq + 4 + 3 * n_gates) + rec * capp)


def grad_runs(torch, kernel, loss_fn):
    """The per-surfel side of K2's check. ``loss_fn()`` → (loss, grads)
    runs twice through K2 and twice through the plain version
    (``capture_blend_backward``), in the turns K2, plain, K2, plain: first
    as the paths run it, then under ``torch.use_deterministic_algorithms(
    True, warn_only=True)`` (the previous setting restored after). Reports
    per mode each side's run-to-run spread per parameter, whether K2's
    inputs (the captured blend-backward tensors) were bit equal between
    its two runs, and the operations that warned of having no
    deterministic form. The record scatter (``ops/rasterizer/scatter.py``)
    sums each surfel's duplicates in stream order, without atomics, in
    either mode, so its part of the spread is 0 in both (autograd's
    ``index_add_``, which it replaced, moved the default runs by atomics).
    The comparison takes the deterministic mode's first run of each side,
    so that the two sides differ by the blend backward alone.
    ``k2_inputs_sum`` tells calls apart whose K2 inputs differ. Returns
    (args, loss, g_k2, g_plain, report)."""
    import warnings

    def side(plain):
        with capture_blend_backward(kernel, plain=plain) as cb:
            loss, g = loss_fn()
        return loss, g, tuple(t.detach() if torch.is_tensor(t) else t
                              for t in cb.args)

    def spread(ga, gb):
        return {n: float((ga[n] - gb[n]).abs().max()) for n in ga}

    report = {}
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    try:
        for mode in ("default", "deterministic"):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if mode == "deterministic":
                    torch.use_deterministic_algorithms(True, warn_only=True)
                loss, k_1, a_1 = side(False)
                _, p_1, _ = side(True)
                _, k_2, a_2 = side(False)
                _, p_2, _ = side(True)
                torch.cuda.synchronize()
            report[mode] = dict(
                run_to_run_max_abs=dict(k2=spread(k_1, k_2),
                                        plain=spread(p_1, p_2)),
                k2_minus_plain_max_abs=spread(k_1, p_1),
                k2_inputs_bit_equal=all(
                    torch.equal(x, y) for x, y in zip(a_1, a_2)
                    if torch.is_tensor(x)),
                # K2's inputs, summed in f64: equal between calls only if
                # the state reaching this check is
                k2_inputs_sum=dict(records=float(a_1[0].double().sum()),
                                   cotangents=float(a_1[7].double().sum())),
                nondeterministic_ops=sorted({
                    str(w.message).splitlines()[0][:200] for w in caught
                    if "deterministic" in str(w.message)}))
            del k_2, p_2, a_2
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
    return a_1, loss, k_1, p_1, report


def check_k2(torch, kernel, a, g_k2, g_plain, label, reps=20, **fields):
    """K2 against its plain version on the captured arguments ``a`` of a
    real loss's backward: per record row (and K2 run twice, bit for bit),
    then per surfel (the loss's gradients through K2 against those through
    the plain version, after the record scatter: ``grad_runs``'
    deterministic ones). Times both and bounds K2 on these inputs."""
    from streetunveiler_torch.ops.rasterizer import tiles
    recT, off, _, _, _, _, lk, _, nq, n_gates = a
    order = tiles.tile_order(off)   # the binning's work, outside the time
    got = kernel.blend_backward_cuda(*a, tile_order=order)
    k2_repeat_equal = torch.equal(
        got, kernel.blend_backward_cuda(*a, tile_order=order))
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
    ms = cuda_ms(torch, lambda: kernel.blend_backward_cuda(
        *a, tile_order=order), reps)
    plain_ms = cuda_ms(torch, lambda: kernel.blend_backward_plain(*a), 1)
    rec = recT.shape[0]
    filled = int(off[-1])
    nbytes = k2_bytes(kernel, a)
    ops = k2_ops(counts, nq)
    bound_ms, bound_by = bound(nbytes, ops)
    first_bound = bound(nbytes, k2_ops(counts, nq, "evaluated"))[0]
    ok = (rows_ok and k2_repeat_equal and bool(torch.isfinite(got).all())
          and all(v["within_tolerance"] and v["finite"]
                  for v in surfel.values()))
    emit(label, nq=nq, n_gates=n_gates, record_rows=rec,
         row_max_abs_err_rel=row_err, row_tolerance_rel=ROW_TOL_REL,
         k2_bit_equal_run_to_run=k2_repeat_equal,
         per_surfel=surfel, grad_tolerance=dict(atol_rel=GRAD_ATOL_REL,
                                                rtol=GRAD_RTOL),
         evaluated_pairs=counts[EVALUATED],
         evaluated_pairs_first_design=counts["evaluated"],
         kept_pairs=counts["kept"], gated_kept_pairs=counts["gated_kept"],
         vjp_pairs=counts["any_kept"], duplicates=filled, ms=ms,
         plain_ms=plain_ms, bytes=nbytes, operations=ops,
         bound_ms_bytes=nbytes / HBM_BYTES_PER_S * 1e3,
         bound_ms_ops=ops / F32_OPS_PER_S * 1e3,
         bound_ms_first_design_pairs=first_bound, **fields,
         within_tolerance=ok)
    if not ok:
        raise AssertionError(f"{label}: K2 disagrees with its plain version")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_ms_first_design_pairs=first_bound,
                counts=counts, max_abs_err=float((got - want).abs().max()))


def k2_vs_plain(torch, kernel, state, cam, gt, gt_sem, bg, cap, opt, nq):
    """K2 against its plain version on the inputs of the step's real loss
    (every stage-1 loss term on), at full width: per record row, then per
    surfel after the record scatter."""
    sem = gt_sem if nq == 12 else None

    def loss_fn():
        loss, g, _ = loss_grads(torch, state, cam, gt, bg, opt, TRAIN_ITER0,
                                cap, sem)
        return loss, g
    a, loss, g_k2, g_plain, runs = grad_runs(torch, kernel, loss_fn)
    if a[8] != nq:
        raise AssertionError(f"the loss ran the blend at nq={a[8]}, "
                             f"not {nq}")
    return dict(check_k2(torch, kernel, a, g_k2, g_plain,
                         f"k2_vs_plain_nq{nq}", loss=float(loss),
                         surfel_grad_runs=runs), args=a)


def gated_vs_plain(torch, kernel, loss_fn, case, save_failed=False):
    """Gated K1 and K2 against their plain versions on one loss's blend:
    ``loss_fn()`` → (loss, grads) runs the loss and its gradients, its
    backward through K2 and through the plain version (``grad_runs``). K1's
    inputs are the forward's records (the captured arguments). With
    ``save_failed``, a failed check first saves the stream
    (``save_stream``)."""
    from streetunveiler_torch.ops.rasterizer import tiles
    # the captured records, detached: the plain versions below build no
    # graph
    a, loss, g_k2, g_plain, runs = grad_runs(torch, kernel, loss_fn)
    recT, off, tx, ty, settings, _, _, _, nq, n_gates = a
    k1_args = (recT, off, tx, ty, settings, nq, n_gates)
    order = tiles.tile_order(off)   # the binning's work, outside the time
    acc, lk = kernel.blend_forward_cuda(*k1_args, tile_order=order)
    want_acc, want_lk, counts = kernel.blend_forward_plain(
        *k1_args, count_pairs=True)
    # the pairs the ungated blend of the same records evaluates
    main_evaluated = kernel.blend_forward_plain(
        *k1_args[:6], count_pairs=True)[2]["evaluated"]
    torch.cuda.synchronize()
    ms = cuda_ms(torch, lambda: kernel.blend_forward_cuda(
        *k1_args, tile_order=order), 10)
    plain_ms = cuda_ms(torch, lambda: kernel.blend_forward_plain(*k1_args),
                       1)
    nbytes = k1_bytes(a, acc, lk)
    ops = k1_ops(counts)
    k1_bound, k1_by = bound(nbytes, ops)
    first_bound = bound(nbytes, k1_ops(counts, "evaluated"))[0]
    try:
        k1_err = check_blend(
            torch, acc, lk, want_acc, want_lk, nq,
            f"k1_vs_plain_gated_{case}", tx, n_gates,
            evaluated_pairs=counts[EVALUATED],
            evaluated_pairs_first_design=counts["evaluated"],
            ungated_evaluated_pairs=main_evaluated,
            kept_pairs=counts["kept"], gated_kept_pairs=counts["gated_kept"],
            duplicates=int(off[-1]), ms=ms, plain_ms=plain_ms, bytes=nbytes,
            operations=ops, bound_ms=k1_bound,
            bound_ms_first_design_pairs=first_bound)
        k2 = check_k2(torch, kernel, a, g_k2, g_plain,
                      f"k2_vs_plain_gated_{case}", reps=10, loss=float(loss),
                      surfel_grad_runs=runs)
    except AssertionError:
        if save_failed:
            emit(f"gated_{case}_stream", saved=save_stream(
                torch, f"gated_{case}", a))
        raise
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=k1_bound, bound_by=k1_by,
                bound_ms_first_design_pairs=first_bound,
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


def state_copy(state):
    """``state`` with copies of its parameters, which ``train_step``
    updates in place."""
    import dataclasses
    p = state.params
    return dataclasses.replace(state, params=dataclasses.replace(p, **{
        f.name: getattr(p, f.name).clone() for f in dataclasses.fields(p)}))


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
    from streetunveiler_torch.ops.rasterizer import kernel, scatter
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
    drecT = kernel.blend_backward_cuda(*a, tile_order=b.tile_order)
    idx = b.sorted_surfel
    n_cols = state.capacity + 1

    def record_scatter():
        # what _gather_records' backward runs: the sort and the kernel
        return scatter.record_scatter(drecT, idx, n_cols)

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
        k1=cuda_ms(torch, lambda: kernel.blend_forward_cuda(
            *k1_args, tile_order=b.tile_order), 10),
        losses_fwd_bwd=cuda_ms(torch, losses_fwd_bwd, 10),
        k2=cuda_ms(torch, lambda: kernel.blend_backward_cuda(
            *a, tile_order=b.tile_order), 10),
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


def untimed_steps(torch, state, cam, cap, bg, gt, gt_sem, opt,
                  steps=TRAIN_STEPS + 1):
    """The full-width training steps before ``train_phases``' timed ones:
    ``steps`` (TRAIN_STEPS + 1) steps from TRAIN_ITER0, the first one
    semantic (nq=12), with the schedule's loss, real Adam updates and
    densification statistics. ``train_step`` updates ``state``'s
    parameters in place. Returns (state, opt_state, losses, overflow)."""
    from streetunveiler_torch.train.step import (bin_step, init_optimizer,
                                                 train_step)
    opt_state = init_optimizer(state)
    losses, overflow = [], False
    for i in range(steps):
        b = bin_step(state, cam, duplicate_capacity=cap, device="cuda")
        state, opt_state, _, _, m = train_step(
            state, opt_state, cam, gt, bg, TRAIN_ITER0 + i, opt,
            duplicate_capacity=cap, binning=b,
            gt_semantic=gt_sem if i == 0 else None, device="cuda")
        losses.append(float(m["loss"]))
        overflow = overflow or bool(m["overflow"])
    return state, opt_state, losses, overflow


def densify_full_capacity(torch, state, opt_state, opt):
    """densify_and_prune at full capacity with a seeded generator, the
    gradient threshold at the 90th percentile of the nonzero accumulated
    screen gradients, so that thousands of surfels want to clone or split:
    nothing can be placed, so no split parent may be pruned. Returns
    (state, opt_state, threshold, surfels at or above it)."""
    from streetunveiler_torch.models.gaussians import densify_and_prune
    grads = state.grad_accum / state.denom.clamp(min=1)
    threshold = float(torch.quantile(grads[grads > 0], 0.9))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    d_state, mu, nu = densify_and_prune(
        state, opt_state.mu, opt_state.nu, threshold, opt.opacity_cull,
        None, generator=gen, percent_dense=opt.percent_dense)
    return (d_state, opt_state._replace(mu=mu, nu=nu), threshold,
            int((grads >= threshold).sum()))


# The deterministically trained states of the late checks: name → training
# steps. "" is the training phases' own schedule, checked in full; the
# others show the margin on other trained states, with fewer T1/T2
# variants (late_trained_check). Another densify seed gives no other
# state: at full capacity densify places nothing, and its generator draws
# nothing
TRAINED_STATES = {"": TRAIN_STEPS + 1, "steps16": 16, "steps11": 11}


def deterministic_trained_state(torch, state, cam, cap, bg, gt, gt_sem,
                                name=""):
    """A trained state that repeats from run to run, for the late checks:
    ``untimed_steps`` and ``densify_full_capacity`` on a ``state_copy`` of
    ``state`` with the steps of TRAINED_STATES[name], all
    under ``torch.use_deterministic_algorithms(True, warn_only=True)`` (the
    previous setting restored after). The record scatter sums each
    surfel's duplicates in a fixed order in either mode (autograd's
    ``index_add_``, which it replaced, added them by atomics outside this
    mode); the mode stays for any other operation of the step that has a
    nondeterministic default. The timed phases keep the default mode. Emits
    ``trained_state[_name]`` (each step's loss, the operations that warned
    of having no deterministic form, an f64 sum of each parameter) and
    returns the state."""
    import dataclasses
    import warnings
    from streetunveiler_torch.config import OptimizationParams
    opt = OptimizationParams()
    steps = TRAINED_STATES[name]
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    t_start = time.perf_counter()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            trained, opt_state, losses, overflow = untimed_steps(
                torch, state_copy(state), cam, cap, bg, gt, gt_sem, opt,
                steps)
            trained, opt_state, threshold, high = densify_full_capacity(
                torch, trained, opt_state, opt)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
    finite = finite_state(torch, trained, opt_state)
    alive = int(trained.num_alive)
    emit("trained_state" + (f"_{name}" if name else ""), steps=steps,
         iteration0=TRAIN_ITER0, first_step_nq=12,
         losses=losses, overflow=overflow, finite=finite,
         grad_threshold=threshold, high_gradient=high, alive=alive,
         param_sums={f.name: float(getattr(trained.params, f.name).double()
                                   .sum())
                     for f in dataclasses.fields(trained.params)},
         nondeterministic_ops=sorted({
             str(w.message).splitlines()[0][:200] for w in caught
             if "deterministic" in str(w.message)}),
         seconds=time.perf_counter() - t_start)
    if not (finite and not overflow and alive == trained.capacity):
        raise AssertionError("the deterministic training steps went "
                             "non-finite, overflowed or changed the surfel "
                             "count")
    return trained


def train_phases(torch, state, cam, cap, bg, gt, gt_sem):
    """The training slice at full width; returns what the kernels line
    needs of it."""
    from streetunveiler_torch.config import OptimizationParams
    from streetunveiler_torch import trace
    from streetunveiler_torch.ops.rasterizer import kernel
    from streetunveiler_torch.train.step import bin_step, train_step

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
    trace.reset_launch_counts()
    state, opt_state, losses, overflow = untimed_steps(
        torch, state, cam, cap, bg, gt, gt_sem, opt)
    torch.cuda.synchronize()
    launches = dict(trace.launch_counts)
    steps = TRAIN_STEPS + 1
    finite = finite_state(torch, state, opt_state)
    tracked = int((state.denom > 0).sum())
    falls = losses[-1] < losses[1]
    ok = (finite and falls and not overflow and tracked > 0
          and all(launches[k] >= steps
                  for k in ("expand", "blend_fwd", "blend_bwd",
                            "record_scatter", "cull")))
    emit("train_main_path", steps=steps, first_step_nq=12, iteration0=
         TRAIN_ITER0, losses=losses, loss_falls=falls, overflow=overflow,
         launches=launches, finite=finite, surfels_with_stats=tracked,
         semantic_step_loss=losses[0])
    if not ok:
        raise AssertionError("the full-width training steps failed their "
                             "checks")

    n_alive = int(state.num_alive)
    d_state, d_opt, threshold, high = densify_full_capacity(
        torch, state, opt_state, opt)
    d_ok = (int(d_state.num_alive) == n_alive == state.capacity
            and high > 0 and finite_state(torch, d_state, d_opt))
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


def late_phases(torch, state, cam, cap, bg, gt, gt_sem, trained):
    """The late-phase step at full width on ``state`` (the street state as
    built, the same in every run): gated K1/K2 against their plain
    versions (the late loss on ``state``, on each of ``trained``, the
    deterministically trained states by name, and on a dense-occlusion
    stack), then TRAIN_STEPS + 1 late steps with the sky, their time by
    stage and their profile. Returns what the kernels line needs of it,
    with the captured late streams of ``state`` (``args``) and of each
    trained state (``trained_args``, by name)."""
    from streetunveiler_torch.config import OptimizationParams
    from streetunveiler_torch.models.sky import init_sky
    from streetunveiler_torch import trace
    from streetunveiler_torch.ops.rasterizer import (RasterizeSettings,
                                                     kernel, rasterize)
    from streetunveiler_torch.train.step import (bin_step, init_optimizer,
                                                 train_step)
    opt = OptimizationParams()
    sky = init_sky(torch.Generator().manual_seed(0), device="cuda")

    # ---- gated K1 and K2 against their plain versions
    def late_loss(st):
        def loss_fn():
            loss, g, _ = loss_grads(torch, st, cam, gt, bg, opt, LATE_ITER0,
                                    cap, gt_sem, True, sky)
            return loss, g
        return loss_fn
    k1_full, k2_full, a = gated_vs_plain(torch, kernel, late_loss(state),
                                         "full_width")
    k1_tr, k2_tr, a_tr = {}, {}, {}
    for name, st in trained.items():
        k1_tr[name], k2_tr[name], a_tr[name] = gated_vs_plain(
            torch, kernel, late_loss(st),
            "late_trained" + (f"_{name}" if name else "") + "_full_width",
            save_failed=True)
    # C.1: the 16-step state's gated K2 scaling error, split to a pair
    c1 = None
    if C1_STATE in trained:
        c1 = c1_split(torch, kernel, trained[C1_STATE], cam, gt, bg, gt_sem,
                      sky, opt, cap, f"c1_split_late_trained_{C1_STATE}")
    for x in (a, *a_tr.values()):
        if (x[8], x[9]) != (12, G_LATE):
            raise AssertionError(f"the late loss ran the blend at "
                                 f"nq={x[8]}, G={x[9]}")
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
    trace.reset_launch_counts()
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
    launches = dict(trace.launch_counts)
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
    return dict(k1=dict(k1_full, max_abs_err=max(
                    k1_full["max_abs_err"], k1_dense["max_abs_err"],
                    *(k["max_abs_err"] for k in k1_tr.values()))),
                k2=dict(k2_full, max_abs_err=max(
                    k2_full["max_abs_err"], k2_dense["max_abs_err"],
                    *(k["max_abs_err"] for k in k2_tr.values()))),
                launches=launches, args=a, trained_args=a_tr, c1=c1)


# ---- C.1 split: gated K2's per-surfel scaling error on the 16-step state
C1_STATE = "steps16"
# margins (relative) below which a pair counts as sitting at a gate: a few
# hundred f32 ulps, what K2's recompute and the plain version's pair math
# can round apart
C1_EDGE_MARGIN = 1e-5
# K2's assembly of record rows 0-5 from the cross products' gradients
# (csrc/blend_bwd_sm90.cuh, d1x .. d3y): each row's f32 terms, as
# (sign, factor, factor) over r1..r3 and gA, gB, gC (ddet·A for d3x/d3y)
C1_ROW_TERMS = {
    0: ((1, "r2y", "gaz"), (-1, "r2z", "gay"), (1, "gcy", "r3z"),
        (-1, "gcz", "r3y")),
    1: ((1, "gay", "r1z"), (-1, "gaz", "r1y"), (1, "r3y", "gbz"),
        (-1, "r3z", "gby")),
    2: ((1, "ddet", "ax"), (1, "gby", "r2z"), (-1, "gbz", "r2y"),
        (1, "r1y", "gcz"), (-1, "r1z", "gcy")),
    3: ((1, "r2z", "gax"), (-1, "r2x", "gaz"), (1, "gcz", "r3x"),
        (-1, "gcx", "r3z")),
    4: ((1, "gaz", "r1x"), (-1, "gax", "r1z"), (1, "r3z", "gbx"),
        (-1, "r3x", "gbz")),
    5: ((1, "ddet", "ay"), (1, "gbz", "r2x"), (-1, "gbx", "r2z"),
        (1, "r1z", "gcx"), (-1, "r1x", "gcz")),
}


def c1_row_terms(geo, d_alpha, d_t, alpha, px, py):
    """K2's terms of record rows 0-5 for one pair in float64: ``geo`` the
    record's rows 0-9, ``d_alpha`` and ``d_t`` the pair's α and depth
    cotangents, ``alpha`` its α (unclamped, ρ from the plane). The chain
    is K2's own: dρ = dα·(−α/2), dk from ρ = |k_xy|²/k_z² and
    t = det/k_z, dA = dk + ddet·r3, dB = px·dk, dC = py·dk. Returns
    {row: [terms]}."""
    r1x, r2x, r3x, r1y, r2y, r3y, c2dx, c2dy, z = (float(v) for v in geo[:9])
    r1z, r2z, r3z = c2dx * z, c2dy * z, z
    ax, ay, az = (r1y * r2z - r1z * r2y, r1z * r2x - r1x * r2z,
                  r1x * r2y - r1y * r2x)
    b = (r2y * r3z - r2z * r3y, r2z * r3x - r2x * r3z, r2x * r3y - r2y * r3x)
    c = (r3y * r1z - r3z * r1y, r3z * r1x - r3x * r1z, r3x * r1y - r3y * r1x)
    det = r3x * ax + r3y * ay + r3z * az
    kx, ky, kz = (ax + px * b[0] + py * c[0], ay + px * b[1] + py * c[1],
                  az + px * b[2] + py * c[2])
    rcp = 1.0 / kz
    d_rho = d_alpha * (-0.5 * alpha)
    dk = (d_rho * 2 * kx * rcp ** 2, d_rho * 2 * ky * rcp ** 2,
          -2 * d_rho * (kx * kx + ky * ky) * rcp ** 3
          - d_t * det * rcp ** 2)
    ddet = d_t * rcp
    v = dict(r1x=r1x, r2x=r2x, r3x=r3x, r1y=r1y, r2y=r2y, r3y=r3y, r1z=r1z,
             r2z=r2z, r3z=r3z, ax=ax, ay=ay, ddet=ddet,
             gax=dk[0] + ddet * r3x, gay=dk[1] + ddet * r3y,
             gaz=dk[2] + ddet * r3z, gbx=px * dk[0], gby=px * dk[1],
             gbz=px * dk[2], gcx=py * dk[0], gcy=py * dk[1], gcz=py * dk[2])
    return {row: [sg * v[f] * v[g] for sg, f, g in terms]
            for row, terms in C1_ROW_TERMS.items()}


def c1_split(torch, kernel, state, cam, gt, bg, gt_sem, sky, opt, cap,
             label):
    """Split gated K2's per-surfel ``scaling`` error on ``state``'s late
    loss down to a surfel, a duplicate and a pixel (a pair).

    The gradients of the late loss run through K2 and through the plain
    version under the deterministic mode (the record scatter sums in a
    fixed order in either mode; the mode fixes any other operation, so that
    the two sides differ by the blend backward alone). The
    surfel and axis whose error is largest against the check's tolerance
    (atol GRAD_ATOL_REL·max|g| + rtol GRAD_RTOL·|g|) is split: the record
    gradient of each of its duplicates through the surfel's own Jacobian
    d(record rows 0-9)/d(scaling) (its preprocess alone, on the card), and
    for its worst duplicate each pixel of the tile, by running K2 and the
    plain version on the one-tile stream with the cotangent of that pixel
    alone (both are linear in the cotangent). Each pair reports its raw α
    against the α gate (1/255) and the clamp (0.99), the nearest α gate
    over the pixel's chain up to its last kept pair, and the nearest
    transmittance to t_eps; a margin below C1_EDGE_MARGIN is a knife
    edge."""
    from streetunveiler_torch import renderer
    from streetunveiler_torch.ops.rasterizer.blendmath import (
        map_depth, pair_alpha_depth)
    from streetunveiler_torch.ops.rasterizer.kernel import (PIX, Q_ROW0,
                                                            TILE_H, TILE_W,
                                                            ch_for,
                                                            gate_bits)
    from streetunveiler_torch.ops.rasterizer.preprocess import \
        preprocess_surfels
    from streetunveiler_torch.ops.rasterizer.types import (ALPHA_EPS,
                                                           ALPHA_MAX)
    from streetunveiler_torch.ops.rasterizer import tiles

    def loss_fn():
        loss, g, _ = loss_grads(torch, state, cam, gt, bg, opt, LATE_ITER0,
                                cap, gt_sem, True, sky)
        return loss, g
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        with capture_blend_backward(kernel) as cb:
            _, gk = loss_fn()
        with capture_blend_backward(kernel, plain=True):
            _, gp = loss_fn()
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
    a = tuple(t.detach() if torch.is_tensor(t) else t for t in cb.args)
    recT, off, tx, ty, settings, acc, lk, dacc, nq, n_gates = a
    gk, gp = gk["scaling"], gp["scaling"]
    err = (gk - gp).abs()
    tol = GRAD_ATOL_REL * float(gp.abs().max()) + GRAD_RTOL * gp.abs()
    ratio = err / tol
    flat = int(ratio.reshape(-1).argmax())
    s, ax = divmod(flat, gk.shape[1])
    worst_abs = int(err.reshape(-1).argmax())

    # the surfel's duplicates in the stream (the loss's own binning)
    b = renderer.bin_camera(cam, state, duplicate_capacity=cap)
    filled = int(off[-1])
    dups = (b.sorted_surfel[:filled] == s).nonzero()[:, 0]
    dup_tiles = torch.searchsorted(off.long(), dups, right=True) - 1

    # d(record rows 0-9 of surfel s)/d(scaling[s]): its preprocess alone
    sl = slice(s, s + 1)
    with torch.no_grad():
        rot = state.get_rotation()[sl]
        opac = state.get_opacity()[sl, 0]

    def rec_of(scal):
        sur = preprocess_surfels(state.params.xyz[sl].detach(),
                                 torch.exp(scal), rot, opac,
                                 torch.zeros((1, 3), device="cuda"),
                                 cam.w2c, cam.K, settings)
        return kernel.pack_geometry_T(sur, 1, pad_column=False)[:Q_ROW0, 0]
    scal = state.params.scaling[sl].detach()
    rec_equal = bool(len(dups)) and torch.equal(rec_of(scal),
                                                recT[:Q_ROW0, dups[0]])
    jac = torch.autograd.functional.jacobian(rec_of, scal)[:, 0, ax]

    def contrib(dgrad, cols):
        return (jac.double()[:, None]
                * dgrad[:Q_ROW0, cols].double()).sum(dim=0)
    order = tiles.tile_order(off)
    dg_k2 = kernel.blend_backward_cuda(*a, tile_order=order)
    dg_plain = kernel.blend_backward_plain(*a)
    torch.cuda.synchronize()
    ck, cp = contrib(dg_k2, dups), contrib(dg_plain, dups)
    per_dup = [dict(duplicate=int(d), tile=int(t), k2=float(x),
                    plain=float(y), diff=float(x - y))
               for d, t, x, y in zip(dups.tolist(), dup_tiles.tolist(),
                                     ck, cp)]
    i_w = int((ck - cp).abs().argmax()) if len(dups) else -1
    d_w, t_w = (int(dups[i_w]), int(dup_tiles[i_w])) if len(dups) else (0, 0)

    # the one-tile stream of the worst duplicate's tile
    n_tiles = tx * ty
    lo, hi = int(off[t_w]), int(off[t_w + 1])
    off1 = torch.where(torch.arange(n_tiles + 1, device="cuda") <= t_w,
                       torch.full_like(off, lo), torch.full_like(off, hi))
    other = torch.arange(n_tiles, device="cuda") != t_w
    lk1 = torch.where(other[:, None, None], torch.full_like(lk, -1), lk)
    acc1 = acc.clone()
    ch = ch_for(nq)
    for g in range(n_gates):
        acc1[other, :, ch + 4 * g + 3] = -1.0
    a1 = (recT, off1, tx, ty, settings, acc1, lk1)

    def one_tile(dacc1, plain):
        if plain:
            return kernel.blend_backward_plain(*a1, dacc1, nq, n_gates)
        return kernel.blend_backward_cuda(*a1, dacc1, nq, n_gates,
                                          tile_order=order)
    dacc_t = torch.zeros_like(dacc)
    dacc_t[t_w] = dacc[t_w]
    tile_equal = torch.equal(one_tile(dacc_t, False)[:, d_w],
                             dg_k2[:, d_w])

    # every pair of the tile: raw α (before the gate and the clamp), the
    # chains' transmittance, per pixel
    sub = torch.arange(PIX, device="cuda")
    px = (t_w % tx) * TILE_W + (sub % TILE_W).float() + 0.5
    py = (t_w // tx) * TILE_H + (sub // TILE_W).float() + 0.5
    geo = recT[:Q_ROW0, lo:hi]
    c2dx, c2dy, z = geo[6], geo[7], geo[8]
    m_rows = (geo[0], geo[3], c2dx * z, geo[1], geo[4], c2dy * z, geo[2],
              geo[5], z)
    seen = {}

    def exp_seen(x):
        seen["g"] = torch.exp(x)
        return seen["g"]
    alpha, _ = pair_alpha_depth(m_rows, (c2dx, c2dy), z, geo[9],
                                geo[9] > 0, px, py, settings.znear,
                                exp=exp_seen)                  # [S, PIX]
    raw = geo[9][:, None] * seen["g"]
    idx = torch.arange(lo, hi, device="cuda")[:, None]
    lk_t = lk[t_w, :, 0].long()
    gate_margin = (raw / ALPHA_EPS - 1.0).abs()
    clamp_margin = (raw / ALPHA_MAX - 1.0).abs()
    chains = [(alpha, lk_t)]
    bits = None
    if n_gates:
        bits = gate_bits(recT[Q_ROW0 + nq, lo:hi], n_gates)
        chains += [(torch.where(bits[g][:, None], alpha,
                                torch.zeros_like(alpha)),
                    acc[t_w, :, ch + 4 * g + 3].long())
                   for g in range(n_gates)]
    top = torch.stack([c[1] for c in chains]).amax(dim=0)
    in_chain = idx <= top[None]
    big = torch.full_like(raw, float("inf"))
    chain_gate_margin = torch.where(in_chain, gate_margin, big).amin(dim=0)
    t_margin = torch.full((PIX,), float("inf"), device="cuda")
    for al, lkc in chains:
        live = (al > 0) & (idx <= lkc[None] + 1)
        t_after = torch.cumprod(torch.where(live, 1.0 - al,
                                            torch.ones_like(al)), dim=0)
        m = torch.where(live, (t_after / settings.t_eps - 1.0).abs(), big)
        t_margin = torch.minimum(t_margin, m.amin(dim=0))

    j = d_w - lo
    lk_g = [acc[t_w, :, ch + 4 * g + 3].long() for g in range(n_gates)]
    znear, zfar = settings.znear, settings.zfar

    def pixel_f64(p):
        """Pixel p's gradient of the record's geometry rows 0-9 in float64:
        its blend forward (the main chain and the gated ones, kept pairs
        up to lk and lk_g as the kernels keep them) written out, the
        captured cotangent of its accumulator channels, autograd."""
        g64 = recT[:, lo:hi].double()
        geo = g64[:Q_ROW0].clone().requires_grad_(True)
        gx, gy, gz = geo[6], geo[7], geo[8]
        rows64 = (geo[0], geo[3], gx * gz, geo[1], geo[4], gy * gz, geo[2],
                  geo[5], gz)
        al, tt = pair_alpha_depth(rows64, (gx, gy), gz, geo[9], geo[9] > 0,
                                  px[p:p + 1].double(),
                                  py[p:p + 1].double(), znear)
        al, tt = al[:, 0], tt[:, 0]
        al.retain_grad()
        mm = map_depth(tt, znear, zfar)
        d = dacc[t_w, p].double()
        pos = idx[:, 0]
        parts = []

        def weights(a_c, lkc):
            keep = (a_c > 0) & (pos <= lkc)
            one = torch.where(keep, 1.0 - a_c, torch.ones_like(a_c))
            excl = torch.cat([torch.ones_like(one[:1]),
                              torch.cumprod(one, 0)[:-1]])
            w_c = torch.where(keep, a_c * excl, torch.zeros_like(a_c))
            w_c.retain_grad()
            parts.append((w_c, excl.detach()))
            return w_c
        w = weights(al, lk_t[p])
        loss = ((d[:nq] * (g64[Q_ROW0:Q_ROW0 + nq] * w).sum(1)).sum()
                + d[nq] * w.sum() + d[nq + 1] * (w * tt).sum()
                + d[nq + 3] * (w * mm).sum() + d[nq + 4] * (w * mm * mm).sum())
        for g in range(n_gates):
            wg = weights(torch.where(bits[g], al, torch.zeros_like(al)),
                         lk_g[g][p])
            loss = loss + (d[ch + 4 * g] * wg.sum()
                           + d[ch + 4 * g + 1] * (wg * mm).sum()
                           + d[ch + 4 * g + 2] * (wg * mm * mm).sum())
        tt.retain_grad()
        loss.backward()
        # dα of the pair, and its direct part Σ_chains T_excl·Ω (Ω the
        # pair's weight cotangent): their ratio is dα's cancellation
        direct = sum(abs(float(w_c.grad[j] * ex[j])) for w_c, ex in parts)
        # the chain's pairs in f32 (the kernels' precision) against f64:
        # an ill-conditioned pair (a surfel seen edge-on) moves far
        live = (pos <= top[p]) & (al.detach() > 0)
        dev = torch.where(live, (alpha[:, p].double() - al.detach()).abs()
                          / al.detach().clamp(min=1e-30),
                          torch.zeros_like(al.detach()))
        worst = int(dev.argmax())
        return geo.grad[:, j], float(al.grad[j]), float(tt.grad[j]), \
            float(al.detach()[j]), direct, dict(
                pair=worst, is_this_pair=worst == j, rel=float(dev[worst]),
                alpha_f64=float(al.detach()[worst]),
                alpha_f32=float(alpha[worst, p]))

    pixels = ((raw[j] >= 0.5 * ALPHA_EPS)
              | (chain_gate_margin < C1_EDGE_MARGIN)).nonzero()[:, 0]
    rows = []
    jac64 = jac.double()
    for p in pixels.tolist():
        dp = torch.zeros_like(dacc)
        dp[t_w, p] = dacc[t_w, p]
        rk = one_tile(dp, False)[:Q_ROW0, d_w].double()
        rp = one_tile(dp, True)[:Q_ROW0, d_w].double()
        r64, d_alpha, d_t, alpha64, d_alpha_direct, chain_dev = pixel_f64(p)
        k, q = float((jac64 * rk).sum()), float((jac64 * rp).sum())
        ref = float((jac64 * r64).sum())
        terms = float((jac64 * r64).abs().sum())
        # K2's assembly of rows 0-5 from the pair's f64 cotangents: the
        # terms must sum to the f64 rows (the chain is K2's), and each
        # row's K2 − plain difference is held against the f32 rounding
        # bound of that assembly, 2·(n + 2)·2⁻²⁴·Σ|terms| (n products,
        # their inputs and the sum rounded in either order)
        row_terms = c1_row_terms(recT[:Q_ROW0, d_w].double().tolist(),
                                 d_alpha, d_t, alpha64, float(px[p]),
                                 float(py[p]))
        assembly = {}
        for row, tv in row_terms.items():
            abs_sum = sum(abs(x) for x in tv)
            diff_r = float(rk[row] - rp[row])
            assembly[row] = dict(
                terms=tv, sum_f64=sum(tv), row_f64=float(r64[row]),
                abs_sum=abs_sum, k2_minus_plain=diff_r,
                bound=2 * (len(tv) + 2) * 2.0 ** -24 * abs_sum,
                diff_in_2_pow_32=diff_r / 2.0 ** -32)
        chain_ok = all(abs(a["sum_f64"] - a["row_f64"])
                       <= 1e-9 * a["abs_sum"] + 1e-30
                       for a in assembly.values())
        rows.append(dict(
            pixel=p, row=int(py[p]), col=int(px[p]), k2=k, plain=q,
            diff=k - q, f64=ref, terms_abs_sum=terms,
            d_alpha_f64=d_alpha, d_alpha_direct_abs=d_alpha_direct,
            chain_alpha_f32_vs_f64=chain_dev,
            k2_err_over_terms=abs(k - ref) / max(terms, 1e-300),
            plain_err_over_terms=abs(q - ref) / max(terms, 1e-300),
            record_rows=dict(jacobian=jac.tolist(), k2=rk.tolist(),
                             plain=rp.tolist(), f64=r64.tolist()),
            assembly=assembly, assembly_chain_matches_f64=chain_ok,
            rows_within_bound=all(abs(a["k2_minus_plain"]) <= a["bound"]
                                  for a in assembly.values()),
            rows_6_9_share=abs(float((jac64[6:] * (rk - rp)[6:]).sum()))
            / max(abs(k - q), 1e-300),
            alpha=float(alpha[j, p]), raw_alpha=float(raw[j, p]),
            alpha_gate_margin=float(gate_margin[j, p]),
            clamp_margin=float(clamp_margin[j, p]),
            chain_alpha_gate_margin=float(chain_gate_margin[p]),
            t_eps_margin=float(t_margin[p]), kept=bool(idx[j, 0]
                                                       <= lk_t[p])))
    rows.sort(key=lambda r: -abs(r["diff"]))
    top_row = rows[0] if rows else {}
    edge = bool(rows) and (
        min(top_row["alpha_gate_margin"], top_row["clamp_margin"],
            top_row["chain_alpha_gate_margin"], top_row["t_eps_margin"])
        < C1_EDGE_MARGIN or (top_row["k2"] == 0.0) != (top_row["plain"]
                                                       == 0.0))
    diff_total = float(ck.sum() - cp.sum())
    # not a gate: the split names the operation when the pair's rows 0-5
    # differ by no more than their f32 assembly can round, the chain of
    # that assembly is K2's (its terms sum to the f64 rows), the pair
    # carries the surfel's whole difference and rows 6-9 carry none of it
    rounding = bool(rows) and (
        top_row["assembly_chain_matches_f64"]
        and top_row["rows_within_bound"]
        and top_row["rows_6_9_share"] <= 1e-3
        and abs(top_row["diff"] - diff_total) <= 1e-3 * abs(diff_total))
    verdict = ("knife_edge" if edge else "assembly_rounding" if rounding
               else "unexplained")
    emit(label, surfel=s, axis=ax, semantics=int(state.semantics[s]),
         g_k2=float(gk[s, ax]), g_plain=float(gp[s, ax]),
         err=float(err[s, ax]), tol=float(tol[s, ax]),
         err_over_tol=float(ratio[s, ax]),
         worst_abs=dict(surfel=worst_abs // gk.shape[1],
                        axis=worst_abs % gk.shape[1],
                        err=float(err.reshape(-1)[worst_abs])),
         record_bit_equal=rec_equal, one_tile_bit_equal=tile_equal,
         duplicates=per_dup,
         reconstructed=dict(k2=float(ck.sum()), plain=float(cp.sum()),
                            diff=diff_total),
         worst_duplicate=d_w, tile=t_w, tile_length=hi - lo,
         pixels_split=len(rows),
         pixel_sum=dict(k2=sum(r["k2"] for r in rows),
                        plain=sum(r["plain"] for r in rows)),
         top_pairs=rows[:12],
         top_pair_share_of_diff=(top_row.get("diff", 0.0) / diff_total
                                 if diff_total else None),
         edge_margin=C1_EDGE_MARGIN, knife_edge=edge,
         assembly_rounding=rounding, verdict=verdict)
    if verdict == "unexplained":
        raise AssertionError(f"{label}: gated K2's largest per-surfel "
                             "scaling error is neither a knife edge nor "
                             "within the f32 rounding of its record-row "
                             "assembly")
    return verdict


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
    production instantiations the paths run (K1 and K2 at nq 6, 9 and 12,
    gated at (6, 3) and (12, 5), as K<nq,G>; K3), and every instantiation
    of the measurement tools (T1<G,variant>, T2<nq,G,variant>, T3 and T4
    kernels, T5/T6<width,flags> of csrc/micro_floor.cu and its
    redesign's ``T5/T6 terms<width,flags>`` and ``T5/T6 fold<flags>``,
    the T7/T8 copy's first design ``T7/T8 copy<256>``, redesign ``T7/T8
    copy sm90`` and the gap split's ``copy<1024>`` and ``empty``, T9;
    T3's, T4's and T9's redesigns as ``*_sm90``, T1 and T2 on K1's
    and K2's H100 design as ``T1 sm90<nq,G,variant>`` and ``T2
    sm90<nq,G,variant>``), named by the translation unit that built
    them."""
    import re
    from streetunveiler_torch.tools import bisect_bwd, bisect_fwd
    keep = {"K1<6,0>", "K1<9,0>", "K1<12,0>", "K1<6,3>", "K1<12,5>",
            "K2<6,0>", "K2<9,0>", "K2<12,0>", "K2<6,3>", "K2<12,5>", "K3",
            "K3 sm90", "K3 sm90 no cull", "cull"}
    out, name, unit = {}, None, ""
    for line in log.splitlines():
        if line.startswith("== nvcc "):
            unit = line.split()[2]
        elif "Compiling entry function" in line:
            ints = lambda m: [int(x) for x in m.groups()]
            fwd90 = re.search(r"blend_fwd_sm90_kernelILi(\d+)ELi(\d+)E",
                              line)
            fwd90v = re.search(
                r"blend_fwd_sm90_kernelILi(\d+)ELi(\d+)ELi(\d+)E", line)
            bwd90 = re.search(
                r"blend_bwd_sm90_kernelILi(\d+)ELi(\d+)ELi(\d+)E", line)
            fwd = re.search(r"blend_fwd_kernelILi(\d+)ELi(\d+)E", line)
            bwd = re.search(r"blend_bwd_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                            line)
            # the kernel's name follows its length in the mangled name
            probe = re.search(
                r"\d(reduce_[a-z]+(?:_sm90)?|prefix_[a-z]+(?:_sm90)?"
                r"|fold_partials)(?:ILi(\d+)E)?", line)
            walk = re.search(r"floor_walkILi(\d+)ELi(\d+)E", line)
            terms = re.search(r"floor_termsILi(\d+)ELi(\d+)E", line)
            fold = re.search(r"floor_foldILi(\d+)E", line)
            if bwd90 and unit.startswith("bisect"):
                q, g, v = ints(bwd90)
                name = f"T2 sm90<{q},{g},{bisect_bwd.VARIANTS[v]}>"
            elif fwd90v and unit.startswith("bisect"):
                q, g, v = ints(fwd90v)
                name = f"T1 sm90<{q},{g},{bisect_fwd.VARIANTS[v]}>"
            elif fwd90 or bwd90:
                q, g = ints(fwd90 or bwd90)[:2]
                name = f"K{1 if fwd90 else 2}<{q},{g}>"
            elif fwd and unit.startswith("bisect"):
                g, v = ints(fwd)
                name = f"T1<{g},{bisect_fwd.VARIANTS[v]}>"
            elif bwd and unit.startswith("bisect"):
                q, g, v = ints(bwd)
                name = f"T2<{q},{g},{bisect_bwd.VARIANTS[v]}>"
            elif walk:
                w, flags = ints(walk)
                name = f"T{6 if flags & 16 else 5}<{w},{flags}>"
            elif terms:
                w, flags = ints(terms)
                name = f"T{6 if flags & 16 else 5} terms<{w},{flags}>"
            elif fold:
                name = f"T5/T6 fold<{ints(fold)[0]}>"
            elif "copy_int4" in line:
                # the first design (256) and the split's body (1024)
                name = "T7/T8 copy<" + re.search(r"copy_int4ILi(\d+)E",
                                                 line).group(1) + ">"
            elif "copy_vec" in line or "empty_kernel" in line:
                name = ("T7/T8 copy sm90" if "copy_vec" in line
                        else "T7/T8 empty")
            elif "mmt3_kernel" in line:
                name = "T9"
            elif "mmt3_sm90_kernel" in line:
                name = "T9 sm90"
            elif probe:
                tag = "T3" if unit.startswith("micro_reduce") else "T4"
                name = f"{tag} {probe.group(1)}" + (
                    f"<{probe.group(2)}>" if probe.group(2) else "")
            elif "expand_sm90_kernel" in line:
                name = "K3 sm90" + ("" if "ILb1E" in line else " no cull")
            elif "cull_sm90_kernel" in line:
                name = "cull"
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


def train_scene_synthetic(torch, late=False, model_dir=None):
    """The training CLI on the synthetic street scene at its defaults
    (4,000 points, 12 cameras, 160x112, every 8th view held out) for 300
    iterations with densification from iteration 100 at a gradient
    threshold of 5e-5 (at the default 2e-4 no surfel of this scene clones
    or splits in 300 iterations); held-out PSNR before and after, the
    surfel count growing, and the checkpoint read back. With ``late``:
    ``--semantics --sky`` and the late phase from iteration 150
    (``--semantic_dist_from_iter 150``), the sky composited in the
    held-out PSNR and read back from the checkpoint. The model dir is a
    temporary one, or ``model_dir`` (kept for the render and unveil CLIs).
    Returns the held-out PSNR after training."""
    import dataclasses
    from streetunveiler_torch.cli import train as cli_train
    from streetunveiler_torch.cli.common import scene_background
    from streetunveiler_torch.config import ModelParams
    from streetunveiler_torch.cli.common import load_scene_info
    from streetunveiler_torch.models.sky import init_sky
    from streetunveiler_torch.scene.scene import Scene
    from streetunveiler_torch.train.checkpoint import load_checkpoint
    from streetunveiler_torch.train.loop import evaluate_views
    from streetunveiler_torch import trace
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
    trace.reset_launch_counts()
    with (contextlib.nullcontext(model_dir) if model_dir else
          tempfile.TemporaryDirectory(dir=cuda_lib.BUILD_DIR)) as tmp:
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
    launches = dict(trace.launch_counts)
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
    return dict(test_psnr=p1)


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
# T3's library yardsticks (streetunveiler_torch/tools/micro_reduce.py),
# PyTorch's reductions of the thread mode's k 13 sums, the weights on the
# card beforehand: three calls, and one; the faster is library_ms
T3_LIBRARY = {
    "x.view(512, NV, 128).sum(-1).sum(-1)[:, None] * w":
        "micro_reduce_library",
    "x.sum(dim=1)[:, None] * w": "micro_reduce_library_one"}
# T4: the f32 operations of a pair in the serial mode's loop, counted in
# csrc/micro_prefix_sm90.cuh: the fake pair 22, the epilogue 16, the four
# running sums 6
T4_OPS_PER_PAIR = 44
TOOL_REPS = 10


def rel_err(got, want, dims, floor):
    """Largest |got − want| over ``dims`` relative to max(|want|, floor),
    per remaining index; returns the largest."""
    scale = want.abs().amax(dim=dims).clamp(min=max(floor, 1e-38))
    return float(((got - want).abs().amax(dim=dims) / scale).max())


def worst_pixel(torch, err, same, tiles_x):
    """The largest entry of ``err`` [tiles, 512, C], K1's layout (a tile's
    16×32 pixels row by row, the tiles row by row, ``tiles_x`` a row),
    among the pixels where ``same`` [tiles, 512] holds: its tile, its
    image row and column, and its channel."""
    from streetunveiler_torch.ops.rasterizer.kernel import TILE_H, TILE_W
    masked = torch.where(same[..., None], err, torch.zeros_like(err))
    flat = int(masked.reshape(-1).argmax())
    c = err.shape[2]
    tile, sub = divmod(flat // c, err.shape[1])
    return dict(tile=tile, row=tile // tiles_x * TILE_H + sub // TILE_W,
                col=tile % tiles_x * TILE_W + sub % TILE_W, channel=flat % c)


def save_stream(torch, label, args):
    """``torch.save`` of a check's stream (its captured arguments) under
    the git-ignored build directory, for a check that failed."""
    from streetunveiler_torch.ops.rasterizer import cuda_lib
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    path = os.path.join(cuda_lib.BUILD_DIR, f"{label}.pt")
    torch.save([t.cpu() if torch.is_tensor(t) else t for t in args], path)
    return os.path.relpath(path, ROOT)


def t1_vs_plain(torch, bf, k1_args, design="first", variants=None):
    """Every T1 variant of ``design`` (or those of ``variants``) against
    its plain version (the design's skip rule) on ``k1_args``: lk,
    every lk_g and the median (within TOL_MEDIAN) on all but FLIP_FRACTION
    of pixels, each channel within its tolerance over the pixels where they
    all agree (mismatch_frac counts the rest). Each entry also holds the
    median flips, the channel of the largest error, the largest absolute
    error, the pixel where the error relative to its channel's scale is
    largest, and the pairs the plain version counts: the design's, and the
    first design's (every pair a live chain reaches). ``full_nolkmax``,
    which has no lk of its own, also reads the mask of ``full`` (run
    before it on the same stream) at its worst pixel, and its error over
    the pixels both masks keep (``full_mask``), for the knife-edge rule;
    the check itself keeps its own mask."""
    from streetunveiler_torch.ops.rasterizer import kernel, tiles
    nq, n_gates, tiles_x = k1_args[5], k1_args[6], k1_args[2]
    ch = nq + 6
    order = tiles.tile_order(k1_args[1]) if design == "sm90" else None
    out, ok, full_same = {}, True, None
    for v in variants or bf.VARIANTS:
        acc, lk = bf.bisect_forward_cuda(v, *k1_args, design=design,
                                         tile_order=order)
        want_acc, want_lk, count = bf.bisect_forward_plain(
            v, *k1_args, count_pairs=True, **bf.DESIGNS[design])
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
        worst = worst_pixel(torch, (acc - want_acc).abs() / scale, same,
                            tiles_x)
        extra = {}
        if v == "full":
            full_same = same
        elif v == "full_nolkmax" and full_same is not None:
            both = same & full_same
            at = (worst["row"] // kernel.TILE_H * tiles_x
                  + worst["col"] // kernel.TILE_W,
                  worst["row"] % kernel.TILE_H * kernel.TILE_W
                  + worst["col"] % kernel.TILE_W)
            extra["full_mask"] = dict(
                dropped_pixels=int((same & ~full_same).sum()),
                keeps_worst_pixel=bool(full_same[at]),
                max_rel_err=float(((acc[both] - want_acc[both]).abs()
                                   .amax(dim=0) / scale).max()))
        out[v] = dict(mismatch_frac=mism,
                      median_flip_frac=float(flips.float().mean()),
                      max_rel_err=err, worst_channel=int(per_channel.argmax()),
                      worst_pixel=worst, tolerance=tol,
                      max_abs_err=float((acc[same] - want_acc[same]).abs()
                                        .max()),
                      evaluated_pairs=count["evaluated"],
                      evaluated_pairs_first_design=count[
                          "evaluated_first_design"],
                      **extra, within_tolerance=v_ok)
        ok = ok and v_ok
    return out, ok


def t2_vs_plain(torch, bb, a, design="first", variants=None):
    """Every T2 variant of ``design`` (or those of ``variants``) against
    its plain version (the design's batch and skip rule) on the arguments
    ``a`` of a backward: per record row 0..9+nq, the largest error over
    the row's largest gradient (ROW_TOL_REL, as K2)."""
    from streetunveiler_torch.ops.rasterizer import tiles
    nq = a[8]
    order = tiles.tile_order(a[1]) if design == "sm90" else None
    out, ok = {}, True
    for v in variants or bb.VARIANTS:
        got = bb.bisect_backward_cuda(v, *a, design=design, tile_order=order)
        want = bb.bisect_backward_plain(v, *a, **bb.DESIGNS[design])
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


# The variants of the late checks on the trained states' streams: on the
# training phases' own state every T1 variant of the first design (one of
# them once failed on a state trained through atomics), `full` and
# `full_nolkmax` of the sm90 design, T2's `full` in both designs; on the
# other trained states (TRAINED_STATES) `full` and `full_nolkmax` of
# both designs. A gated plain variant costs seconds at full width, and
# chip_smoke.py has to stay inside the card's time limit
TRAINED_T1 = {"first": None, "sm90": ("full", "full_nolkmax")}
TRAINED_T2 = ("full",)


def late_trained_check(torch, a, tool, design, name=""):
    """T1's (``tool`` "fwd") or T2's ("bwd") variants of ``design``
    (TRAINED_T1, TRAINED_T2) against their plain versions on ``a``, the
    late stream of the deterministically trained state ``name``
    (``deterministic_trained_state``), in the line
    ``bisect_{tool}[_sm90]_vs_plain_late_trained[_name]_full_width``; a
    failed check saves the stream first (``save_stream``). Returns the
    verdict."""
    from streetunveiler_torch.tools import bisect_bwd, bisect_fwd
    label = (f"bisect_{tool}{'' if design == 'first' else '_sm90'}"
             f"_vs_plain_late_trained{f'_{name}' if name else ''}"
             f"_full_width")
    nq, n_gates = a[8], a[9]
    if tool == "fwd":
        res, ok = t1_vs_plain(torch, bisect_fwd, a[:5] + (nq, n_gates),
                              design, TRAINED_T1["sm90" if name
                                                 else design])
    else:
        res, ok = t2_vs_plain(torch, bisect_bwd, a, design, TRAINED_T2)
    emit(label, nq=nq, n_gates=n_gates, duplicates=int(a[1][-1]),
         variants=res, within_tolerance=ok)
    if not ok:
        emit(f"{label}_stream", saved=save_stream(torch, label, a))
    return ok


def tool_phases(torch, photo_args, late_args, k2_photo, trained_args):
    """Phase group 9: the measurement tools T1-T4. Every T1/T2 variant
    against its plain version on the dense stack and at full width, T1/T2
    ``full`` bit for bit against the production K1/K2, and every variant
    and mode timed at full width. ``photo_args``/``late_args`` are the
    captured arguments of the photometric (nq 6) and late (nq 12, G 5)
    backward at full width; ``k2_photo`` K2's line on the former;
    ``trained_args`` the late backward's on each trained state, by name
    (``late_trained_check``). Returns the kernels-line rows."""
    from streetunveiler_torch.ops.rasterizer import kernel, tiles
    from streetunveiler_torch import trace
    from streetunveiler_torch.tools import (bisect_bwd, bisect_fwd,
                                            micro_prefix, micro_reduce,
                                            street, timing)
    trace.reset_launch_counts()
    t_start = time.perf_counter()

    # ---- against the plain versions, on the dense stack
    dense = street.dense_streams("cuda")
    all_ok = True
    for n_gates, label in ((0, "photometric"), (5, "late")):
        k1_args = dense[n_gates]
        acc, lk = kernel.blend_forward_cuda(
            *k1_args, tile_order=tiles.tile_order(k1_args[1]))
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
        order = tiles.tile_order(a[1])
        acc_t, lk_t = bisect_fwd.bisect_forward_cuda("full", *k1_args,
                                                     design="first")
        acc_k, lk_k = kernel.blend_forward_cuda(*k1_args, tile_order=order)
        d_t = bisect_bwd.bisect_backward_cuda("full", *a, design="first")
        d_k = kernel.blend_backward_cuda(*a, tile_order=order)
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
                lambda: bisect_fwd.bisect_forward_cuda(v, *k1_args,
                                                       design="first"),
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
                lambda: bisect_bwd.bisect_backward_cuda(v, *a, out=buf,
                                                        design="first"),
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

    for name, a in trained_args.items():
        for tool in ("fwd", "bwd"):
            all_ok = late_trained_check(torch, a, tool, "first",
                                        name) and all_ok

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
    w13 = micro_reduce.weights(13, "cuda")
    t3_lib = {call: timing.median_ms(
        lambda: getattr(micro_reduce, fn)(w13, x), TOOL_REPS)
        for call, fn in T3_LIBRARY.items()}
    t3_lib_call = min(t3_lib, key=t3_lib.get)
    t3_err = float((micro_reduce.micro_reduce_cuda("thread", 13, x)
                    - micro_reduce.micro_reduce_plain("thread", 13, x)
                    ).abs().max())
    # the most operations: the pair chain's 50 per element
    t3_bound, t3_by = bound(nbytes, 50 * x.numel())
    emit("micro_reduce", nv=micro_reduce.NV, bytes=nbytes, modes=modes,
         design="redesign", plain_ms_thread_k13=t3_plain_ms,
         library_ms=t3_lib[t3_lib_call], library_call=t3_lib_call,
         library_ms_each=t3_lib, bound_ms=t3_bound, bound_by=t3_by,
         within_tolerance=t3_ok)
    rows["T3"] = dict(ms=modes["thread_k13"]["ms"], plain_ms=t3_plain_ms,
                      bound_ms=t3_bound, bound_by=t3_by, max_abs_err=t3_err,
                      library_ms=t3_lib[t3_lib_call],
                      library_call=t3_lib_call)
    del x
    all_ok = all_ok and t3_ok

    # ---- T4: micro_prefix at the TPU tool's size
    rec = micro_prefix.make_input()
    n_chunks = micro_prefix.NCHUNK
    pairs = n_chunks * micro_prefix.S * micro_prefix.P
    modes, t4_ok = {}, True
    for mode in micro_prefix.MODES:
        got = micro_prefix.micro_prefix_cuda(mode, rec, "first")
        want = micro_prefix.micro_prefix_plain(mode, rec)
        torch.cuda.synchronize()
        err = rel_err(got, want, (0, 1), 0.0)
        tol = MICRO_TOL_MMA if mode.startswith("mma") else MICRO_TOL_F32
        m_ok = err <= tol and bool(torch.isfinite(got).all())
        ms = timing.median_ms(lambda: micro_prefix.micro_prefix_cuda(
            mode, rec, "first"), TOOL_REPS)
        modes[mode] = dict(ms=ms, ns_per_chunk=ms * 1e6 / n_chunks,
                           precision=micro_prefix.PRECISION[mode],
                           max_rel_err=err, tolerance=tol,
                           within_tolerance=m_ok)
        t4_ok = t4_ok and m_ok
    t4_plain_ms = timing.median_ms(
        lambda: micro_prefix.micro_prefix_plain("serial", rec), 1)
    t4_err = float((micro_prefix.micro_prefix_cuda("serial", rec, "first")
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
         design="first",
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
    launches = dict(trace.launch_counts)
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


# T5-T9 (phase group 10). T5/T6 hold one value per output block, the f32
# fold of its steps' chunk sums: exact where the plain version's block is
# zero, else within FLOOR_RTOL relative (the chunk sums in another order).
# T9 against its plain version per output, relative to the output's
# largest value (the tensor core accumulates in its own order), and its
# three ways against the truth within the three-pass class: the dropped
# lo·lo term is below 2^-14 of each product.
FLOOR_RTOL = 1e-6
MMT3_PLAIN_TOL, MMT3_TRUTH_TOL = 1e-6, 2.0 ** -14
BF16_OPS_PER_S = 989e12      # published H100 SXM dense bf16 tensor rate


def capture_graph(torch, fn, replayed, calls, replays):
    """``calls`` calls of ``fn`` captured in one CUDA graph (after a warm
    call on a side stream), replayed once. A wrapper counts its launch
    once, at capture; the kernel launches of the ``replays`` replays to
    come and of the first are added to ``replayed`` (a Counter by key)."""
    from streetunveiler_torch import trace
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = dict(trace.launch_counts)
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for k, n in trace.launch_counts.items():
        replayed[k] += (n - before.get(k, 0)) * (replays + 1)
    graph.replay()
    torch.cuda.synchronize()
    return graph


def replay_ms(torch, graph, calls):
    """One replay of ``graph`` between CUDA events, per call."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / calls


def graph_ms(torch, fn, replayed, calls=20, replays=5):
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, its replays timed between CUDA events, the median replay
    over ``calls``. The host's time per call, which sets a launch-bound
    call's event time, is left out; the launch gaps inside the graph stay.
    Launches as ``capture_graph`` counts them."""
    graph = capture_graph(torch, fn, replayed, calls, replays)
    return statistics.median(replay_ms(torch, graph, calls)
                             for _ in range(replays))


def graph_turns(torch, a, b, replayed, rounds=8, calls=20):
    """Device time of one call of ``a`` and of ``b``, each captured as
    ``calls`` calls in one CUDA graph, the two graphs' replays timed
    between CUDA events in the turns a, b, b, a for ``rounds`` rounds:
    (times of a, times of b) per call, 2·rounds each. Launches as
    ``capture_graph`` counts them."""
    times = graph_rounds(torch, dict(a=a, b=b), replayed, rounds, calls)
    return times["a"], times["b"]


def graph_rounds(torch, fns, replayed, rounds=8, calls=20):
    """``graph_turns`` for any number of functions: each of ``fns`` (a
    dict) captured as ``calls`` calls in one CUDA graph, the graphs'
    replays timed in the order of ``fns`` and back for ``rounds`` rounds:
    {name: times per call}, 2·rounds each."""
    graphs = {k: capture_graph(torch, fn, replayed, calls, 2 * rounds)
              for k, fn in fns.items()}
    names = list(graphs)
    times = {k: [] for k in names}
    for _ in range(rounds):
        for k in names + names[::-1]:
            times[k].append(replay_ms(torch, graphs[k], calls))
    return times


def turns_summary(times):
    return dict(median=statistics.median(times), min=min(times),
                max=max(times), n=len(times))


def launch_floor_ms(torch):
    """The device time of one tiny PyTorch kernel (a one-element fill_)
    through ``graph_ms``: what a launch-bound call cannot go below."""
    one = torch.zeros(1, device="cuda")
    return graph_ms(torch, lambda: one.fill_(1.0), collections.Counter())


def floor_err(torch, got, want):
    """(exact where want is zero, largest relative error elsewhere)."""
    zero = want == 0
    nz = ~zero
    rel = float(((got[nz] - want[nz]).abs() / want[nz].abs()).max()) \
        if bool(nz.any()) else 0.0
    return bool((got[zero] == 0).all()), rel


def probe_phases(torch):
    """Phase group 10: the per-step floors T5/T6, the identity copies T7/T8
    and the split-precision contraction T9. Each kernel against its plain
    version at the tools' full sizes (T7/T8 on the street's real binning
    outputs); then the probes' path, each tool's run once through its
    entry points with the launch counts set to 0 before and read after
    (every kernel must launch, and every probe's laundered blend must
    equal the unlaundered one bit for bit); then every variant timed.
    Returns the kernels-line rows."""
    from streetunveiler_torch import trace
    from streetunveiler_torch.tools import (micro_floor, probe_compose4,
                                            probe_mmt3, probe_tax, street,
                                            timing)
    trace.reset_launch_counts()
    t_start = time.perf_counter()
    rows, all_ok = {}, True

    # ---- T5 and T6 against their plain versions at the tool's sizes
    rec = micro_floor.make_input()
    visits = micro_floor.visit_arrays(device="cuda")
    tile_of, chunk_of, first, n_real = visits
    n_tiles, vcap = micro_floor.N_TILES, tile_of.numel()
    floor_res = {}
    for variant in micro_floor.VARIANTS:
        args = (variant, rec, tile_of, chunk_of, first, n_tiles)
        got = micro_floor.micro_floor_visit_cuda(*args)
        want = micro_floor.micro_floor_visit_plain(*args)
        torch.cuda.synchronize()
        errs = [floor_err(torch, g, w) for g, w in zip(got, want)]
        ok = len(got) == len(want) and all(
            z and r <= FLOOR_RTOL for z, r in errs)
        floor_res[variant] = dict(
            exact_where_zero=all(z for z, _ in errs),
            max_rel_err=max(r for _, r in errs),
            zero_tiles=int((want[0][:, 0, 0] == 0).sum()),
            max_abs_err=max(float((g - w).abs().max())
                            for g, w in zip(got, want)),
            within_tolerance=ok)
        all_ok = all_ok and ok
        del got, want
    for sb in micro_floor.SBLOCKS:
        tile_map = micro_floor.linear_tile_map(rec.shape[1] // sb, n_tiles,
                                               "cuda")
        got = micro_floor.micro_floor_linear_cuda(sb, rec, tile_map, n_tiles)
        want = micro_floor.micro_floor_linear_plain(sb, rec, tile_map,
                                                    n_tiles)
        torch.cuda.synchronize()
        z, r = floor_err(torch, got, want)
        ok = z and r <= FLOOR_RTOL
        floor_res[f"linear_sb{sb}"] = dict(
            exact_where_zero=z, max_rel_err=r,
            zero_tiles=int((want[:, 0, 0] == 0).sum()),
            max_abs_err=float((got - want).abs().max()),
            within_tolerance=ok)
        all_ok = all_ok and ok
        del got, want
    emit("micro_floor_vs_plain", steps=vcap, real_visits=n_real,
         tiles=n_tiles, chunks=micro_floor.N_CHUNKS, variants=floor_res,
         tolerance=FLOOR_RTOL)

    # ---- T7 and T8 on the street's real binning outputs, bit for bit
    ctx = street.probe_inputs(device="cuda")
    off, surf = ctx.binning.tile_offsets, ctx.binning.sorted_surfel
    ident = {}
    for name, x in (("tile_offsets", off), ("sorted_surfel", surf)):
        ident[f"identity_{name}"] = torch.equal(
            probe_tax.identity_copy_cuda(x), probe_tax.identity_copy_plain(x))
    for name, xs in (("tile_offsets", (off,)),
                     ("sorted_surfel_and_reverse", (surf, surf.flip(0)))):
        got = probe_compose4.identity_copy_stack_cuda(*xs)
        want = probe_compose4.identity_copy_stack_plain(*xs)
        ident[f"identity_stack_{name}"] = len(got) == len(xs) and all(
            torch.equal(g, w) and torch.equal(g, x)
            for g, w, x in zip(got, want, xs))
    torch.cuda.synchronize()
    emit("identity_vs_plain", tiles=ctx.tiles_x * ctx.tiles_y,
         duplicates=int(off[-1]), stream_slots=surf.numel(),
         bit_exact=ident)
    all_ok = all_ok and all(ident.values())

    # ---- T9 against its plain version and the truth
    w, b = probe_mmt3.make_inputs("cuda")
    got = probe_mmt3.mmt3_cuda(w, b)
    want = probe_mmt3.mmt3_plain(w, b)
    torch.cuda.synchronize()
    names = probe_mmt3.WAYS + ("truth",)
    plain_err = {n: float((g - x).abs().max() / x.abs().max())
                 for n, g, x in zip(names, got, want)}
    truth_err = probe_mmt3.truth_errors(got)
    t9_ok = (max(plain_err.values()) <= MMT3_PLAIN_TOL
             and max(truth_err.values()) <= MMT3_TRUTH_TOL)
    emit("mmt3_vs_plain", max_rel_err_vs_plain=plain_err,
         max_rel_err_vs_truth=truth_err,
         plain_max_rel_err_vs_truth=probe_mmt3.truth_errors(want),
         ways_bit_equal=torch.equal(got[0], got[1])
         and torch.equal(got[0], got[2]),
         tolerance_plain=MMT3_PLAIN_TOL, tolerance_truth=MMT3_TRUTH_TOL,
         within_tolerance=t9_ok)
    t9_abs = max(float((g - x).abs().max()) for g, x in zip(got, want))
    all_ok = all_ok and t9_ok

    # ---- the probes' path: each tool once through its entry points
    torch.cuda.synchronize()
    checks = dict(trace.launch_counts)
    trace.reset_launch_counts()
    micro_floor.run(rec, visits, n_tiles, reps=0)
    compose = probe_compose4.run(ctx, reps=0)
    tax = probe_tax.run(ctx, reps=0)
    probe_mmt3.run(w, b, reps=0)
    torch.cuda.synchronize()
    path = dict(trace.launch_counts)
    keys = ("micro_floor_visit", "micro_floor_linear", "identity_stack",
            "identity", "mmt3")
    acc0, lk0 = compose[0]["out"]
    laundered = {l.get("mode") or f"{l['variant']}_x{l['calls']}":
                 torch.equal(l["out"][0], acc0) and torch.equal(l["out"][1],
                                                                 lk0)
                 for l in compose + tax}
    path_ok = all(path[k] > 0 for k in keys) and all(laundered.values())
    emit("probe_path", launches={k: path[k] for k in keys},
         other_launches={k: v for k, v in path.items()
                         if k not in keys and v},
         blend_bit_exact_vs_k_bin=laundered, within_tolerance=path_ok)
    del compose, tax, acc0, lk0
    all_ok = all_ok and path_ok

    # ---- every variant timed
    floor = {l["variant"]: l for l in micro_floor.run(rec, visits, n_tiles,
                                                      TOOL_REPS)}
    emit("micro_floor", reps=TOOL_REPS, variants=floor,
         note="ms: the walk of every step alone, its CSR built beforehand "
              "(csr_ms); ms_real_steps: the same without the padding's "
              "no-op steps; median of CUDA-event times")
    compose = {l["mode"]: l["ms"] for l in probe_compose4.run(ctx,
                                                              TOOL_REPS)}
    tax = {f"{l['variant']}_x{l['calls']}": l["ms"]
           for l in probe_tax.run(ctx, TOOL_REPS)}
    pad1 = probe_tax.pad_lanes(off)
    pad_stack = probe_compose4.stack_lanes(off)
    t8_ms = timing.median_ms(lambda: probe_tax.copy_cuda(pad1), TOOL_REPS)
    t7_ms = timing.median_ms(
        lambda: probe_tax.copy_cuda(pad_stack, "identity_stack"), TOOL_REPS)
    clone_ms = timing.median_ms(lambda: pad1.clone(), TOOL_REPS)
    clone_stack_ms = timing.median_ms(lambda: pad_stack.clone(), TOOL_REPS)
    t8_wrapper_ms = timing.median_ms(lambda: probe_tax.identity_copy_cuda(
        off), TOOL_REPS)
    t7_wrapper_ms = timing.median_ms(
        lambda: probe_compose4.identity_copy_stack_cuda(off), TOOL_REPS)
    emit("probe_compose4", reps=TOOL_REPS, ms=compose,
         launder_ms=compose["k_bin_launder"] - compose["k_bin"],
         note="binning then K1; k_full_launder1 equals k_full_launder (one "
              "index array)")
    emit("probe_tax", reps=TOOL_REPS, ms=tax,
         launder_ms=tax["launder_x1"] - tax["args_x1"],
         dyn_ms=tax["dyn_x1"] - tax["args_x1"],
         second_blend_ms=tax["args_x2"] - tax["args_x1"])
    # launch-bound: the device time of each call beside its event time
    dev = dict(
        kernel=lambda: probe_tax.copy_cuda(pad1),
        kernel_stack=lambda: probe_tax.copy_cuda(pad_stack, "identity_stack"),
        plain=lambda: probe_tax.copy_plain(pad1),
        plain_stack=lambda: probe_tax.copy_plain(pad_stack),
        clone=lambda: pad1.clone(), clone_stack=lambda: pad_stack.clone(),
        wrapper=lambda: probe_tax.identity_copy_cuda(off),
        wrapper_stack=lambda: probe_compose4.identity_copy_stack_cuda(off))
    replayed = collections.Counter()
    dev = {k: graph_ms(torch, fn, replayed) for k, fn in dev.items()}
    # the copy against clone beyond the spread: both replayed in turns
    vs_clone = {}
    for name, x, key in (("T8", pad1, "identity"),
                         ("T7", pad_stack, "identity_stack")):
        kt, ct = graph_turns(torch, lambda: probe_tax.copy_cuda(x, key),
                             lambda: x.clone(), replayed)
        vs_clone[name] = dict(kernel_ms=turns_summary(kt),
                              clone_ms=turns_summary(ct),
                              loses_beyond_spread=min(kt) > max(ct),
                              wins_beyond_spread=max(kt) < min(ct))
    emit("identity_time", values=off.numel(), padded_values=pad1.numel(),
         event_ms=dict(kernel=t8_ms, kernel_stack=t7_ms,
                       wrapper=t8_wrapper_ms, wrapper_stack=t7_wrapper_ms,
                       clone=clone_ms, clone_stack=clone_stack_ms),
         device_ms=dev, kernel_vs_clone=vs_clone,
         note="kernel: the copy of the padded array alone; wrapper: padding, "
              "copy and slice; plain = clone; event_ms brackets the host's "
              "path too, device_ms replays 20 calls in a CUDA graph; "
              "kernel_vs_clone: 8 rounds of the turns kernel, clone, clone, "
              "kernel, each a replay of 20 calls in a CUDA graph (ms a "
              "call); loses_beyond_spread: the kernel's fastest replay is "
              "slower than clone's slowest")
    t9 = dict(kernel=lambda: probe_mmt3.mmt3_cuda(w, b),
              plain=lambda: probe_mmt3.mmt3_plain(w, b),
              library=lambda: probe_mmt3.mmt3_library(w, b))
    t9_event = {k: timing.median_ms(fn, TOOL_REPS) for k, fn in t9.items()}
    t9_dev = {k: graph_ms(torch, fn, replayed) for k, fn in t9.items()}
    floor_ms = launch_floor_ms(torch)
    emit("probe_mmt3", event_ms=t9_event, device_ms=t9_dev,
         launch_floor_ms=floor_ms,
         library_call="torch.matmul(w, b[:7].T), TF32 off",
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    # ---- plain times and bounds
    t5_args = ("base", rec, tile_of, chunk_of, first, n_tiles)
    t5_plain_ms = timing.median_ms(
        lambda: micro_floor.micro_floor_visit_plain(*t5_args), 1)
    map128 = micro_floor.linear_tile_map(rec.shape[1] // 128, n_tiles,
                                         "cuda")
    t6_plain_ms = timing.median_ms(
        lambda: micro_floor.micro_floor_linear_plain(128, rec, map128,
                                                     n_tiles), 1)
    chunk_bytes = micro_floor.REC * micro_floor.S * 4
    block_bytes = micro_floor.PIX * micro_floor.CH * 4
    adds = first >= 0
    chunks_read = int(torch.unique(chunk_of[adds]).numel())
    # T5 base: each chunk a step adds read once, the three visit arrays,
    # both outputs written once; one add per element read
    t5_bytes = (chunks_read * chunk_bytes + 3 * 4 * vcap
                + 2 * n_tiles * block_bytes)
    t5_bound, t5_by = bound(t5_bytes, int(adds.sum()) * chunk_bytes // 4)
    # T6 at sb 128: the whole record array, tile_map, the output
    t6_bytes = rec.numel() * 4 + 4 * map128.numel() + n_tiles * block_bytes
    t6_bound, t6_by = bound(t6_bytes, rec.numel())
    t7_bound, t7_by = bound(2 * 4 * pad_stack.numel(), 0)
    t8_bound, t8_by = bound(2 * 4 * pad1.numel(), 0)
    # T9: w and b read, four outputs written; the truth's f32 products and
    # sums, and 3 ways x 3 passes of 2·512·8·128 bf16 tensor-core ops
    t9_bytes = 4 * (w.numel() + b.numel() + 4 * 512 * 7)
    t9_ops_ms = (2 * 512 * 7 * 128 / F32_OPS_PER_S
                 + 9 * 2 * 512 * 8 * 128 / BF16_OPS_PER_S) * 1e3
    t9_bytes_ms = t9_bytes / HBM_BYTES_PER_S * 1e3
    t9_bound = max(t9_bytes_ms, t9_ops_ms)
    t9_by = "bytes" if t9_bytes_ms >= t9_ops_ms else "operations"
    torch.cuda.synchronize()
    # every launch of the group: the checks against the plain versions,
    # the probes' path and the timings, and the CUDA graphs' replays
    launches = {k: checks.get(k, 0) + trace.launch_counts[k] + replayed[k]
                for k in keys}
    emit("probes_summary", seconds=time.perf_counter() - t_start,
         t5_bytes=t5_bytes, t5_chunks_read=chunks_read, t6_bytes=t6_bytes,
         t9_bytes=t9_bytes, tool_launches=launches,
         graph_replay_launches={k: replayed[k] for k in keys},
         within_tolerance=all_ok)
    if not all_ok:
        raise AssertionError("a probe's kernel disagrees with its plain "
                             "version, or the probes' path failed")
    # T5's ms walks every step, so the block of tile 0 walks the ~9,280
    # padding steps alone after the others; ms_real_steps leaves them out
    # of the CSR (the same outputs), and csr_ms is the CSR's build
    rows["T5"] = dict(ms=floor["base"]["ms"], plain_ms=t5_plain_ms,
                      ms_real_steps=floor["base"]["ms_real_steps"],
                      csr_ms=floor["base"]["csr_ms"],
                      bound_ms=t5_bound, bound_by=t5_by,
                      max_abs_err=floor_res["base"]["max_abs_err"],
                      library_ms=None, key="micro_floor_visit")
    rows["T6"] = dict(ms=floor["linear_sb128"]["ms"], plain_ms=t6_plain_ms,
                      bound_ms=t6_bound, bound_by=t6_by,
                      max_abs_err=floor_res["linear_sb128"]["max_abs_err"],
                      library_ms=None, key="micro_floor_linear")
    # T7-T9 are launch-bound: their rows give device times
    rows["T7"] = dict(ms=dev["kernel_stack"], plain_ms=dev["plain_stack"],
                      bound_ms=t7_bound, bound_by=t7_by, max_abs_err=0.0,
                      library_ms=dev["clone_stack"], key="identity_stack",
                      launch_floor_ms=floor_ms, vs_clone=vs_clone["T7"])
    rows["T8"] = dict(ms=dev["kernel"], plain_ms=dev["plain"],
                      bound_ms=t8_bound, bound_by=t8_by, max_abs_err=0.0,
                      library_ms=dev["clone"], key="identity",
                      launch_floor_ms=floor_ms, vs_clone=vs_clone["T8"])
    rows["T9"] = dict(ms=t9_dev["kernel"], plain_ms=t9_dev["plain"],
                      bound_ms=t9_bound, bound_by=t9_by, max_abs_err=t9_abs,
                      library_ms=t9_dev["library"], key="mmt3",
                      launch_floor_ms=floor_ms)
    for r in rows.values():
        r["launches"] = path[r["key"]]
        r["tool_launches"] = launches[r["key"]]
    rows["identity_inputs"] = (off, surf)
    return rows


# ---------------------------------------------------------------------------
# Phase group 11: the redesigned K1 and K2 (csrc/blend_fwd_sm90.cuh,
# csrc/blend_bwd_sm90.cuh) against their first design (csrc/blend_fwd.cuh,
# csrc/blend_bwd.cuh, as the bisection tools' `full` variant), on the
# captured full-width streams of the photometric and the late step.

REDESIGN_REPS = 10
# the acceptance ratio of each form's time to the first design's
REDESIGN_TARGET = {("k1", "photometric"): 1.03, ("k1", "semantic"): 1.03,
                   ("k1", "late"): 0.85, ("k2", "photometric"): 1.03,
                   ("k2", "semantic"): 1.03, ("k2", "late"): 0.75}


def tile_lengths(torch, off):
    """Duplicates per tile of one binning's CSR offsets."""
    n = (off[1:] - off[:-1]).double()
    q = torch.quantile(n, torch.tensor([0.5, 0.99], dtype=torch.float64,
                                       device=n.device))
    total = float(n.sum())
    return dict(tiles=n.numel(), empty_tiles=int((n == 0).sum()),
                duplicates=int(total), max=int(n.max()), p99=float(q[1]),
                p50=float(q[0]), mean=float(n.mean()),
                longest_share=float(n.max()) / total)


def tile_order_guard(torch, a):
    """K1 and K2 on the blend arguments ``a`` with the binning's order
    and with its first entry (the longest tile) replaced by one past the
    last tile: that block leaves its tile, every other tile comes out bit
    for bit as with the binning's order, and K2 gives the left tile's
    duplicates no gradient."""
    from streetunveiler_torch.ops.rasterizer import kernel, tiles
    recT, off, tx, ty, settings, _, _, _, nq, n_gates = a
    order = tiles.tile_order(off)
    bad = order.clone()
    bad[0] = order.numel()
    left = int(order[0])
    k1_args = a[:5] + (nq, n_gates)
    acc, lk = kernel.blend_forward_cuda(*k1_args, tile_order=order)
    acc_b, lk_b = kernel.blend_forward_cuda(*k1_args, tile_order=bad)
    d = kernel.blend_backward_cuda(*a, tile_order=order)
    d_b = kernel.blend_backward_cuda(*a, tile_order=bad)
    torch.cuda.synchronize()
    rest = torch.arange(order.numel(), device=off.device) != left
    lo, hi = int(off[left]), int(off[left + 1])
    k1_ok = torch.equal(acc[rest], acc_b[rest]) and torch.equal(lk[rest],
                                                                lk_b[rest])
    k2_ok = (torch.equal(d[:, :lo], d_b[:, :lo])
             and torch.equal(d[:, hi:], d_b[:, hi:])
             and not bool(d_b[:, lo:hi].any()))
    emit("tile_order_guard", nq=nq, n_gates=n_gates, left_tile=left,
         left_duplicates=hi - lo, k1_other_tiles_equal=k1_ok,
         k2_equal_and_left_tile_zero=k2_ok)
    return k1_ok and k2_ok


def redesign_phases(torch, photo_args, sem_args, late_args, ptxas):
    """Each of the six forms (K1 and K2 at nq 6, at nq 12 — the semantic
    step's — and gated at (12, 5)) on the same captured inputs: bit for bit
    against the first design, both timed (median of REDESIGN_REPS
    CUDA-event times, in the turns first, new, new, first), the bound on
    the pairs the redesign evaluates (and on the first design's), ptxas'
    registers and spills, resident blocks per SM, and the pairs each design
    evaluates (the plain versions' counts). Before them, the kernels'
    guard against an order entry that names no tile. Returns the first
    design's times and the checks' verdict."""
    from streetunveiler_torch.ops.rasterizer import cuda_lib, kernel, tiles
    from streetunveiler_torch.tools import bisect_bwd, bisect_fwd, timing

    off = late_args[1]
    order_ok = torch.equal(tiles.tile_order(off).cpu(),
                           tiles.tile_order(off.cpu()))
    emit("tile_lengths", **tile_lengths(torch, off),
         tile_order_on_card_equals_cpu=order_ok,
         note="duplicates per 16x32 tile of the late step's binning "
              "(street-300k-1920x1280); longest_share = max / duplicates")
    guard_ok = tile_order_guard(torch, photo_args)

    def timed(old, new):
        t = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            fn = old if which == "old" else new
            t[which].append(timing.median_ms(fn, REDESIGN_REPS))
        return statistics.mean(t["old"]), statistics.mean(t["new"]), t

    lines = {"k1": {}, "k2": {}}
    first, ok = {}, order_ok and guard_ok
    for a, label in ((photo_args, "photometric"), (sem_args, "semantic"),
                     (late_args, "late")):
        nq, n_gates = a[8], a[9]
        k1_args = a[:5] + (nq, n_gates)
        order = tiles.tile_order(a[1])
        target = {k: REDESIGN_TARGET[k, label] for k in ("k1", "k2")}

        # ---- K1
        new = lambda: kernel.blend_forward_cuda(*k1_args, tile_order=order)
        old = lambda: bisect_fwd.bisect_forward_cuda("full", *k1_args,
                                                     design="first")
        acc_n, lk_n = new()
        acc_o, lk_o = old()
        torch.cuda.synchronize()
        exact = torch.equal(acc_n, acc_o) and torch.equal(lk_n, lk_o)
        counts = kernel.blend_forward_plain(*k1_args, count_pairs=True)[2]
        ms_old, ms_new, t = timed(old, new)
        nbytes = k1_bytes(a, acc_n, lk_n)
        ops = {k: k1_ops(counts, k) for k in ("evaluated", EVALUATED)}
        del acc_n, lk_n, acc_o, lk_o
        lines["k1"][label] = dict(
            nq=nq, n_gates=n_gates, bit_exact=exact, ms_first_design=ms_old,
            ms=ms_new, ratio=ms_new / ms_old, target_ratio=target["k1"],
            meets_target=ms_new <= target["k1"] * ms_old, ms_runs=t,
            bytes=nbytes, operations=ops[EVALUATED],
            bound_ms=bound(nbytes, ops[EVALUATED])[0],
            operations_first_design_pairs=ops["evaluated"],
            bound_ms_first_design_pairs=bound(nbytes, ops["evaluated"])[0],
            evaluated_pairs_first_design=counts["evaluated"],
            evaluated_pairs=counts[EVALUATED],
            kept_pairs=counts["kept"], gated_kept_pairs=counts["gated_kept"],
            ptxas=ptxas.get(f"K1<{nq},{n_gates}>"),
            ptxas_first_design=ptxas.get(f"T1<{n_gates},full>"),
            blocks_per_sm=cuda_lib.occupancy("blend_fwd", nq, n_gates),
            blocks_per_sm_first_design=cuda_lib.occupancy("bisect_fwd", nq,
                                                          n_gates))
        first[("k1", label)] = ms_old
        ok = ok and exact

        # ---- K2, a fresh zeroed dgrad in each call of both designs
        new = lambda: kernel.blend_backward_cuda(*a, tile_order=order)
        old = lambda: bisect_bwd.bisect_backward_cuda("full", *a,
                                                      design="first")
        d_n, d_o = new(), old()
        torch.cuda.synchronize()
        exact = torch.equal(d_n, d_o)
        del d_n, d_o
        counts = kernel.blend_backward_plain(*a, count_pairs=True)[1]
        ms_old, ms_new, t = timed(old, new)
        nbytes = k2_bytes(kernel, a)
        ops = {k: k2_ops(counts, nq, k) for k in ("evaluated", EVALUATED)}
        lines["k2"][label] = dict(
            nq=nq, n_gates=n_gates, bit_exact=exact, ms_first_design=ms_old,
            ms=ms_new, ratio=ms_new / ms_old, target_ratio=target["k2"],
            meets_target=ms_new <= target["k2"] * ms_old, ms_runs=t,
            bytes=nbytes, operations=ops[EVALUATED],
            bound_ms=bound(nbytes, ops[EVALUATED])[0],
            operations_first_design_pairs=ops["evaluated"],
            bound_ms_first_design_pairs=bound(nbytes, ops["evaluated"])[0],
            evaluated_pairs_first_design=counts["evaluated"],
            evaluated_pairs=counts[EVALUATED],
            kept_pairs=counts["kept"], gated_kept_pairs=counts["gated_kept"],
            vjp_pairs=counts["any_kept"],
            ptxas=ptxas.get(f"K2<{nq},{n_gates}>"),
            ptxas_first_design=ptxas.get(f"T2<{nq},{n_gates},full>"),
            blocks_per_sm=cuda_lib.occupancy("blend_bwd", nq, n_gates),
            blocks_per_sm_first_design=cuda_lib.occupancy("bisect_bwd", nq,
                                                          n_gates))
        first[("k2", label)] = ms_old
        ok = ok and exact
    note = ("first design = csrc/blend_*.cuh as the bisection tools' full "
            "variant; ms = mean of the medians of two runs of "
            f"{REDESIGN_REPS} CUDA-event times each (ms_runs, in the turns "
            "first, new, new, first); K2 with a fresh zeroed dgrad in both; "
            "bound_ms counts the pairs the redesign evaluates, "
            "bound_ms_first_design_pairs those the first design evaluates")
    emit("k1_redesign", forms=lines["k1"], note=note)
    emit("k2_redesign", forms=lines["k2"], note=note)
    return dict(first=first, ok=ok)


# ---------------------------------------------------------------------------
# Phase group 12: the redesigned T3 and T9 (csrc/micro_reduce_sm90.cuh,
# csrc/mmt3_sm90.cuh) against their first design (csrc/micro_reduce.cu,
# csrc/mmt3.cu), at the TPU tools' sizes.

PROBE_REDESIGN_REPS = 10
F32_INSTR_PER_S = F32_OPS_PER_S / 2   # unfused: an FMA counts as two
# unfused f32 instructions an element of the T3 modes that carry many: the
# pair chain's 25 multiplies and 25 adds, the thread mode's multiply and
# add for each weight
T3_INSTRUCTIONS = {"pair": lambda k: 50, "thread": lambda k: 2 * k}
T3_KERNEL = {"pair": "reduce_warp", "thread": "reduce_thread",
             "warp": "reduce_warp", "mma": "reduce_mma"}


def probe_redesign_phases(torch, ptxas):
    """T3: each of the nine (mode, k) of both designs on the same x (1.07
    GB): bit for bit, the redesign within its tolerance of the plain
    version, both timed back to back (the mean over PROBE_REDESIGN_REPS
    launches between two CUDA events, the host's launch path hidden) in the
    turns first, new, new, first, beside both library yardsticks timed the
    same way; bounds, ptxas. T9: the four outputs of both designs bit for
    bit, within tolerance of the plain version and the truth; device times
    from CUDA-graph replays (graph_ms) in the same turns, beside matmul's
    and the launch floor. Returns the kernels-line numbers and the checks'
    verdict."""
    from streetunveiler_torch import trace
    from streetunveiler_torch.tools import micro_reduce, probe_mmt3
    trace.reset_launch_counts()
    t_start = time.perf_counter()

    def turns(time_fn, first, new):
        t = {"first": [], "new": []}
        for which in ("first", "new", "new", "first"):
            t[which].append(time_fn(first if which == "first" else new))
        return statistics.mean(t["first"]), statistics.mean(t["new"]), t

    b2b = lambda fn: cuda_ms(torch, fn, PROBE_REDESIGN_REPS)
    ok = True

    # ---- T3
    x = micro_reduce.make_input()
    n = x.numel()
    bytes_ms = 4 * n / HBM_BYTES_PER_S * 1e3
    w13 = micro_reduce.weights(13, "cuda")
    lib = {call: [b2b(lambda: getattr(micro_reduce, fn)(w13, x))
                  for _ in range(2)] for call, fn in T3_LIBRARY.items()}
    lib_ms = {call: statistics.mean(v) for call, v in lib.items()}
    lib_call = min(lib_ms, key=lib_ms.get)
    modes = {}
    for mode, k in micro_reduce.MODES:
        first = micro_reduce.micro_reduce_cuda(mode, k, x, "first")
        new = micro_reduce.micro_reduce_cuda(mode, k, x)
        want = micro_reduce.micro_reduce_plain(mode, k, x)
        torch.cuda.synchronize()
        cols = 1 if mode == "pair" else k
        err = rel_err(new[:, :cols], want[:, :cols], 0, 0.0)
        tol = MICRO_TOL_MMA if mode == "mma" else MICRO_TOL_F32
        equal = torch.equal(new, first)
        del first, new, want
        ms_first, ms_new, t = turns(
            b2b, lambda: micro_reduce.micro_reduce_cuda(mode, k, x, "first"),
            lambda: micro_reduce.micro_reduce_cuda(mode, k, x))
        # the operations this function needs: a multiply and an add for
        # each weight and element (on the tensor cores in bf16 for mma), or
        # the pair chain's 50
        ops = (50 if mode == "pair" else 2 * k) * n
        ops_ms = ops / (BF16_OPS_PER_S if mode == "mma"
                        else F32_OPS_PER_S) * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        line = dict(
            bit_equal=equal, max_rel_err_vs_plain=err, tolerance=tol,
            within_tolerance=err <= tol, ms_first_design=ms_first, ms=ms_new,
            ratio=ms_new / ms_first, ms_runs=t, bound_ms=bound_ms,
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            share_of_bound=bound_ms / ms_new,
            ptxas=ptxas.get(f"T3 {T3_KERNEL[mode]}_sm90<{k}>"),
            ptxas_first_design=ptxas.get(f"T3 {T3_KERNEL[mode]}<{k}>"))
        if mode in T3_INSTRUCTIONS:
            per = T3_INSTRUCTIONS[mode](k)
            line.update(f32_instructions_per_element=per,
                        instruction_floor_ms=per * n / F32_INSTR_PER_S * 1e3)
        modes[f"{mode}_k{k}"] = line
        ok = ok and equal and err <= tol
    emit("micro_reduce_redesign", nv=micro_reduce.NV, bytes=4 * n,
         modes=modes, library_ms=lib_ms[lib_call], library_call=lib_call,
         library_ms_each=lib_ms, library_ms_runs=lib,
         bytes_bound_ms=bytes_ms, ptxas_fold=ptxas.get("T3 fold_partials"),
         note="first design = csrc/micro_reduce.cu, redesign = "
              "csrc/micro_reduce_sm90.cuh; ms = mean of two runs of "
              f"{PROBE_REDESIGN_REPS} launches back to back between two "
              "CUDA events (the host's launch path hidden), in the turns "
              "first, new, new, first; the library calls timed the same "
              "way with the weights on the card; instruction_floor_ms: "
              "unfused f32 instructions at 33.5 T/s")

    # ---- T9
    w, b = probe_mmt3.make_inputs("cuda")
    first = probe_mmt3.mmt3_cuda(w, b, "first")
    new = probe_mmt3.mmt3_cuda(w, b)
    want = probe_mmt3.mmt3_plain(w, b)
    torch.cuda.synchronize()
    names = probe_mmt3.WAYS + ("truth",)
    equal = {nm: torch.equal(f, g) for nm, f, g in zip(names, first, new)}
    plain_err = {nm: float((g - p).abs().max() / p.abs().max())
                 for nm, g, p in zip(names, new, want)}
    truth_err = probe_mmt3.truth_errors(new)
    ways_equal = torch.equal(new[0], new[1]) and torch.equal(new[0], new[2])
    t9_ok = (all(equal.values()) and ways_equal
             and max(plain_err.values()) <= MMT3_PLAIN_TOL
             and max(truth_err.values()) <= MMT3_TRUTH_TOL)
    ok = ok and t9_ok
    replayed = collections.Counter()
    graph = lambda fn: graph_ms(torch, fn, replayed)
    t9_first, t9_new, t9_runs = turns(
        graph, lambda: probe_mmt3.mmt3_cuda(w, b, "first"),
        lambda: probe_mmt3.mmt3_cuda(w, b))
    t9_lib = statistics.mean(
        graph(lambda: probe_mmt3.mmt3_library(w, b)) for _ in range(2))
    floor_ms = statistics.mean(launch_floor_ms(torch) for _ in range(2))
    emit("mmt3_redesign", bit_equal=equal, ways_bit_equal=ways_equal,
         max_rel_err_vs_plain=plain_err, max_rel_err_vs_truth=truth_err,
         tolerance_plain=MMT3_PLAIN_TOL, tolerance_truth=MMT3_TRUTH_TOL,
         within_tolerance=t9_ok, device_ms_first_design=t9_first,
         device_ms=t9_new, ratio=t9_new / t9_first, device_ms_runs=t9_runs,
         library_ms=t9_lib, library_call="torch.matmul(w, b[:7].T), TF32 off",
         launch_floor_ms=floor_ms, x_launch_floor=t9_new / floor_ms,
         ptxas=ptxas.get("T9 sm90"), ptxas_first_design=ptxas.get("T9"),
         note="first design = csrc/mmt3.cu, redesign = csrc/mmt3_sm90.cuh; "
              "device_ms: 20 calls captured in a CUDA graph, the median "
              "replay over the calls (graph_ms), mean of two turns each, "
              "in the turns first, new, new, first")
    torch.cuda.synchronize()
    launches = {key: trace.launch_counts[key] + replayed[key]
                for key in ("micro_reduce", "mmt3")}
    emit("probe_redesign_summary", seconds=time.perf_counter() - t_start,
         tool_launches=launches, within_tolerance=ok)
    return dict(ok=ok, launches=launches, t3=dict(
        ms=modes["thread_k13"]["ms"],
        ms_first_design=modes["thread_k13"]["ms_first_design"],
        library_ms=lib_ms[lib_call], library_call=lib_call),
        t9=dict(ms=t9_new, ms_first_design=t9_first, library_ms=t9_lib,
                launch_floor_ms=floor_ms))


# ---------------------------------------------------------------------------
# Phase group 13: K3's device time, the binning stage split into its parts,
# and T2 rebuilt on K2's H100 design (csrc/blend_bwd_sm90.cuh).

BINNING_REPS = 10
PLAIN_CULL_PARTS = ("tile_rects", "conic_cull")


def k3_device_time(torch, k3_args):
    """K3's device time from CUDA-graph replays (graph_ms, two turns),
    beside the event time of 50 back-to-back host calls (cuda_ms: the
    host's launch path when it is the longer) and the launch floor.
    Returns the line's fields."""
    from streetunveiler_torch.ops.rasterizer import tiles
    fn = lambda: tiles.expand_duplicates_cuda(*k3_args)
    replayed = collections.Counter()
    runs = [graph_ms(torch, fn, replayed) for _ in range(2)]
    host = cuda_ms(torch, fn, 50)
    floor_ms = statistics.mean(launch_floor_ms(torch) for _ in range(2))
    return dict(device_ms=statistics.mean(runs), device_ms_runs=runs,
                host_path_ms=host, launch_floor_ms=floor_ms,
                replayed_launches=replayed["expand"])


def binning_split(torch, state, cam, cap):
    """The step's binning stage (``bin_step``) and its parts, each alone
    on the street's inputs (the plain rects and conic cull beside the cull
    kernel that replaces them on the card): CUDA-event times of
    BINNING_REPS back-to-back
    calls (as the step's stages) and device times from CUDA-graph replays.
    Returns the line's fields."""
    from streetunveiler_torch import renderer
    from streetunveiler_torch.ops.rasterizer import kernel, tiles
    from streetunveiler_torch.ops.rasterizer.preprocess import \
        preprocess_surfels
    from streetunveiler_torch.train.step import bin_step
    settings = renderer._settings_for(cam, 1.0)
    n = state.capacity
    zeros3 = torch.zeros((n, 3), device="cuda")

    def preprocess():
        return preprocess_surfels(
            state.params.xyz, state.get_scaling(), state.get_rotation(),
            state.get_opacity()[:, 0], zeros3, cam.w2c, cam.K, settings)
    with torch.no_grad():
        sur = preprocess()
        tw, th = kernel.TILE_W, kernel.TILE_H
        w, h = cam.width, cam.height
        tiles_x, tiles_y = -(-w // tw), -(-h // th)
        n_tiles = tiles_x * tiles_y
        rects = tiles.tile_rects(sur.center2d, sur.ext, sur.valid, w, h, tw,
                                 th)
        nt, cols = tiles.conic_cull(sur.cull, sur.center2d, rects, sur.valid,
                                    tw, th)
        table = tiles.cull_rects_cuda(sur.cull, sur.center2d, sur.ext,
                                      sur.valid, w, h, tw, th)
        order = tiles.depth_order(sur.depth, sur.valid)
        tbl, dup_start = tiles.rank_table(table, order)
        k3_args = (tbl, dup_start, cap, tiles_x, n_tiles, True)
        tile_id, surf_id = tiles.expand_duplicates_cuda(*k3_args)
        capp = tile_id.numel()
        tile_id, surf_id = tile_id[:cap], surf_id[:cap]
        s_tile, _ = tiles.sort_by_tile(tile_id, surf_id)
        off = tiles.csr_offsets(s_tile, n_tiles)
    parts = dict(
        preprocess=preprocess,
        tile_rects=lambda: tiles.tile_rects(sur.center2d, sur.ext, sur.valid,
                                            w, h, tw, th),
        conic_cull=lambda: tiles.conic_cull(sur.cull, sur.center2d, rects,
                                            sur.valid, tw, th),
        cull_kernel=lambda: tiles.cull_rects_cuda(
            sur.cull, sur.center2d, sur.ext, sur.valid, w, h, tw, th),
        depth_argsort=lambda: tiles.depth_order(sur.depth, sur.valid),
        table_gather_cumsum=lambda: tiles.rank_table(table, order),
        k3=lambda: tiles.expand_duplicates_cuda(*k3_args),
        tile_sort=lambda: tiles.sort_by_tile(tile_id, surf_id),
        searchsorted=lambda: tiles.csr_offsets(s_tile, n_tiles),
        tile_order=lambda: tiles.tile_order(off))
    whole = lambda: bin_step(state, cam, duplicate_capacity=cap,
                             device="cuda")
    replayed = collections.Counter()
    with torch.no_grad():
        event = {k: cuda_ms(torch, fn, BINNING_REPS)
                 for k, fn in parts.items()}
        device = {k: graph_ms(torch, fn, replayed)
                  for k, fn in parts.items()}
        whole_event = cuda_ms(torch, whole, BINNING_REPS)
        whole_device = graph_ms(torch, whole, replayed)
    return dict(parts_ms=event, parts_device_ms=device,
                # the step's own parts: the kernel, not the plain cull
                parts_sum_ms=sum(v for k, v in event.items()
                                 if k not in PLAIN_CULL_PARTS),
                parts_device_sum_ms=sum(v for k, v in device.items()
                                        if k not in PLAIN_CULL_PARTS),
                bin_step_ms=whole_event, bin_step_device_ms=whole_device,
                duplicates=int(dup_start[-1]), capacity=cap,
                k3_slots=capp)


def ptxas_numbers(lines):
    """Registers, spill stores and loads and stack frame bytes of one
    kernel's ptxas lines (``ptxas_summary``), or None."""
    import re
    if not lines:
        return None
    text = " ".join(lines)

    def get(pattern):
        m = re.search(pattern, text)
        return int(m.group(1)) if m else None
    return dict(registers=get(r"Used (\d+) registers"),
                spill_stores=get(r"(\d+) bytes spill stores"),
                spill_loads=get(r"(\d+) bytes spill loads"),
                stack_frame=get(r"(\d+) bytes stack frame"))


def k3_redesign(torch, k3_args, k3_over, ptxas):
    """K3's H100 design (csrc/expand_sm90.cuh) against its first design
    (csrc/expand.cu) and its plain version at the street's capacity and at
    the overflow capacity: bit for bit; both designs' device times from
    CUDA-graph replays (graph_ms) in the turns first, new, new, first; the
    event time of 50 back-to-back host calls of each; the byte bound, the
    launch floor, ptxas. Returns the line's capacities and the verdict."""
    from streetunveiler_torch.ops.rasterizer import tiles
    replayed = collections.Counter()
    out, ok = {}, True
    for label, a in (("street", k3_args), ("overflow", k3_over)):
        new = tiles.expand_duplicates_cuda(*a)
        first = tiles.expand_duplicates_cuda(*a, design="first")
        plain = tiles.expand_duplicates_plain(*a)
        torch.cuda.synchronize()
        eq_first = all(torch.equal(x, y) for x, y in zip(new, first))
        eq_plain = all(torch.equal(x, y) for x, y in zip(new, plain))
        capp = new[0].numel()
        del new, first, plain
        call = {d: (lambda d=d: tiles.expand_duplicates_cuda(*a, design=d))
                for d in tiles.DESIGNS}
        t = {"first": [], "sm90": []}
        for which in ("first", "sm90", "sm90", "first"):
            t[which].append(graph_ms(torch, call[which], replayed))
        ms, ms_first = statistics.mean(t["sm90"]), statistics.mean(t["first"])
        nbytes = 4 * (a[0].numel() + a[1].numel() + 2 * capp)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[label] = dict(
            capacity=a[2], slots=capp, duplicates=int(a[1][-1]),
            bit_equal_first_design=eq_first, bit_equal_plain=eq_plain,
            device_ms=ms, device_ms_first_design=ms_first,
            ratio=ms / ms_first, device_ms_runs=t,
            host_path_ms=cuda_ms(torch, call["sm90"], 50),
            host_path_ms_first_design=cuda_ms(torch, call["first"], 50),
            bytes=nbytes, bound_ms=bound_ms, share_of_bound=bound_ms / ms,
            meets_target=ms <= 2 * bound_ms)
        ok = ok and eq_first and eq_plain
    floor_ms = statistics.mean(launch_floor_ms(torch) for _ in range(2))
    emit("k3_redesign", capacities=out, launch_floor_ms=floor_ms,
         ptxas=ptxas.get("K3 sm90"), ptxas_first_design=ptxas.get("K3"),
         replayed_launches=replayed["expand"], within_tolerance=ok,
         note="first design = csrc/expand.cu (su_expand_first), redesign = "
              "csrc/expand_sm90.cuh; device_ms: 20 calls captured in a "
              "CUDA graph, the median replay over the calls (graph_ms), "
              "mean of two turns each, in the turns first, new, new, first; "
              "host_path_ms: 50 back-to-back calls between CUDA events; "
              "meets_target: device_ms <= 2 x bound_ms")
    return dict(ok=ok, capacities=out, launch_floor_ms=floor_ms)


# the parts of gated K2's time the sm90 T2 variants split off: full minus
# the variant (the floor is a time of its own)
K2_SPLIT = {"payload_gradient_sums": "no_dq", "pair_vjp": "no_vjp",
            "omega_gq_q": "no_gqqc", "suffix_updates": "no_suffmm",
            "division_rebuild": "no_exp"}


def k2_split(variants):
    """Gated K2's time split by the T2 variants' times ({variant: ms})."""
    full = variants["full"]
    parts = {k: full - variants[v] for k, v in K2_SPLIT.items()}
    return dict(full=full, walk_and_staging=variants["floor"], **parts,
                not_split=full - variants["floor"] - sum(parts.values()))


def bisect_bwd_sm90_phases(torch, photo_args, sem_args, late_args, ptxas,
                           trained_args):
    """T2 on K2's H100 design (csrc/bisect_bwd_sm90*.cu): every variant
    against its plain version (batch 64, the exact pair skip) on the
    dense stack at G 0 and 5; ``full`` bit for bit against the production
    K2 with the same ptxas registers and spills, at nq 6, nq 12 and
    (12, 5) on the captured full-width streams; every variant timed in the
    turns first, new, new, first beside its first-design counterpart
    (median of TOOL_REPS CUDA-event times, dgrad zeroed outside the timed
    launches); gated K2's time split by both designs' variants; the late
    checks on the trained states' streams ``trained_args``, by name
    (``late_trained_check``). Returns the kernels-row numbers and the
    verdict."""
    from streetunveiler_torch.ops.rasterizer import kernel, tiles
    from streetunveiler_torch import trace
    from streetunveiler_torch.tools import bisect_bwd, street, timing
    trace.reset_launch_counts()
    t_start = time.perf_counter()
    ok = True
    dense = street.dense_streams("cuda")
    for n_gates, label in ((0, "photometric"), (5, "late")):
        k1_args = dense[n_gates]
        acc, lk = kernel.blend_forward_cuda(
            *k1_args, tile_order=tiles.tile_order(k1_args[1]))
        nq = k1_args[5]
        a = k1_args[:5] + (acc, lk, bisect_bwd.cotangents(acc, nq, n_gates),
                           nq, n_gates)
        res, v_ok = t2_vs_plain(torch, bisect_bwd, a, "sm90")
        emit(f"bisect_bwd_sm90_vs_plain_{label}_dense", nq=nq,
             n_gates=n_gates, variants=res, within_tolerance=v_ok)
        ok = ok and v_ok

    forms, row = {}, {}
    for a, label in ((photo_args, "photometric"), (sem_args, "semantic"),
                     (late_args, "late")):
        nq, n_gates = a[8], a[9]
        order = tiles.tile_order(a[1])
        d_t = bisect_bwd.bisect_backward_cuda("full", *a, tile_order=order)
        d_k = kernel.blend_backward_cuda(*a, tile_order=order)
        torch.cuda.synchronize()
        exact = torch.equal(d_t, d_k)
        if label == "photometric":
            want = bisect_bwd.bisect_backward_plain(
                "full", *a, **bisect_bwd.DESIGNS["sm90"])
            row["max_abs_err"] = float((d_t - want).abs().max())
            del want
        del d_t, d_k
        regs = ptxas_numbers(ptxas.get(f"T2 sm90<{nq},{n_gates},full>"))
        regs_k2 = ptxas_numbers(ptxas.get(f"K2<{nq},{n_gates}>"))
        same_regs = regs is not None and regs == regs_k2
        times = {}
        for v in (bisect_bwd.VARIANTS if label != "semantic" else ("full",)):
            buf_first, buf_new = torch.zeros_like(a[0]), torch.zeros_like(a[0])
            call = dict(
                first=lambda: bisect_bwd.bisect_backward_cuda(
                    v, *a, out=buf_first, design="first"),
                sm90=lambda: bisect_bwd.bisect_backward_cuda(
                    v, *a, out=buf_new, tile_order=order))
            t = {"first": [], "sm90": []}
            for which in ("first", "sm90", "sm90", "first"):
                t[which].append(timing.median_ms(call[which], TOOL_REPS))
            del buf_first, buf_new
            times[v] = dict(
                ms=statistics.mean(t["sm90"]),
                ms_first_design=statistics.mean(t["first"]), ms_runs=t,
                ptxas=ptxas_numbers(ptxas.get(f"T2 sm90<{nq},{n_gates},{v}>")),
                ptxas_first_design=ptxas_numbers(
                    ptxas.get(f"T2<{nq},{n_gates},{v}>")))
        for v in times:
            times[v]["ms_minus_full"] = times[v]["ms"] - times["full"]["ms"]
        forms[label] = dict(nq=nq, n_gates=n_gates,
                            full_bit_exact_vs_production=exact,
                            ptxas_full=regs, ptxas_production=regs_k2,
                            same_registers_and_spills=same_regs,
                            variants=times)
        ok = ok and exact and same_regs
    for name, a in trained_args.items():
        ok = late_trained_check(torch, a, "bwd", "sm90", name) and ok
    late = forms["late"]["variants"]
    split = k2_split({v: late[v]["ms"] for v in late})
    split_first = k2_split({v: late[v]["ms_first_design"] for v in late})
    emit("bisect_bwd_sm90", forms=forms, gated_k2_split=split,
         gated_k2_split_first_design=split_first, reps=TOOL_REPS,
         note="sm90 = csrc/blend_bwd_sm90.cuh's kernel on each variant "
              "(csrc/bisect_bwd_sm90*.cu), first = csrc/blend_bwd.cuh's; "
              "ms = mean of the medians of two runs of "
              f"{TOOL_REPS} CUDA-event times each (ms_runs, in the turns "
              "first, new, new, first), dgrad zeroed outside the timed "
              "launches; gated_k2_split at (12, 5): full minus each "
              "variant, the floor's own time as walk_and_staging")
    torch.cuda.synchronize()
    launches = trace.launch_counts["bisect_bwd"]
    emit("bisect_bwd_sm90_summary", seconds=time.perf_counter() - t_start,
         tool_launches=launches, within_tolerance=ok)
    photo = forms["photometric"]["variants"]["full"]
    row.update(ms=photo["ms"], ms_first_design=photo["ms_first_design"])
    return dict(ok=ok, launches=launches, t2=row)


# ---------------------------------------------------------------------------
# Phase group 14: T1 rebuilt on K1's H100 design (csrc/blend_fwd_sm90.cuh)
# and T4 redesigned (csrc/micro_prefix_sm90.cuh), each against its first
# design in the same call.

# the MUFU's issue rate: 16 lanes an SM a clock, against the FP32 pipe's 128
MUFU_INSTR_PER_S = F32_INSTR_PER_S * 16 / 128

# the parts of gated K1's time the T1 variants split off: full minus the
# variant (the floor is a time of its own; a transmittance product that
# costs less than the frozen one counts as none)
K1_SPLIT = {"pair_math": "full_nopair", "exp": "full_noexp",
            "transmittance_product": "full_noprefix", "sums": "full_nosums",
            "median": "full_nomed", "lk": "full_nolkmax"}


def k1_split(variants):
    """Gated K1's time split by the T1 variants' times ({variant: ms})."""
    full = variants["full"]
    parts = {k: full - variants[v] for k, v in K1_SPLIT.items()}
    parts["transmittance_product"] = max(parts["transmittance_product"],
                                         0.0)
    return dict(full=full, walk_and_staging=variants["floor"], **parts,
                not_split=full - variants["floor"] - sum(parts.values()))


def bisect_fwd_sm90_phases(torch, photo_args, sem_args, late_args, ptxas,
                           trained_args):
    """T1 on K1's H100 design (csrc/bisect_fwd_sm90*.cu): every variant
    against its plain version (the exact pair skip) on the dense stack at
    G 0 and 5 and at full width on the photometric and late streams;
    ``full`` bit for bit against the production K1 with the same ptxas
    registers and spills, at nq 6, nq 12 and (12, 5) on the captured
    full-width streams; every variant timed in the turns first, new, new,
    first beside its first-design counterpart (median of TOOL_REPS
    CUDA-event times), with both designs' evaluated pairs; gated K1's time
    split by both designs' variants; the late checks on the trained
    states' streams ``trained_args``, by name (``late_trained_check``).
    Returns the kernels-row numbers and the verdict."""
    from streetunveiler_torch.ops.rasterizer import cuda_lib, kernel, tiles
    from streetunveiler_torch import trace
    from streetunveiler_torch.tools import bisect_fwd, street, timing
    trace.reset_launch_counts()
    t_start = time.perf_counter()
    ok = True
    dense = street.dense_streams("cuda")
    for n_gates, label in ((0, "photometric"), (5, "late")):
        res, v_ok = t1_vs_plain(torch, bisect_fwd, dense[n_gates], "sm90")
        emit(f"bisect_fwd_sm90_vs_plain_{label}_dense", nq=dense[n_gates][5],
             n_gates=n_gates, duplicates=int(dense[n_gates][1][-1]),
             variants=res, within_tolerance=v_ok)
        ok = ok and v_ok

    forms, row = {}, {}
    for a, label in ((photo_args, "photometric"), (sem_args, "semantic"),
                     (late_args, "late")):
        nq, n_gates = a[8], a[9]
        k1_args = a[:5] + (nq, n_gates)
        order = tiles.tile_order(a[1])
        acc_t, lk_t = bisect_fwd.bisect_forward_cuda(
            "full", *k1_args, tile_order=order)
        acc_k, lk_k = kernel.blend_forward_cuda(*k1_args, tile_order=order)
        torch.cuda.synchronize()
        exact = torch.equal(acc_t, acc_k) and torch.equal(lk_t, lk_k)
        del acc_t, lk_t, acc_k, lk_k
        regs = ptxas_numbers(ptxas.get(f"T1 sm90<{nq},{n_gates},full>"))
        regs_k1 = ptxas_numbers(ptxas.get(f"K1<{nq},{n_gates}>"))
        same_regs = regs is not None and regs == regs_k1
        variants = bisect_fwd.VARIANTS if label != "semantic" else ("full",)
        pairs = {}
        if label != "semantic":
            res, v_ok = t1_vs_plain(torch, bisect_fwd, k1_args, "sm90")
            emit(f"bisect_fwd_sm90_vs_plain_{label}_full_width", nq=nq,
                 n_gates=n_gates, duplicates=int(a[1][-1]), variants=res,
                 within_tolerance=v_ok)
            ok = ok and v_ok
            pairs = {v: (res[v]["evaluated_pairs"],
                         res[v]["evaluated_pairs_first_design"])
                     for v in variants}
            if label == "photometric":
                row["max_abs_err"] = res["full"]["max_abs_err"]
        times = {}
        for v in variants:
            call = dict(
                first=lambda: bisect_fwd.bisect_forward_cuda(
                    v, *k1_args, design="first"),
                sm90=lambda: bisect_fwd.bisect_forward_cuda(
                    v, *k1_args, tile_order=order))
            t = {"first": [], "sm90": []}
            for which in ("first", "sm90", "sm90", "first"):
                t[which].append(timing.median_ms(call[which], TOOL_REPS))
            times[v] = dict(
                ms=statistics.mean(t["sm90"]),
                ms_first_design=statistics.mean(t["first"]), ms_runs=t,
                ptxas=ptxas_numbers(
                    ptxas.get(f"T1 sm90<{nq},{n_gates},{v}>")),
                ptxas_first_design=ptxas_numbers(
                    ptxas.get(f"T1<{n_gates},{v}>")))
            if v in pairs:
                times[v].update(evaluated_pairs=pairs[v][0],
                                evaluated_pairs_first_design=pairs[v][1])
        for v in times:
            times[v]["ms_minus_full"] = times[v]["ms"] - times["full"]["ms"]
            times[v]["ms_minus_full_first_design"] = (
                times[v]["ms_first_design"]
                - times["full"]["ms_first_design"])
        forms[label] = dict(nq=nq, n_gates=n_gates,
                            full_bit_exact_vs_production=exact,
                            ptxas_full=regs, ptxas_production=regs_k1,
                            same_registers_and_spills=same_regs,
                            blocks_per_sm=cuda_lib.occupancy(
                                "bisect_fwd_sm90", nq, n_gates),
                            variants=times)
        ok = ok and exact and same_regs
    for name, a in trained_args.items():
        ok = late_trained_check(torch, a, "fwd", "sm90", name) and ok
    late = forms["late"]["variants"]
    split = k1_split({v: late[v]["ms"] for v in late})
    split_first = k1_split({v: late[v]["ms_first_design"] for v in late})
    emit("bisect_fwd_sm90", forms=forms, gated_k1_split=split,
         gated_k1_split_first_design=split_first, reps=TOOL_REPS,
         note="sm90 = csrc/blend_fwd_sm90.cuh's kernel on each variant "
              "(csrc/bisect_fwd_sm90*.cu), first = csrc/blend_fwd.cuh's; "
              "ms = mean of the medians of two runs of "
              f"{TOOL_REPS} CUDA-event times each (ms_runs, in the turns "
              "first, new, new, first); evaluated_pairs from the sm90 plain "
              "version's count (the exact pair skip), "
              "evaluated_pairs_first_design without it; gated_k1_split at "
              "(12, 5): full minus each variant, the floor's own time as "
              "walk_and_staging, a negative transmittance_product as 0")
    torch.cuda.synchronize()
    launches = trace.launch_counts["bisect_fwd"]
    emit("bisect_fwd_sm90_summary", seconds=time.perf_counter() - t_start,
         tool_launches=launches, within_tolerance=ok)
    photo = forms["photometric"]["variants"]["full"]
    row.update(ms=photo["ms"], ms_first_design=photo["ms_first_design"])
    return dict(ok=ok, launches=launches, t1=row)


def serial_instruction_floor(torch, pairs):
    """T4's serial mode: the FP32-pipe and MUFU instructions of one pair
    in its loop's SASS (``cuobjdump -sass`` on the built library), and the
    least time the card needs to issue them at 128 FP32 and 16 MUFU lanes
    an SM a clock (the clock of the published f32 peak); and the issue
    floor of all the loop's instructions, one a clock for each of an SM's
    four schedulers (128 thread instructions an SM a clock)."""
    from streetunveiler_torch.ops.rasterizer import cuda_lib
    from streetunveiler_torch.tools import micro_prefix
    tool = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", cuda_lib.library_path()],
                          capture_output=True, text=True, timeout=600,
                          check=True).stdout
    counts = micro_prefix.sass_loop_counts(sass)
    fp32_ms = counts["fp32_per_pair"] * pairs / F32_INSTR_PER_S * 1e3
    mufu_ms = counts["mufu_per_pair"] * pairs / MUFU_INSTR_PER_S * 1e3
    every = sum(counts["per_pair"].values())
    return dict(**counts, all_per_pair=every, fp32_floor_ms=fp32_ms,
                mufu_floor_ms=mufu_ms,
                instruction_floor_ms=max(fp32_ms, mufu_ms),
                issue_floor_ms=every * pairs / F32_INSTR_PER_S * 1e3)


def micro_prefix_redesign(torch, ptxas):
    """T4's redesign (csrc/micro_prefix_sm90.cuh) against its first design
    (csrc/micro_prefix.cu) at the TPU tool's size: serial and warpscan bit
    for bit, every mode of the redesign within its tolerance of the plain
    version, both designs timed in the turns first, new, new, first
    (median of TOOL_REPS CUDA-event times), each tensor-core mode's gap to
    serial, ptxas; the serial mode's instruction floor. Returns the
    kernels-row numbers and the verdict."""
    from streetunveiler_torch import trace
    from streetunveiler_torch.tools import micro_prefix, timing
    trace.reset_launch_counts()
    t_start = time.perf_counter()
    rec = micro_prefix.make_input()
    pairs = micro_prefix.NCHUNK * micro_prefix.S * micro_prefix.P
    modes, ok = {}, True
    for mode in micro_prefix.MODES:
        first = micro_prefix.micro_prefix_cuda(mode, rec, "first")
        new = micro_prefix.micro_prefix_cuda(mode, rec)
        want = micro_prefix.micro_prefix_plain(mode, rec)
        torch.cuda.synchronize()
        mma = mode.startswith("mma")
        err = rel_err(new, want, (0, 1), 0.0)
        tol = MICRO_TOL_MMA if mma else MICRO_TOL_F32
        equal = torch.equal(new, first)
        m_ok = (err <= tol and bool(torch.isfinite(new).all())
                and (mma or equal))
        line = dict(bit_equal_first_design=equal, max_rel_err_vs_plain=err,
                    max_abs_err=float((new - want).abs().max()),
                    tolerance=tol, within_tolerance=m_ok,
                    precision=micro_prefix.PRECISION[mode])
        del first, new, want
        t = {"first": [], "new": []}
        for which in ("first", "new", "new", "first"):
            design = "first" if which == "first" else "redesign"
            t[which].append(timing.median_ms(
                lambda: micro_prefix.micro_prefix_cuda(mode, rec, design),
                TOOL_REPS))
        kernel_name = {"serial": "prefix_serial",
                       "warpscan": "prefix_warpscan"}.get(
            mode, f"prefix_mma<{micro_prefix.MODES.index(mode)}>")
        sm90_name = kernel_name.replace("<", "_sm90<") if mma \
            else kernel_name + "_sm90"
        line.update(ms=statistics.mean(t["new"]),
                    ms_first_design=statistics.mean(t["first"]), ms_runs=t,
                    ptxas=ptxas_numbers(ptxas.get(f"T4 {sm90_name}")),
                    ptxas_first_design=ptxas_numbers(
                        ptxas.get(f"T4 {kernel_name}")))
        modes[mode] = line
        ok = ok and m_ok
    for line in modes.values():
        line["ratio_to_first_design"] = line["ms"] / line["ms_first_design"]
        line["ratio_to_serial"] = line["ms"] / modes["serial"]["ms"]
    fastest = min(modes, key=lambda m: modes[m]["ms"])
    t4_bytes = 4 * (3 * micro_prefix.NCHUNK * micro_prefix.S
                    + micro_prefix.NCHUNK // micro_prefix.CPT
                    * micro_prefix.P * 16)
    bound_ms, bound_by = bound(t4_bytes, T4_OPS_PER_PAIR * pairs)
    try:
        floor = serial_instruction_floor(torch, pairs)
    except (OSError, ValueError, subprocess.SubprocessError) as e:
        floor = dict(error=repr(e))
    emit("micro_prefix_redesign", chunks=micro_prefix.NCHUNK, pairs=pairs,
         modes=modes, fastest_mode=fastest, bound_ms=bound_ms,
         bound_by=bound_by, operations_per_pair=T4_OPS_PER_PAIR,
         serial_instruction_floor=floor, within_tolerance=ok,
         note="first design = csrc/micro_prefix.cu, redesign = "
              "csrc/micro_prefix_sm90.cuh; ms = mean of the medians of two "
              f"runs of {TOOL_REPS} CUDA-event times each (ms_runs, in the "
              "turns first, new, new, first); ratio_to_serial against the "
              "redesign's serial mode")
    torch.cuda.synchronize()
    launches = trace.launch_counts["micro_prefix"]
    emit("micro_prefix_redesign_summary",
         seconds=time.perf_counter() - t_start, tool_launches=launches,
         within_tolerance=ok)
    best = modes[fastest]
    return dict(ok=ok, launches=launches, t4=dict(
        ms=best["ms"], ms_first_design=best["ms_first_design"],
        fastest_mode=fastest, max_abs_err=best["max_abs_err"],
        bound_ms=bound_ms, bound_by=bound_by,
        ms_each_mode={m: modes[m]["ms"] for m in modes},
        ms_first_design_each_mode={m: modes[m]["ms_first_design"]
                                   for m in modes}))


# ---------------------------------------------------------------------------
# Phase group 15: T5 and T6 redesigned (csrc/micro_floor_sm90.cuh) against
# their first design (csrc/micro_floor.cu's floor_walk), at the tool's
# sizes. The bounds are phase group 10's (T5 base, T6 at width 128).

# the flags of each variant's kernels (csrc/micro_floor_sm90.cuh's
# variant_flags): first, scratch, alldone, two outputs, linear
FLOOR_FLAGS = dict(base=11, alldone=7, one_out=3, static_out=3,
                   no_scratch=1, prefetch2=2, linear=16)


def floor_ptxas(ptxas, variant, width):
    """ptxas numbers of a T5/T6 variant's kernels: the redesign's phase A
    and phase B, the first design's walk."""
    flags = FLOOR_FLAGS["linear" if variant.startswith("linear") else variant]
    t = "T6" if flags & 16 else "T5"
    terms = flags & 17 if flags & 17 else flags   # prefetch2: no first
    fold = flags & 14
    return dict(
        terms=ptxas_numbers(ptxas.get(f"{t} terms<{width},{terms}>")),
        fold=ptxas_numbers(ptxas.get(f"T5/T6 fold<{fold}>")),
        first_design=ptxas_numbers(ptxas.get(f"{t}<{width},{flags}>")))


def micro_floor_redesign(torch, ptxas, probes):
    """T5's six variants and T6's three widths on the redesign
    (csrc/micro_floor_sm90.cuh) against the first design at the tool's
    sizes: bit for bit, within FLOOR_RTOL of the plain version, both
    designs timed in the turns first, new, new, first (CUDA events around
    a call, median of TOOL_REPS, and CUDA-graph replays), the CSR without
    the padding's no-op steps, ptxas (no stack frame in the redesign's
    kernels, or the verdict fails); T5 base and prefetch2 and T6 width 128
    split into phase A alone, phase B alone and tile 0's segment alone,
    their bounds (phase group 10's, ``probes``) and shares; T6's library
    composite. Returns the kernels-row numbers and the verdict."""
    from streetunveiler_torch import trace
    from streetunveiler_torch.tools import micro_floor as mf
    from streetunveiler_torch.tools import timing
    trace.reset_launch_counts()
    t_start = time.perf_counter()
    replayed = collections.Counter()
    rec = mf.make_input()
    tile_of, chunk_of, first, n_real = mf.visit_arrays(device="cuda")
    n_tiles, vcap = mf.N_TILES, tile_of.numel()
    lines, ok = {}, True

    def times(f):
        return dict(event_ms=timing.median_ms(f, TOOL_REPS),
                    device_ms=graph_ms(torch, f, replayed))

    def turns(call_first, call_new):
        """Both timings' mean of each design's two turns."""
        out = {}
        for kind, timer in (("event_ms",
                             lambda f: timing.median_ms(f, TOOL_REPS)),
                            ("device_ms",
                             lambda f: graph_ms(torch, f, replayed))):
            t = {"first": [], "new": []}
            for which in ("first", "new", "new", "first"):
                t[which].append(timer(call_first if which == "first"
                                      else call_new))
            out[kind] = statistics.mean(t["new"])
            out[kind + "_first_design"] = statistics.mean(t["first"])
            out[kind + "_runs"] = t
        return out

    def split(call, variant, width, csr, n_pos, steps_args):
        """Phase A alone, phase B alone (on phase A's terms), and both on
        tile 0's segment alone (a CSR of one output block: its positions,
        its one output block stored), then each phase of that alone, by
        events and graph replays."""
        def phase(which, c, work, n_blocks=n_tiles):
            return mf._redesign_phase(which, variant, rec, c, n_blocks, work,
                                      *steps_args, sblock=width)
        work = mf.work_buffer(n_pos, "cuda")
        phase("terms", csr, work)
        n0 = int(csr[1][1])
        seg0 = (csr[0][:n0].contiguous(),
                torch.tensor([0, n0], dtype=torch.int32, device="cuda"),
                torch.zeros(1, dtype=torch.int32, device="cuda"))
        work0 = mf.work_buffer(n0, "cuda")
        phase("terms", seg0, work0, 1)
        parts = dict(
            terms=lambda: phase("terms", csr, work),
            fold=lambda: phase("fold", csr, work),
            segment0=lambda: call(seg0, n_blocks=1),
            segment0_terms=lambda: phase("terms", seg0, work0, 1),
            segment0_fold=lambda: phase("fold", seg0, work0, 1))
        return {k: times(f) for k, f in parts.items()} | dict(
            segment0_positions=n0)

    cases = [(v, 128) for v in mf.VARIANTS] + [
        (f"linear_sb{sb}", sb) for sb in mf.SBLOCKS]
    for name, width in cases:
        linear = name.startswith("linear")
        if linear:
            tile_map = mf.linear_tile_map(rec.shape[1] // width, n_tiles,
                                          "cuda")
            csr = mf.step_csr(tile_map, n_tiles, segment_order=True)
            real = None
            variant, steps_args = "linear", (None, None)

            def call(c, design="redesign", n_blocks=n_tiles):
                return (mf.micro_floor_linear_cuda(width, rec, tile_map,
                                                   n_blocks, c, design),)
            want = (mf.micro_floor_linear_plain(width, rec, tile_map,
                                                n_tiles),)
            csr_fn = lambda: mf.step_csr(tile_map, n_tiles,
                                         segment_order=True)
        else:
            va = (name, rec, tile_of, chunk_of, first, n_tiles)
            csr = mf.visit_csr(*va, segment_order=True)
            real = mf.visit_csr(*va, real_only=True, segment_order=True)
            variant, steps_args = name, (chunk_of, first)

            def call(c, design="redesign", n_blocks=n_tiles):
                return mf.micro_floor_visit_cuda(*va[:5], n_blocks, c,
                                                 design)
            want = mf.micro_floor_visit_plain(*va)
            csr_fn = lambda: mf.visit_csr(*va, segment_order=True)
        steps = csr[0].numel()
        new = call(csr)
        old = call(csr[:2], design="first")
        torch.cuda.synchronize()
        errs = [floor_err(torch, g, w) for g, w in zip(new, want)]
        equal = len(new) == len(old) and all(
            torch.equal(a, b) for a, b in zip(new, old))
        line = dict(
            steps=steps, bit_equal_first_design=equal,
            max_rel_err_vs_plain=max(r for _, r in errs),
            exact_where_zero=all(z for z, _ in errs),
            max_abs_err=max(float((g - w).abs().max())
                            for g, w in zip(new, want)))
        c_ok = equal and all(z and r <= FLOOR_RTOL for z, r in errs)
        if real is not None:
            real_out = call(real)
            line["bit_equal_real_steps"] = all(
                torch.equal(a, b) for a, b in zip(new, real_out))
            c_ok = c_ok and line["bit_equal_real_steps"]
            del real_out
        del new, old, want
        line.update(turns(lambda: call(csr[:2], design="first"),
                          lambda: call(csr)))
        line["ns_per_step"] = line["device_ms"] * 1e6 / steps
        line["csr_ms"] = timing.median_ms(csr_fn, TOOL_REPS)
        if real is not None:
            line["real_steps"] = real[0].numel()
            line["real_steps_only"] = times(lambda: call(real))
            line["real_steps_only_first_design"] = times(
                lambda: call(real[:2], design="first"))
        if name in ("base", "prefetch2", "linear_sb128"):
            line["split"] = split(call, variant, width, csr, steps,
                                  steps_args)
        line["ptxas"] = floor_ptxas(ptxas, name, width)
        line["within_tolerance"] = c_ok
        lines[name] = line
        ok = ok and c_ok
    # T6's library composite at each width: the three calls a user would
    # write (block sums, index_add_ into the tiles, the broadcast); index_add_
    # sums a tile's terms by atomics, so it is a time, not a reference
    for sb in mf.SBLOCKS:
        tile_map = mf.linear_tile_map(rec.shape[1] // sb, n_tiles, "cuda")

        def composite():
            t = rec.view(mf.REC, -1, sb).sum((0, 2)) * 1e-30
            acc = torch.zeros(n_tiles, device="cuda").index_add_(
                0, tile_map, t)
            return acc[:, None, None].expand(-1, mf.PIX, mf.CH).contiguous()
        lines[f"linear_sb{sb}"]["composite_ms"] = timing.median_ms(
            composite, TOOL_REPS)
    t5, t6 = probes["T5"], probes["T6"]
    for name, row in (("base", t5), ("linear_sb128", t6)):
        line = lines[name]
        line.update(bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                    share_of_bound=row["bound_ms"] / line["device_ms"],
                    share_of_bound_event=row["bound_ms"] / line["event_ms"],
                    share_of_bound_first_design=row["bound_ms"]
                    / line["device_ms_first_design"],
                    half_bound_met=line["device_ms"] <= 2 * row["bound_ms"],
                    half_bound_met_event=line["event_ms"]
                    <= 2 * row["bound_ms"])
    no_stack = all(
        p is not None and p["stack_frame"] == 0
        for l in lines.values()
        for k, p in l["ptxas"].items() if k != "first_design")
    ok = ok and no_stack
    emit("micro_floor_redesign", steps=vcap, real_visits=n_real,
         tiles=n_tiles, chunks=mf.N_CHUNKS, cases=lines,
         tolerance=FLOOR_RTOL, no_stack_frame=no_stack,
         within_tolerance=ok,
         note="first design = csrc/micro_floor.cu floor_walk, redesign = "
              "csrc/micro_floor_sm90.cuh (phase A floor_terms, phase B "
              "floor_fold); event_ms: CUDA events around one call (the "
              f"wrapper's host path included), median of {TOOL_REPS}; "
              "device_ms: 20 calls in a CUDA graph, the median replay "
              "(graph_ms); each the mean of two turns in the turns first, "
              "new, new, first; the CSR built beforehand (csr_ms: the "
              "redesign's, with the segment order); share_of_bound on "
              "device_ms; bounds: phase group 10's (T5 base 354 MB, T6 "
              "width 128 291 MB of bytes); composite_ms: three library "
              "calls, not one")
    torch.cuda.synchronize()
    launches = {k: trace.launch_counts[k] + replayed[k]
                for k in ("micro_floor_visit", "micro_floor_linear")}
    emit("micro_floor_redesign_summary",
         seconds=time.perf_counter() - t_start, tool_launches=launches,
         within_tolerance=ok)
    b, l128 = lines["base"], lines["linear_sb128"]

    def row(line):
        return dict(ms=line["device_ms"],
                    ms_first_design=line["device_ms_first_design"],
                    event_ms=line["event_ms"],
                    event_ms_first_design=line["event_ms_first_design"],
                    share_of_bound=line["share_of_bound"],
                    max_abs_err=line["max_abs_err"])
    return dict(ok=ok, launches=launches,
                t5=dict(row(b), ms_real_steps=b["real_steps_only"][
                    "device_ms"], csr_ms=b["csr_ms"]),
                t6=dict(row(l128), composite_ms=l128["composite_ms"]))


# ---------------------------------------------------------------------------
# Phase group 16: T7/T8's copy redesigned (csrc/identity_sm90.cuh) against
# its first design and `clone`, and the split of what a copy costs in a
# CUDA graph.

# cudaGraphNodeType's names
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                    4: "graph", 5: "empty", 6: "wait_event",
                    7: "event_record", 10: "mem_alloc", 11: "mem_free"}
# su_identity_split's kinds: an empty kernel, the first design's body on a
# grid of the caller's
SPLIT_KINDS = {"empty": 0, "first_body": 1}
# a copy's share of its byte bound above this means its bytes did not all
# come from and go to HBM (the source was still in L2): the time is not
# the bound case
SHARE_OF_BOUND_MAX = 1.05


def split_launch(torch, kind, xp, blocks=0, threads=0, key="identity"):
    """One launch of ``su_identity_split``'s ``kind`` (SPLIT_KINDS) on the
    padded int32 CUDA tensor xp: the empty kernel or the first design's
    body on <<<blocks, threads>>>. Returns the copy (xp itself for the
    empty kernel, which copies nothing); a copy counts under ``key``."""
    from streetunveiler_torch.ops.rasterizer import cuda_lib
    from streetunveiler_torch import trace
    from streetunveiler_torch.tools import probe_tax
    index, stream = probe_tax._check_padded(xp)
    out = xp if kind == "empty" else torch.empty_like(xp)
    rc = cuda_lib.load_library().su_identity_split(
        SPLIT_KINDS[kind], blocks, threads, xp.data_ptr(), out.data_ptr(),
        xp.numel(), index, stream)
    cuda_lib.check(rc, f"identity split launch ({kind})")
    if kind != "empty":
        trace.launch_counts[key] += 1
    return out


def graph_nodes(torch, fn, calls=3):
    """The nodes of ``calls`` calls of ``fn`` captured in a CUDA graph
    (``su_graph_nodes``): each node's type with a kernel node's blocks
    and threads (-1 for a kernel of PyTorch's, whose grid the runtime does
    not give) or a memcpy node's bytes, and the edges' types."""
    import ctypes
    from streetunveiler_torch.ops.rasterizer import cuda_lib
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    n = 64
    types, info = (ctypes.c_int * n)(), (ctypes.c_longlong * (2 * n))()
    edges, n_nodes, n_edges = (ctypes.c_int * n)(), ctypes.c_int(), \
        ctypes.c_int()
    rc = cuda_lib.load_library().su_graph_nodes(
        graph.raw_cuda_graph(), n, ctypes.addressof(types),
        ctypes.addressof(info), ctypes.addressof(n_nodes),
        ctypes.addressof(edges), ctypes.addressof(n_edges))
    cuda_lib.check(rc, "graph nodes")
    nodes = []
    for i in range(min(n_nodes.value, n)):
        kind = GRAPH_NODE_TYPES.get(types[i], str(types[i]))
        node = dict(type=kind)
        if kind == "kernel":
            node.update(blocks=info[2 * i], threads=info[2 * i + 1])
        elif kind == "memcpy":
            node.update(bytes=info[2 * i])
        nodes.append(node)
    del graph
    return dict(nodes=nodes, edges=[
        "programmatic" if edges[i] == 1 else "default"
        for i in range(min(n_edges.value, n))])


def rotated(fn, xs):
    """A call of ``fn`` on each of ``xs`` in turn, each result held until
    len(xs) calls later: in a CUDA graph of that many calls every call
    reads its own source and writes its own output, so that sources of
    more than the L2 between them are read from HBM on every replay."""
    held = collections.deque(maxlen=len(xs))
    turn = [0]

    def call():
        held.append(fn(xs[turn[0] % len(xs)]))
        turn[0] += 1
    return call


def identity_phases(torch, off, surf, ptxas):
    """T7/T8's copy (phase group 16) on the street's padded tile_offsets
    and sorted_surfel, the probes' sizes. ``identity_gap_split``: in a
    CUDA graph of 20 calls, against ``clone`` in turns (``graph_turns``),
    the first design, an empty kernel on its grid and on <<<1, 32>>>, its
    body on one block and on the fewest blocks of 1,024 threads, the
    redesign, the one-element ``fill_`` of ``launch_floor_ms``; and which
    graph nodes ``clone`` and both designs become. ``identity_path``: the
    probes' own sequence, pad then copy then slice
    (``identity_copy_cuda``, ``identity_copy_stack_cuda``), with each
    design and the plain version (pad, ``clone``, slice), all in turns
    (``graph_rounds``), and the graph nodes and edges of the
    redesign's. ``identity_redesign``: both designs bit for bit
    against each other and the input (what ``clone`` gives) at every
    length of a list, the padded tile_offsets, sorted_surfel and T7's
    stack of sorted_surfel and its reverse; both designs and ``clone`` in
    turns (``graph_rounds``) at the four sizes, the two large ones on as
    many sources and outputs as exceed the L2 four times (``rotated``),
    their share of the byte bound no more than SHARE_OF_BOUND_MAX; ptxas;
    the bound. Returns the kernels-row numbers and the verdict."""
    from streetunveiler_torch import trace
    from streetunveiler_torch.tools import probe_compose4, probe_tax
    trace.reset_launch_counts()
    t_start = time.perf_counter()
    replayed = collections.Counter()
    pad = probe_tax.pad_lanes(off)
    n4 = pad.numel() // 4
    first_blocks = min(-(-n4 // 256), 1024)
    fewest = -(-n4 // 1024)
    one = torch.zeros(1, device="cuda")
    split = dict(
        first_design=lambda: probe_tax.copy_cuda(pad, design="first"),
        empty_first_design_grid=lambda: split_launch(
            torch, "empty", pad, first_blocks, 256),
        empty_1x32=lambda: split_launch(torch, "empty", pad, 1, 32),
        first_body_1x256=lambda: split_launch(
            torch, "first_body", pad, 1, 256),
        **{f"first_body_{fewest}x1024": lambda: split_launch(
            torch, "first_body", pad, fewest, 1024)},
        redesign=lambda: probe_tax.copy_cuda(pad),
        fill_floor=lambda: one.fill_(1.0))
    cand = {}
    for name, fn in split.items():
        kt, ct = graph_turns(torch, fn, pad.clone, replayed)
        cand[name] = dict(ms=turns_summary(kt), clone_ms=turns_summary(ct),
                          median_minus_clone=statistics.median(kt)
                          - statistics.median(ct))
    gap = cand["first_design"]["median_minus_clone"]
    empty_gap = cand["empty_first_design_grid"]["median_minus_clone"]
    nodes = {name: graph_nodes(torch, fn) for name, fn in (
        ("clone", pad.clone), ("first_design", split["first_design"]),
        ("redesign", split["redesign"]))}
    emit("identity_gap_split", values=pad.numel(), bytes=4 * pad.numel(),
         first_design_grid=[first_blocks, 256], candidates=cand,
         graph_nodes=nodes, gap_ms=gap, empty_node_minus_clone_ms=empty_gap,
         gap_is_node_type=empty_gap >= gap,
         redesign_gap_ms=cand["redesign"]["median_minus_clone"],
         note="each candidate and clone replayed in turns (graph_turns: 8 "
              "rounds of candidate, clone, clone, candidate, 20 calls a "
              "graph, ms a call); gap_ms: the first design's median minus "
              "clone's; gap_is_node_type: the empty kernel on the first "
              "design's grid alone is slower than clone by the whole gap; "
              "redesign_gap_ms: the redesign's median minus clone's")

    # ---- the probes' own sequence: the pad's torch.cat before the copy
    n = off.numel()

    def t8(copy):
        return lambda: copy(probe_tax.pad_lanes(off)).view(-1)[:n]

    def t7(copy):
        return lambda: copy(probe_compose4.stack_lanes(off))[0].view(-1)[:n]
    path = {}
    for name, wrap, key, own, plain in (
            ("T8", t8, "identity", probe_tax.identity_copy_cuda,
             probe_tax.identity_copy_plain),
            ("T7", t7, "identity_stack",
             probe_compose4.identity_copy_stack_cuda,
             probe_compose4.identity_copy_stack_plain)):
        t = graph_rounds(torch, dict(
            first_design=wrap(lambda x: probe_tax.copy_cuda(x, key,
                                                            "first")),
            redesign=lambda: own(off), clone=lambda: plain(off)), replayed)
        med = {k: statistics.median(v) for k, v in t.items()}
        path[name] = dict(
            **{k: turns_summary(v) for k, v in t.items()},
            redesign_minus_clone=med["redesign"] - med["clone"],
            first_design_minus_clone=med["first_design"] - med["clone"],
            graph_nodes=graph_nodes(torch, lambda: own(off)))
    emit("identity_path", values=n, path=path,
         note="each function captured as 20 calls in one CUDA graph, the "
              "graphs replayed in the turns first, new, clone, clone, new, "
              "first for 8 rounds (ms a call): T8 pad_lanes (torch.cat), "
              "copy, slice; T7 stack_lanes, copy, unstack; clone the plain "
              "version of each on the card; graph_nodes: the redesign's "
              "sequence, 3 calls")

    # ---- bits: every design against the other and the input
    surf_pad = probe_tax.pad_lanes(surf)
    stack = probe_compose4.stack_lanes(surf, surf.flip(0))
    sizes = dict(tile_offsets=pad,
                 t7_stack_tile_offsets=probe_compose4.stack_lanes(off),
                 sorted_surfel=surf_pad, t7_stack=stack)
    g = torch.Generator(device="cuda").manual_seed(0)
    for m in (1, 2, 3, 4, 5, 76, 77, 1023, 1024, 1025, 4097):
        sizes[f"n_{128 * m}"] = torch.randint(
            -2 ** 31, 2 ** 31 - 1, (128 * m,), dtype=torch.int32,
            device="cuda", generator=g)
    bits, ok = {}, True
    for name, x in sizes.items():
        new = probe_tax.copy_cuda(x, "identity_stack"
                                  if name.startswith("t7") else "identity")
        first = probe_tax.copy_cuda(x, design="first")
        torch.cuda.synchronize()
        bits[name] = dict(redesign_vs_first=torch.equal(new, first),
                          redesign_vs_clone=torch.equal(new, x.clone()),
                          first_vs_clone=torch.equal(first, x))
        ok = ok and all(bits[name].values())
        del new, first

    # ---- both designs and clone in turns, at the probes' sizes; the two
    # large ones rotate over sources and outputs of four times the L2
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 * 2 ** 20)
    sized = {}
    for name in ("tile_offsets", "t7_stack_tile_offsets", "sorted_surfel",
                 "t7_stack"):
        x = sizes[name]
        key = "identity_stack" if name.startswith("t7") else "identity"
        large = x.numel() >= surf_pad.numel()
        xs = [x] + [x.clone() for _ in range(
            min(20, -(-4 * l2 // (4 * x.numel()))) - 1)] if large else [x]
        t = graph_rounds(torch, dict(
            first_design=rotated(
                lambda s: probe_tax.copy_cuda(s, key, "first"), xs),
            redesign=rotated(lambda s: probe_tax.copy_cuda(s, key), xs),
            clone=rotated(lambda s: s.clone(), xs)), replayed)
        nbytes = 2 * 4 * x.numel()
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        med = {k: statistics.median(v) for k, v in t.items()}
        share = {k: bound_ms / v for k, v in med.items()}
        sized[name] = dict(
            values=x.numel(), bytes=nbytes, bound_ms=bound_ms,
            sources=len(xs), source_bytes_in_all=4 * x.numel() * len(xs),
            **{k: turns_summary(v) for k, v in t.items()},
            redesign_no_slower_than_first=med["redesign"]
            <= med["first_design"],
            redesign_no_slower_than_clone=med["redesign"] <= med["clone"],
            share_of_bound=share)
        if large and max(share.values()) > SHARE_OF_BOUND_MAX:
            ok = False
        del xs, t
    regs = {k: ptxas.get(k) for k in ("T7/T8 copy<256>", "T7/T8 copy sm90",
                                      "T7/T8 copy<1024>", "T7/T8 empty")}
    torch.cuda.synchronize()
    launches = {k: trace.launch_counts[k] + replayed[k]
                for k in ("identity", "identity_stack")}
    emit("identity_redesign", bit_exact=bits, sizes=sized, ptxas=regs,
         l2_bytes=l2, share_of_bound_max=SHARE_OF_BOUND_MAX,
         tool_launches=launches, seconds=time.perf_counter() - t_start,
         within_tolerance=ok,
         note="both designs and clone captured as 20 calls a CUDA graph "
              "each, replayed in the turns first, new, clone, clone, new, "
              "first for 8 rounds (ms a call); sorted_surfel and t7_stack: "
              "each call of a graph on its own source and output (sources: "
              "how many, of four times the L2 in all or 20), so that every "
              "replay reads them from HBM; bound: the values read and "
              "written once over the HBM rate; share_of_bound: bound over "
              "median, above share_of_bound_max at a large size fails the "
              "phase; t7_stack: sorted_surfel and its reverse, one launch; "
              "t7_stack_tile_offsets: the stack of tile_offsets alone, as "
              "the probes' path copies it")
    return dict(ok=ok, launches=launches,
                t8=dict(ms_first_design=sized["tile_offsets"][
                    "first_design"]["median"]),
                t7=dict(ms_first_design=sized["t7_stack_tile_offsets"][
                    "first_design"]["median"]))


# ---- 17. the render and unveil paths (streetunveiler_torch.cli.render,
# .cli.unveil, mesh, pipeline/): the CLIs on the synthetic street, then
# the render CLI's view, the TSDF fusion and the delta re-optimization at
# full width
# the reference's clustering and neighbourhood radii (7e-2, 4e-2, 2e-2,
# normalized scene units) scaled by about 20 to the synthetic street,
# whose 4,000 points lie a few tenths of a unit apart: at 4e-2 no surfel
# but the removed ones would be trainable
UNVEIL_FLAGS = ["--cluster_threshold", "1.5", "--min_cluster_size", "10",
                "--key_stride", "2", "--trainable_dist", "0.8",
                "--editable_dist", "0.4"]
UNVEIL_REOPT = 10         # delta steps per key frame pair on the CLI
MESH_RES = 512
PATH_KERNELS = ("expand", "blend_fwd", "blend_bwd", "blend_fwd_gated",
                "blend_bwd_gated", "record_scatter", "cull")


def path_launches(trace):
    return {k: trace.launch_counts[k] for k in PATH_KERNELS}


def render_cli_synthetic(torch, model_dir, label, train_test_psnr=None,
                         unveiled_round=None):
    """``cli.render --semantics`` on the training CLI's model dir: every
    PNG written, finite PSNRs, a non-empty mesh before and after the
    cluster filter, K1 and K3 launched. ``train_test_psnr``: the training
    CLI's held-out PSNR of the same state and sky, which the render's test
    split must repeat (within 0.01 dB: another capacity and PLY order);
    ``unveiled_round``: the round whose checkpoint it must render."""
    import numpy as np
    from streetunveiler_torch.cli import render as cli_render
    from streetunveiler_torch import trace
    trace.reset_launch_counts()
    t0 = time.perf_counter()
    s = cli_render.main(["--model_path", model_dir, "--semantics",
                         "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_launches(trace)
    it_dir = f"ours_{s['iteration']}"
    missing = []
    for split in ("train", "test"):
        for sub in ("renders", "gt", "depth", "normal", "semantic"):
            d = os.path.join(model_dir, split, it_dir, sub)
            n = len(os.listdir(d)) if os.path.isdir(d) else 0
            if n != s[f"{split}_views"]:
                missing.append(f"{split}/{sub}: {n}")
    for name in ("fuse.ply", "fuse_post.ply"):
        if not os.path.exists(os.path.join(model_dir, "train", it_dir,
                                           name)):
            missing.append(name)
    psnr_ok = all(np.isfinite(s[k]) for k in ("train_psnr", "test_psnr"))
    repeat = (None if train_test_psnr is None
              else abs(s["test_psnr"] - train_test_psnr))
    picked = s["unveiled"]
    round_ok = (picked is None if unveiled_round is None else
                picked is not None and f"instance_workspace_{unveiled_round}"
                in picked)
    ok = (not missing and psnr_ok and s["mesh_faces"] > 0
          and s["post_faces"] > 0 and (repeat is None or repeat <= 0.01)
          and round_ok and launches["expand"] > 0
          and launches["blend_fwd"] > 0)
    emit(label, wall_s=wall, missing=missing, **{
        k: s[k] for k in ("iteration", "unveiled", "duplicate_capacity",
                          "train_psnr", "test_psnr", "train_views",
                          "test_views", "voxel_size", "mesh_vertices",
                          "mesh_faces", "post_vertices", "post_faces",
                          "fusion_s", "surface_nets_s", "clusters_s")},
         train_cli_test_psnr=train_test_psnr, test_psnr_gap=repeat,
         launches=launches)
    if not ok:
        raise AssertionError(f"{label}: a file is missing, a PSNR is not "
                             "finite or differs from the training CLI's, "
                             "the mesh is empty, the wrong checkpoint was "
                             "rendered, or K1/K3 did not launch")
    return launches


def unveil_cli_synthetic(torch, model_dir):
    """``cli.unveil --semantic_class vehicle --all --inpainter diffuse`` on
    the training CLI's model dir: surfels removed, surfels trained beside
    them and some of their deltas moved, masks with pixels, finite losses,
    the unveiled PLY with the unveiled state's surfels, the final renders,
    K1, K2 and K3 launched."""
    import numpy as np
    from streetunveiler_torch.cli import unveil as cli_unveil
    from streetunveiler_torch import trace
    from streetunveiler_torch.utils.ply import load_surfel_ply
    trace.reset_launch_counts()
    t0 = time.perf_counter()
    s = cli_unveil.main(["--model_path", model_dir, "--semantic_class",
                         "vehicle", "--all", "--inpainter", "diffuse",
                         "--reopt_iterations", str(UNVEIL_REOPT),
                         "--device", "cuda"] + UNVEIL_FLAGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_launches(trace)
    ply = os.path.join(s["workspace"], "checkpoint", "point_cloud.ply")
    n_ply = load_surfel_ply(ply)["xyz"].shape[0] if os.path.exists(ply) \
        else 0
    renders = len(os.listdir(os.path.join(s["workspace"], "final_renders")))
    finite = bool(np.isfinite(s["losses"]).all())
    ok = (s["round"] == 1 and s["removed"] > 0 and s["trained"] > 0
          and s["moved"] > 0 and sum(s["mask_pixels"].values()) > 0 and s["losses"] and finite
          and n_ply == s["alive"] and renders > 0
          and all(launches[k] > 0 for k in ("expand", "blend_fwd",
                                            "blend_bwd")))
    emit("unveil_cli_synthetic", wall_s=wall, flags=UNVEIL_FLAGS,
         reopt_iterations=UNVEIL_REOPT, removed=s["removed"],
         trainable=s["trainable"], trained=s["trained"], moved=s["moved"],
         clusters=s["clusters"], solid=s["solid"],
         mask_pixels=s["mask_pixels"],
         inpainted_frames=s["inpainted_frames"], losses=s["losses"],
         final_loss=s["losses"][-1] if s["losses"] else None,
         alive=s["alive"], ply_surfels=n_ply, final_renders=renders,
         launches=launches)
    if not ok:
        raise AssertionError("the unveil CLI removed nothing, trained or "
                             "moved no surfel, made empty masks, a "
                             "non-finite loss or no checkpoint, or did not "
                             "launch K1/K2/K3")
    return launches


def street_cameras(cam, n=4, step=2.0):
    """``n`` copies of ``cam`` stepped ``step`` scene units along the
    street (+z), the first ``cam`` itself."""
    import dataclasses
    cams = []
    for k in range(n):
        w2c = cam.w2c.clone()
        w2c[2, 3] -= step * k
        cams.append(dataclasses.replace(cam, w2c=w2c))
    return cams


def render_full_width(torch, state, cam, cap):
    """The render CLI's view (``cli.render.render_view``: render, the sky
    from seed 0, world normals, semantics) on the street at 1920×1280,
    3 warm-up and 12 timed frames and a profile; then a TSDF fusion of 4
    street cameras at ``mesh_res`` 512 through the render CLI's calls,
    ``fuse_views`` (its renders and integration; timed, and profiled for
    the kernels' split), ``volume_mesh`` (``surface_nets``) and
    ``keep_large_clusters`` timed apart."""
    import numpy as np
    from streetunveiler_torch import renderer
    from streetunveiler_torch.cli.render import render_view
    from streetunveiler_torch.mesh import (estimate_bounds, fuse_views,
                                           keep_large_clusters, volume_mesh)
    from streetunveiler_torch.models.sky import init_sky
    from streetunveiler_torch import trace
    sky = init_sky(torch.Generator().manual_seed(0), device="cuda")
    bg = torch.zeros(3, device="cuda")

    def frame():
        return render_view(cam, state, bg, sky, cap, True, "cuda")
    trace.reset_launch_counts()
    img, depth, nrm, sem = frame()
    torch.cuda.synchronize()
    launches = path_launches(trace)
    finite = all(bool(torch.isfinite(t).all())
                 for t in (img, depth, nrm, sem))
    hw = (cam.height, cam.width)
    shapes = tuple(img.shape) == hw + (3,) and tuple(sem.shape) == hw + (6,)
    for _ in range(3):
        frame()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = host_ms(torch, frame, 12)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    emit("render_full_width", frame_ms_median=statistics.median(times),
         frame_ms_all=times, rays_per_s=hw[0] * hw[1]
         / (statistics.median(times) / 1e3),
         launches_per_frame=launches, finite=finite, shapes_ok=shapes,
         peak_mem_gib=peak, sky_alpha_mean=float(
             (1.0 - renderer.render(cam, state, bg, duplicate_capacity=cap,
                                    device="cuda").rend_alpha).mean()),
         note="frame = cli.render.render_view: render + sky + world normals "
              "+ render_semantic (nq 9), host clock between "
              "synchronisations")
    emit("render_full_width_profile", **profile_frames(torch, frame, 3))
    if not (finite and shapes and launches["expand"] >= 2
            and launches["blend_fwd"] >= 2):
        raise AssertionError("the render CLI's full-width view is not "
                             "finite, has the wrong shape, or did not "
                             "launch K1/K3 for both blends")

    # ---- TSDF fusion of 4 street views at mesh_res 512, through the
    # render CLI's calls: fuse_views, volume_mesh, keep_large_clusters
    cams = street_cameras(cam)
    tcap = renderer.measure_duplicate_capacity(cams, state, device="cuda")
    lo, hi = estimate_bounds(state)
    voxel = float((hi - lo).max() / MESH_RES)

    def fuse():
        return fuse_views(cams, state, bg=bg, voxel_size=voxel,
                          duplicate_capacity=tcap, device="cuda")
    trace.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vol = fuse()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tsdf_launches = path_launches(trace)
    voxels = vol.tsdf.numel()
    vol_dims = tuple(vol.tsdf.shape)
    observed = int((vol.weight > 0).sum())
    verts, faces, colors = volume_mesh(vol)
    t2 = time.perf_counter()
    pv, pf, _ = keep_large_clusters(verts, faces, colors, 0.02)
    t3 = time.perf_counter()
    del vol
    prof = profile_frames(torch, fuse, 1)
    ok = (faces.shape[0] > 0 and pf.shape[0] > 0 and observed > 0
          and bool(np.isfinite(verts).all()) and tsdf_launches["expand"] >= 4
          and tsdf_launches["blend_fwd"] >= 4)
    emit("tsdf_full_width", views=len(cams), mesh_res=MESH_RES,
         voxel_size=voxel, dims=list(vol_dims),
         voxels=voxels, observed_voxels=observed, duplicate_capacity=tcap,
         fuse_views_ms=(t1 - t0) * 1e3, surface_nets_ms=(t2 - t1) * 1e3,
         keep_large_clusters_ms=(t3 - t2) * 1e3, vertices=verts.shape[0],
         faces=faces.shape[0], post_vertices=pv.shape[0],
         post_faces=pf.shape[0], launches=tsdf_launches,
         note="fuse_views_ms: mesh.fuse_views whole (the 4 renders and "
              "their integration on the card); surface_nets and "
              "keep_large_clusters on the host; host clock")
    emit("tsdf_full_width_profile", **prof)
    if not ok:
        raise AssertionError("the full-width TSDF fusion gave an empty or "
                             "non-finite mesh, or did not launch K1/K3")
    return dict(render=launches, tsdf=tsdf_launches)


def reoptimize_full_width(torch, state, cam, cap):
    """The delta re-optimization on the street at 1920×1280: its vehicle
    class (5) clustered (the radius from the points' spacing), every solid
    cluster removed, the neighbourhood radii scaled from the reference's
    normalized units by the street's extent (what ``cli.unveil
    --trainable_dist --editable_dist`` set); removal masks and the
    background-only renders on 4 cameras stepped along the street, the
    ground truth the perturbed copy's render (``ground_truth``), the holes
    filled by the diffuse inpainter on the card; then ``reoptimize_step``
    over the 4 targets: one step with the launch counts read around it,
    3 warm-up and 12 timed steps, a profile, peak memory; the loss finite
    and every delta outside the train mask exactly 0."""
    import dataclasses

    import numpy as np
    from streetunveiler_torch import renderer
    from streetunveiler_torch.config import ReOptimizationParams
    from streetunveiler_torch.models.deltas import zero_deltas
    from streetunveiler_torch.models.gaussians import prune_mask
    from streetunveiler_torch import trace
    from streetunveiler_torch.pipeline import masks as pmasks
    from streetunveiler_torch.pipeline.inpaint import DiffuseFillInpainter
    from streetunveiler_torch.pipeline.reoptimize import reoptimize_step
    from streetunveiler_torch.pipeline.select import (
        cluster_semantic_instance, removal_mask_for_instances)
    from streetunveiler_torch.train.optim import adam_init
    from streetunveiler_torch.utils.semantics import VEHICLE_BIT
    t0 = time.perf_counter()
    cl = cluster_semantic_instance(state, VEHICLE_BIT, threshold=None)
    removal = removal_mask_for_instances(cl, [], all_solid=True)
    t1 = time.perf_counter()
    extent = float(state.spatial_scale)
    masks = pmasks.include_neighbor_pcd(
        state, removal, editable_dist=pmasks.EDITABLE_DIST * extent,
        trainable_dist=pmasks.TRAINABLE_DIST * extent)
    t2 = time.perf_counter()
    cams = street_cameras(cam)
    rcap = max(cap, renderer.measure_duplicate_capacity(cams, state,
                                                        device="cuda"))
    inpainter = DiffuseFillInpainter(device="cuda")
    targets, mask_px, inpaint_ms = [], [], []
    for c in cams:
        bg, gt, _ = ground_truth(torch, state, c, rcap)
        cond = pmasks.removal_mask_for_frame(c, state, masks.removed, bg,
                                             duplicate_capacity=rcap,
                                             device="cuda")
        m = cond["mask"].cpu().numpy()
        torch.cuda.synchronize()
        ti = time.perf_counter()
        inp = inpainter.inpaint(cond["rgb_without"].cpu().numpy(), m)
        inpaint_ms.append((time.perf_counter() - ti) * 1e3)
        mt = torch.as_tensor(m, device="cuda")[..., None]
        targets.append(torch.where(mt, torch.as_tensor(inp, device="cuda"),
                                   gt))
        mask_px.append(int(m.sum()))
    removed = torch.as_tensor(masks.removed, device="cuda")
    train_mask = torch.as_tensor(masks.trainable, device="cuda") & ~removed
    base = prune_mask(state, removed)
    deltas = zero_deltas(base.params)
    opt_state = adam_init(deltas)
    opt = ReOptimizationParams()
    it = [0]

    def step():
        nonlocal deltas, opt_state
        i = it[0]
        it[0] += 1
        deltas, opt_state, loss = reoptimize_step(
            base, deltas, opt_state, train_mask, cams[i % 4],
            targets[i % 4], bg, i + 1, opt, duplicate_capacity=rcap)
        return loss
    trace.reset_launch_counts()
    loss0 = float(step())
    torch.cuda.synchronize()
    launches = path_launches(trace)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    times = host_ms(torch, lambda: losses.append(step()), 12)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [loss0] + [float(x) for x in losses]
    prof = profile_frames(torch, step, 3)
    outside = ~train_mask
    zero_outside = all(bool((getattr(deltas, f.name)[outside] == 0).all())
                       for f in dataclasses.fields(deltas))
    moved = int((deltas.xyz[train_mask] != 0).any(dim=1).sum())
    finite = bool(np.isfinite(losses).all())
    ok = (finite and zero_outside and moved > 0 and sum(mask_px) > 0
          and all(launches[k] >= 1 for k in ("expand", "blend_fwd",
                                             "blend_bwd")))
    emit("reoptimize_full_width", clusters=len(cl.cluster_sizes),
         cluster_sizes=[int(x) for x in cl.cluster_sizes[:8]],
         removed=int(masks.removed.sum()),
         editable=int(masks.editable.sum()),
         trainable=int(masks.trainable.sum()),
         train_mask=int(train_mask.sum()), radius_scale=extent,
         mask_pixels=mask_px, inpaint_ms=inpaint_ms,
         cluster_s=t1 - t0, neighbours_s=t2 - t1, duplicate_capacity=rcap,
         launches_per_step=launches, step_ms_median=statistics.median(times),
         step_ms_all=times, losses=losses, loss_finite=finite,
         deltas_zero_outside_train_mask=zero_outside,
         surfels_moved=moved, peak_mem_gib=peak,
         note="step = reoptimize_step: apply_deltas, render (K3, K1), "
              "L1 + distortion + normal, backward (K2, record scatter, "
              "preprocess), Adam on the deltas; host clock between "
              "synchronisations")
    emit("reoptimize_full_width_profile", **prof)
    if not ok:
        raise AssertionError("the full-width re-optimization gave a "
                             "non-finite loss, moved a delta outside the "
                             "train mask or none inside, made empty masks, "
                             "or did not launch K1/K2/K3")
    return launches


def render_unveil_phases(torch, state, cam, cap):
    """Phase group 17: the training CLI's late run kept in a model dir for
    the render CLI, the unveil CLI and the render CLI again (which must
    pick up round 1), then the render CLI's view, the TSDF fusion and the
    re-optimization step at full width. Returns the launches of each
    path."""
    from streetunveiler_torch.ops.rasterizer import cuda_lib
    out = {}
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_lib.BUILD_DIR) as model_dir:
        late = train_scene_synthetic(torch, late=True, model_dir=model_dir)
        out["render_cli_synthetic"] = render_cli_synthetic(
            torch, model_dir, "render_cli_synthetic",
            train_test_psnr=late["test_psnr"])
        out["unveil_cli_synthetic"] = unveil_cli_synthetic(torch, model_dir)
        out["render_cli_synthetic_unveiled"] = render_cli_synthetic(
            torch, model_dir, "render_cli_synthetic_unveiled",
            unveiled_round=1)
    fw = render_full_width(torch, state, cam, cap)
    out["render_full_width"] = fw["render"]
    out["tsdf_full_width"] = fw["tsdf"]
    out["reoptimize_full_width_step"] = reoptimize_full_width(torch, state,
                                                              cam, cap)
    return out


# ---- 18. the data layer: a Waymo-layout segment written from the street
# scene, read back through the port's reader (colorization and the voxel
# downsample on the card), then the training CLI on it
DATA_FRAMES = 50          # a Waymo segment has about 198
DATA_RAYS = 150_000       # LiDAR rays a frame, each to a surfel centre
DATA_MAX_POINTS = 5_000_000   # driving.assemble_driving_scene's cap
DATA_VOXEL = 0.15             # the readers' voxel size
DATA_CHECK_FRAMES = 10    # frames of the colorization's CPU check
DATA_ITERS = 30
DATA_EVAL_VIEWS = 8


def host_stage(torch, fn):
    """(result, host ms) of ``fn`` between synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def same_bits(a, b):
    """Two tuples of numpy arrays hold the same dtypes, shapes and bytes."""
    return all(x.dtype == y.dtype and x.shape == y.shape
               and x.tobytes() == y.tobytes() for x, y in zip(a, b))


def timed_calls(module, names, totals):
    """Replace each of ``names`` in ``module`` by a wrapper that adds its
    host milliseconds to ``totals[name]``; returns the restoring call."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                totals[name] = (totals.get(name, 0.0)
                                + (time.perf_counter() - t0) * 1e3)
        return timed
    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    return lambda: [setattr(module, n, fn) for n, fn in saved.items()]


def data_read(torch, root, colmap, smi):
    """``read_waymo_info`` on the segment, stage by stage (the reader's own
    functions, in its order) on the host clock: the files (split into
    ``scenario.pt``, the image decodes, the mask reads and the rest: the
    poses and the LiDAR files), the cap, the
    colorization and the voxel downsample (card), then ``Scene`` and
    ``create_state`` (the host KD-tree); the card's busy time of the two
    card stages from a second, profiled run of each; the point counts
    after each stage; then the whole ``read_waymo_info`` call, which must
    give the stages' cloud bit for bit. Then the card against the CPU:
    the colorization of the capped cloud in the first
    ``DATA_CHECK_FRAMES`` frames and the voxel downsample of the whole
    coloured cloud, bit for bit, and the profiled runs against the timed
    ones. Returns the scene and its initial state."""
    from streetunveiler_torch.scene import readers
    from streetunveiler_torch.scene.readers import driving, projection, waymo
    from streetunveiler_torch.scene.scene import Scene
    from streetunveiler_torch.utils.pcd import voxel_down_sample
    files_split = {}
    restore = timed_calls(waymo, ("_load_scenario", "read_rgb",
                                  "load_semantic_npz"), files_split)
    try:
        (cams, lidar, frame_dict), files_ms = host_stage(
            torch, lambda: waymo.read_waymo_inputs(root, colmap))
    finally:
        restore()
    files_split = dict(scenario=files_split["_load_scenario"],
                       images=files_split["read_rgb"],
                       masks=files_split["load_semantic_npz"])
    files_split["poses_and_lidar"] = files_ms - sum(files_split.values())
    pts, cap_ms = host_stage(
        torch, lambda: driving.cap_points(lidar, DATA_MAX_POINTS))
    frames = driving.camera_frames(cams)
    colorize = lambda: driving.labelled_cloud(pts, frames, device="cuda")
    voxel = lambda: voxel_down_sample(pc, DATA_VOXEL, device="cuda")
    pc, colorize_ms = host_stage(torch, colorize)
    vox, voxel_ms = host_stage(torch, voxel)
    runs = []
    colorize_prof = profile_frames(torch, lambda: runs.append(colorize()), 1)
    voxel_prof = profile_frames(torch, lambda: runs.append(voxel()), 1)
    card_runs_equal = same_bits(runs[0], pc) and same_bits(runs[1], vox)

    info, whole_ms = host_stage(
        torch, lambda: readers.read_waymo_info(root, colmap, device="cuda"))
    whole_equal = same_bits(info.point_cloud, vox)
    scene, scene_ms = host_stage(
        torch, lambda: Scene(info, resolution=1, device="cuda"))
    state, state_ms = host_stage(torch, scene.create_state)
    emit("data_read", card=smi, stages_ms=dict(
        files=files_ms, cap=cap_ms, colorize=colorize_ms, voxel=voxel_ms,
        scene=scene_ms, create_state=state_ms),
        files_split_ms=files_split,
        card_busy_ms=dict(
            colorize=colorize_prof["device_busy_ms_per_frame"],
            voxel=voxel_prof["device_busy_ms_per_frame"]),
        card_ops=dict(colorize=colorize_prof["device_ops_per_frame"],
                      voxel=voxel_prof["device_ops_per_frame"]),
        read_waymo_info_ms=whole_ms, read_waymo_info_equal=whole_equal,
        points=dict(lidar_valid=len(lidar), capped=len(pts),
                    labelled=len(pc.points), voxels=len(vox.points),
                    surfels=int(state.num_alive)),
        capacity=state.capacity,
        camera_frames=len(frames), frame_dict=frame_dict,
        voxel_size=DATA_VOXEL, max_points=DATA_MAX_POINTS)

    sub = frames[:DATA_CHECK_FRAMES]
    col = [projection.colorize_points_from_frames(pts, sub, device=d)
           for d in ("cuda", "cuda", "cpu")]
    vox_cpu = voxel_down_sample(pc, DATA_VOXEL, device="cpu")
    checks = dict(colorize_card_vs_cpu=same_bits(col[0], col[2]),
                  colorize_card_twice=same_bits(col[0], col[1]),
                  voxel_card_vs_cpu=same_bits(vox, vox_cpu),
                  card_runs_equal=card_runs_equal,
                  read_waymo_info_equal=whole_equal)
    emit("data_device_vs_cpu", card=smi, **checks,
         check_frames=len(sub), colorized_points=len(pts),
         seen_in_check_frames=int(col[0][2].sum()),
         voxel_input_points=len(pc.points), voxels=len(vox.points))
    if not all(checks.values()):
        raise AssertionError(f"the data layer's card and CPU runs differ: "
                             f"{checks}")
    data_zits_batch(torch, frames, smi)
    return scene, state


def data_zits_batch(torch, frames, smi):
    """The ZITS++ adapter's math on the card against its CPU run, on the
    segment's frame with the most vehicle pixels, the vehicles as the
    hole: ``prepare_batch`` at test size 512 with the gradients (the
    positional encoding's dilations on the 256 grid, the Sobel maps) bit
    for bit, twice; ``edge_nms`` and ``sharpen`` on a soft edge map made
    from its gradients, NMS bit for bit and ``sharpen`` within 1e-6 (the
    CPU tests' tolerance against the JAX package)."""
    from streetunveiler_torch.pipeline import zits
    from streetunveiler_torch.utils.semantics import CONCERNED_IND
    veh = [int((f["semantic"] == CONCERNED_IND["vehicle"]).sum())
           for f in frames]
    pick = max(range(len(frames)), key=veh.__getitem__)
    image = frames[pick]["image"]
    mask = frames[pick]["semantic"] == CONCERNED_IND["vehicle"]
    prep = lambda d: zits.prepare_batch(image, mask, test_size=512,
                                        use_gradient=True, device=d)
    cpu = prep("cpu")
    card, card_ms = host_stage(torch, lambda: prep("cuda"))
    card2 = prep("cuda")
    keys = [k for k, v in cpu.items() if hasattr(v, "dtype")]
    host = lambda b, k: b[k].cpu().numpy()
    batch_equal = all(same_bits((host(card, k), host(card2, k)),
                                (host(cpu, k), host(cpu, k)))
                      for k in keys)
    edge = torch.clamp(torch.hypot(cpu["gradientx"], cpu["gradienty"])
                       / 1020.0, 0.0, 1.0)[0, 0]
    nms = [zits.edge_nms(edge.to(d)).cpu().numpy() for d in ("cuda", "cpu")]
    sharp = [zits.sharpen(edge.to(d) * 8.0 - 4.0).cpu().numpy()
             for d in ("cuda", "cpu")]
    sharpen_err = float(abs(sharp[0] - sharp[1]).max())
    checks = dict(prepare_batch_equal=batch_equal,
                  edge_nms_equal=same_bits([nms[0]], [nms[1]]),
                  sharpen_within_1e6=sharpen_err <= 1e-6)
    emit("data_zits_batch", card=smi, **checks, frame=pick,
         hole_pixels=int(mask.sum()), image_hw=list(image.shape[:2]),
         tensors=keys, max_abs_pos=int(cpu["abs_pos"].max()),
         nms_pixels=int(nms[1].sum()),
         nms_pixels_differing=int((nms[0] != nms[1]).sum()),
         sharpen_max_abs_err=sharpen_err, card_ms=card_ms)
    if not all(checks.values()):
        raise AssertionError(f"the ZITS++ adapter's card and CPU runs "
                             f"differ: {checks}")


def data_train_cli(torch, root, colmap, scene, state0, smi):
    """``cli.train --scene waymo --semantics`` on the segment at 1920x1280
    for ``DATA_ITERS`` iterations, in process: the median step (the
    loop's per-iteration windows, each ended by a synchronization, so a
    window holds its step's device work), the card's busy and idle shares
    over 3
    more steps of the trained state (one on each rig camera), the surfel
    count, the K1/K2/K3 launches, and the
    PSNR of ``DATA_EVAL_VIEWS`` training views spread over the rig before
    and after. Fails unless every loss is finite and that PSNR rises.
    Returns the launches."""
    import numpy as np
    from streetunveiler_torch.cli import train as cli_train
    from streetunveiler_torch.config import OptimizationParams
    from streetunveiler_torch import trace
    from streetunveiler_torch.ops.rasterizer import cuda_lib
    from streetunveiler_torch.train.loop import evaluate_views
    from streetunveiler_torch.train.step import (bin_step, init_optimizer,
                                                 train_step)
    pick = np.linspace(0, len(scene.train_cameras) - 1,
                       DATA_EVAL_VIEWS).astype(int)
    views = ([scene.train_cameras[i] for i in pick],
             [scene.train_images[i] for i in pick])
    bg = torch.zeros(3, device="cuda")
    psnr0, _ = evaluate_views(state0, *views, bg, max_views=DATA_EVAL_VIEWS)
    trace.reset_launch_counts()
    with tempfile.TemporaryDirectory(dir=cuda_lib.BUILD_DIR) as model_dir:
        t0 = time.perf_counter()
        state, reports = cli_train.main([
            "--scene", "waymo", "--source_path", root, "--colmap_path",
            colmap, "--model_path", model_dir, "--semantics",
            "--iterations", str(DATA_ITERS), "--eval_every", "0",
            "--log_every", "1", "--resolution", "1", "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = path_launches(trace)
    psnr1, _ = evaluate_views(state, *views, bg, max_views=DATA_EVAL_VIEWS)
    # the first window holds the capacity probe, the last the PLY's save
    step_ms = [1e3 / r.iters_per_s for r in reports[1:-1]]
    losses = [r.loss for r in reports]

    # one more step on each rig camera at the middle frame, in turn
    opt = OptimizationParams()
    ost = init_optimizer(state)
    rig = [len(scene.train_cameras) // 3 * k + DATA_FRAMES // 2
           for k in range(3)]
    inputs = [(scene.train_cameras[i],
               torch.as_tensor(scene.train_images[i], device="cuda"),
               torch.as_tensor(scene.train_semantics[i], device="cuda"))
              for i in rig]
    cap = reports[-1].dup_capacity
    it = [DATA_ITERS]

    def step():
        nonlocal state, ost
        cam, gt, gt_sem = inputs[it[0] % 3]
        it[0] += 1
        b = bin_step(state, cam, duplicate_capacity=cap, device="cuda")
        state, ost, _, _, _ = train_step(
            state, ost, cam, gt, bg, it[0], opt, gt_semantic=gt_sem,
            duplicate_capacity=cap, binning=b, device="cuda")
    for _ in range(3):
        step()
    prof = profile_frames(torch, step, 3)
    ok = (bool(np.isfinite(losses).all()) and psnr1 > psnr0
          and all(launches[k] > 0 for k in ("expand", "blend_fwd",
                                            "blend_bwd")))
    emit("data_train_cli", card=smi, iterations=DATA_ITERS,
         width=W, height=H, train_views=len(scene.train_cameras),
         step_ms_median=statistics.median(step_ms), step_ms_all=step_ms,
         step_median_over_busy=(statistics.median(step_ms)
                                / prof["device_busy_ms_per_frame"]),
         card_busy_ms_per_step=prof["device_busy_ms_per_frame"],
         card_idle_share=prof["device_idle_share"],
         wall_ms_per_profiled_step=prof["wall_ms_per_frame"],
         device_ops_per_step=prof["device_ops_per_frame"],
         profiled_views=rig, top_kernels=prof["top_kernels"][:6],
         init_surfels=int(state0.num_alive), surfels=reports[-1].n_alive,
         capacity=state.capacity, duplicate_capacity=cap,
         train_views_psnr_before=psnr0, train_views_psnr_after=psnr1,
         eval_views=pick.tolist(), loss_first=losses[0],
         loss_last=losses[-1], losses_finite=bool(np.isfinite(losses).all()),
         cli_wall_s=wall, launches=launches)
    if not ok:
        raise AssertionError("the training CLI on the Waymo segment gave a "
                             "non-finite loss, did not raise the training "
                             "views' PSNR, or did not launch K1/K2/K3")
    return launches


def data_phases(torch, state, smi):
    """Phase group 18: the segment written from ``state`` (the street as
    built) into a temporary directory by ``tools/waymo_segment.py``, read
    back by stages and checked against the CPU, then trained on by the
    CLI. Returns the CLI's launches."""
    from streetunveiler_torch.ops.rasterizer import cuda_lib
    from streetunveiler_torch.tools import waymo_segment
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_lib.BUILD_DIR) as tmp:
        root = os.path.join(tmp, "segment")
        colmap = os.path.join(tmp, "segment_colmap")
        reduced = {
            "frames": f"{DATA_FRAMES} of a segment's about 198",
            "cameras": "the reader's three front cameras",
            "images": "renders of the 300,000-surfel street scene at "
                      f"{W}x{H}, not photographs",
            "semantic_masks": "the semantic render's argmax, one "
                              "Cityscapes id a class, not a segmenter's "
                              "output",
            "lidar": f"{DATA_RAYS} rays a frame from the sensor to surfel "
                     f"centres, {waymo_segment.INVALID} of them with range "
                     "0",
            "colmap": "no COLMAP model, so no alignment step"}
        emit("data_segment", card=smi, reduced=reduced,
             **waymo_segment.write_segment(
                 state, root, colmap, DATA_FRAMES, DATA_RAYS, W, H, FOCAL,
                 device="cuda"))
        scene, state0 = data_read(torch, root, colmap, smi)
        return data_train_cli(torch, root, colmap, scene, state0, smi)


# ---- 19. the evaluation networks (LPIPS-VGG, the FID InceptionV3) on the
# card against the same modules on the CPU, at config 2's 800x600
EVAL_H, EVAL_W = 600, 800
EVAL_REL_TOL = 1e-4     # largest |card − CPU| over the CPU's largest |value|
EVAL_DIST_RTOL, EVAL_DIST_ATOL = 1e-4, 1e-5   # the LPIPS distance


def eval_phases(torch, smi):
    """Phase group 19: random-init LPIPS and Inception weights (the
    end-to-end tool's, ``np.random.default_rng(0)``) written through the
    weight writer; one seeded pair of 600x800 images through both networks
    on the card and on the CPU; the errors and the card's time a pair."""
    import numpy as np
    from streetunveiler_torch.evaluation import inception, lpips
    from streetunveiler_torch.ops.rasterizer import cuda_lib
    from streetunveiler_torch.device import strict_fp32
    from streetunveiler_torch.tools.e2e_config2 import make_eval_weights
    strict_fp32()
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (EVAL_H, EVAL_W, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_lib.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        lp_npz, inc_npz = make_eval_weights(tmp)
        weights_s = time.perf_counter() - t0
        nets = {dev: (lpips.load_lpips_weights(lp_npz, dev),
                      inception.load_inception_weights(inc_npz, dev))
                for dev in ("cuda", "cpu")}

    def nchw(img, dev):
        return torch.as_tensor(img, device=dev).permute(2, 0, 1)[None]

    def rel(got, want):
        got, want = got.detach().cpu().double(), want.detach().double()
        return float((got - want).abs().max()
                     / max(float(want.abs().max()), 1e-30))

    with torch.no_grad():
        taps = {dev: nets[dev][0].features(nchw(a, dev))
                for dev in ("cuda", "cpu")}
        dist = {dev: float(lpips.lpips_pair(nets[dev][0], a, b))
                for dev in ("cuda", "cpu")}
        pool3 = {dev: inception.inception_pool3(nets[dev][1], a[None])
                 for dev in ("cuda", "cpu")}
    tap_rel = [rel(g, c) for g, c in zip(taps["cuda"], taps["cpu"])]
    pool3_rel = rel(pool3["cuda"], pool3["cpu"])
    dist_err = abs(dist["cuda"] - dist["cpu"])
    ok = (max(tap_rel) <= EVAL_REL_TOL and pool3_rel <= EVAL_REL_TOL
          and dist_err <= EVAL_DIST_RTOL * abs(dist["cpu"]) + EVAL_DIST_ATOL
          and dist["cpu"] > 0
          and bool(torch.isfinite(pool3["cuda"]).all()))
    ta, tb = nchw(a, "cuda"), nchw(b, "cuda")
    x299 = torch.as_tensor(a[None], device="cuda")
    with torch.no_grad():
        lpips_ms = cuda_ms(torch, lambda: nets["cuda"][0].distance(ta, tb),
                           5)
        inception_ms = cuda_ms(torch, lambda: nets["cuda"][1](x299), 5)
    emit("eval_networks", card=smi, image=[EVAL_H, EVAL_W],
         lpips_cuda=dist["cuda"], lpips_cpu=dist["cpu"],
         lpips_abs_err=dist_err, lpips_tap_rel_err=tap_rel,
         pool3_rel_err=pool3_rel,
         pool3_shape=list(pool3["cuda"].shape),
         lpips_pair_ms=lpips_ms, inception_image_ms=inception_ms,
         weights_s=weights_s, within_tolerance=ok,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         tolerance=dict(rel=EVAL_REL_TOL, dist_rtol=EVAL_DIST_RTOL,
                        dist_atol=EVAL_DIST_ATOL),
         note="rel: the largest |card - CPU| over the CPU's largest "
              "|value| (each LPIPS tap, pool3); the Inception input "
              "downsamples to 299 with antialiasing; times: CUDA events "
              "over 5 back-to-back calls (one LPIPS pair: both images' "
              "taps and the heads; one Inception image)")
    if not ok:
        raise AssertionError("an evaluation network on the card disagrees "
                             "with the CPU")


# ---- 20. the end-to-end run at BASELINE config 2 through the port's CLIs
E2E_PROFILE_STEPS = 3


def e2e_phase(torch, smi):
    """Phase group 20: ``tools/e2e_config2.py`` in full (train 1200
    iterations with densification → render and the TSDF mesh → unveil
    every vehicle → LPIPS and FID), then one training step on its trained
    state under ``torch.profiler``. Returns each stage's launches."""
    from streetunveiler_torch import renderer
    from streetunveiler_torch.cli.common import (load_scene_info,
                                                 scene_background)
    from streetunveiler_torch.config import load_config
    from streetunveiler_torch.ops.rasterizer import cuda_lib
    from streetunveiler_torch.scene.scene import Scene
    from streetunveiler_torch.tools import e2e_config2
    from streetunveiler_torch.train.step import init_optimizer, train_step
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_lib.BUILD_DIR) as tmp:
        mp = os.path.join(tmp, "model")
        rec = e2e_config2.main(["--model_path", mp, "--device", "cuda",
                                "--out", os.path.join(tmp, "e2e.json")])
        emit("e2e_config2", card=smi, record=rec,
             gate_ok=bool(rec["test_psnr"] > e2e_config2.PSNR_GATE
                          and rec["test_psnr"] > rec["init_test_psnr"] + 1),
             note="the end-to-end tool's record (its asserts passed): "
                  "stage times on the host clock between synchronisations")
        cfg = load_config(mp)
        scene = Scene(load_scene_info(cfg["model"], device="cuda"),
                      model_path=mp, device="cuda")
        state = scene.load(rec["iterations"])
        bg = scene_background(scene, device="cuda")
        cap = renderer.measure_duplicate_capacity(scene.train_cameras,
                                                  state, device="cuda")
        opt = cfg["optimization"]
        cam, img = scene.train_cameras[0], torch.as_tensor(
            scene.train_images[0], device="cuda")
        st = {"s": state, "o": init_optimizer(state)}

        def step():
            st["s"], st["o"], *_ = train_step(
                st["s"], st["o"], cam, img, bg, rec["iterations"] + 1, opt,
                duplicate_capacity=cap, device="cuda")
        step()
        emit("e2e_train_step_profile", card=smi,
             surfels=int(state.num_alive), duplicate_capacity=cap,
             **profile_frames(torch, step, E2E_PROFILE_STEPS),
             note="train_step on the trained config-2 state, first train "
                  "camera (800x600), after one warm step; per step")
    return {f"e2e_{k}": v for k, v in rec["launches_by_stage"].items()}


# ---- 21. multi-device training at world size 1 (NCCL) on the card
MULTI_ITER = 30_001    # past semantic_dist_from_iter and
#                        normal_consist_from_iter, before shrinking (the
#                        sharded step has no shrink term, as the JAX one)
MULTI_RTOL = 1e-5      # tests/test_loop_sharded.py:119-121
# A slab renders its pixels at slab-local coordinates through the shifted
# principal point (K[1,2] -= row0), exact in real arithmetic but rounded
# otherwise in f32: the first slab is bit for bit the full render's rows,
# the others differ by rounding, with pairs crossing the α = 1/255 gate
# (Δα = 1/255) at a few pixels. The phase reports the share of pixels
# past tests/test_shard.py:48's 1e-5, which holds at the tests' 64 rows
# but not at 1280 (2.6-5.2% of a slab's pixels of the street on an H100);
# it fails past SLAB_ROUNDING_TOL on more than FLIP_FRACTION of a slab, or
# past two gate flips at any pixel: a wrong row, binning or record moves
# O(0.1) of many pixels. The JAX package's slabs round alike: on the CPU,
# tests/test_torch_shard.py::test_slab_rounding_is_the_designs renders the
# street's 32 centre columns at 1280 rows in both packages
SLAB_ATOL = 1e-5
SLAB_ROUNDING_TOL = 1e-4
SLAB_FLIP_MAX = 2.0 / 255.0
MULTI_TIMING_ROUNDS = 3


def slab_err(torch, got, want, row0, rows):
    """A slab render against ``want``'s rows ``row0:row0 + rows``: the
    largest colour error, the pixels past ``SLAB_ATOL`` and their share,
    the largest error elsewhere, and the worst pixel with both sides'
    alpha."""
    a = want.render[row0:row0 + rows]
    e = (got.render - a).abs().amax(dim=-1)
    over = e > SLAB_ATOL
    idx = int(e.argmax())
    r, c = divmod(idx, e.shape[1])
    da = (got.rend_alpha - want.rend_alpha[row0:row0 + rows]).abs()
    return dict(
        max_abs_err=float(e.max()), pixels_over_atol=int(over.sum()),
        share_over_atol=float(over.float().mean()),
        share_over={f"{t:g}": float((e > t).float().mean())
                    for t in (1e-5, 2e-5, 5e-5, 1e-4, 1e-3)},
        # the 32 centre columns: the strip that tests/test_torch_shard.py
        # renders in both packages on the CPU
        share_over_atol_centre32=float(
            (e[:, W // 2 - 16:W // 2 + 16] > SLAB_ATOL).float().mean()),
        alpha_max_abs_err=float(da.max()),
        alpha_share_over={f"{t:g}": float((da > t).float().mean())
                          for t in (2e-5, 1e-4, 1e-3)},
        max_abs_err_elsewhere=float(e[~over].max()) if bool((~over).any())
        else 0.0,
        worst_pixel=dict(row=row0 + r, col=c, alpha=float(
            got.rend_alpha[r, c]), alpha_want=float(
                want.rend_alpha[row0 + r, c])))


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multi_phases(torch, state, cam, cap, smi):
    """Phase group 21: a one-rank NCCL group and a 1×1 mesh; the sharded
    late step (semantics, class distortion, the sky) on the street against
    ``train_step`` from the same state, replicated and surfel-sharded; the
    slab split at full width (2 and 4 slabs, slab-local binning and the
    ``shift_packT`` records path) against the full render; both steps
    timed in turns; the dryrun. Returns the sharded step's launches."""
    import dataclasses

    import torch.distributed as dist
    from streetunveiler_torch import renderer
    from streetunveiler_torch.config import OptimizationParams
    from streetunveiler_torch.models.sky import init_sky
    from streetunveiler_torch import trace
    from streetunveiler_torch.ops.rasterizer import kernel
    from streetunveiler_torch.ops.rasterizer.api import (
        _gather_records, bin_inputs_for_camera, bin_slab_from_inputs,
        rasterize_stream, shift_packT)
    from streetunveiler_torch.ops.rasterizer.preprocess import \
        preprocess_surfels
    from streetunveiler_torch.parallel.dryrun import dryrun_multichip
    from streetunveiler_torch.parallel.multihost import bootstrap
    from streetunveiler_torch.parallel.shard import (make_mesh,
                                                     make_sharded_train_step)
    from streetunveiler_torch.scene.cameras import Camera
    from streetunveiler_torch.train.optim import adam_init
    from streetunveiler_torch.train.step import init_optimizer, train_step

    rank, world, _ = bootstrap("cuda", f"tcp://127.0.0.1:{_free_port()}",
                               rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1, "cuda")
        bg, gt, gt_sem = ground_truth(torch, state, cam, cap)
        opt = OptimizationParams()
        sky0 = init_sky(torch.Generator().manual_seed(0), device="cuda")

        def fresh():
            s = state_copy(state)
            sk = sky0.map(lambda t: t.clone())
            return s, init_optimizer(s), sk, adam_init(sk)

        def single(s, o, sk, so):
            return train_step(s, o, cam, gt, bg, MULTI_ITER, opt,
                              sky_params=sk, sky_opt_state=so,
                              gt_semantic=gt_sem, class_dist=True,
                              duplicate_capacity=cap, device="cuda")

        steps = {zero: make_sharded_train_step(
            mesh, opt, W, H, duplicate_capacity=cap, semantics=True,
            class_dist=True, sky=True, shard_surfels=zero)
            for zero in (False, True)}

        def sharded(s, o, sk, so, zero=False):
            return steps[zero](s, o, cam.w2c[None], cam.K[None], gt[None], bg,
                               MULTI_ITER, gt_sem[None], sk, so)

        ref_s, ref_o, _, _, ref_m = single(*fresh())
        torch.cuda.synchronize()
        keys = ("loss", "l1", "ssim", "psnr", "semantic")
        checks = {}
        launches = None
        for zero in (False, True):
            trace.reset_launch_counts()
            s2, o2, _, _, m2 = sharded(*fresh(), zero=zero)
            torch.cuda.synchronize()
            if not zero:
                launches = path_launches(trace)
            rel = {k: abs(float(m2[k]) - float(ref_m[k]))
                   / max(abs(float(ref_m[k])), 1e-30) for k in keys}
            grad = {}
            for f in dataclasses.fields(ref_o.mu):
                want = getattr(ref_o.mu, f.name)     # 0.1·g after one step
                got = getattr(o2.mu, f.name)
                if want.numel() == 0:
                    continue
                amax = float(want.abs().max())
                excess = float(((got - want).abs() - GRAD_RTOL * want.abs()
                                ).max())
                grad[f.name] = dict(max_abs_err=float(
                    (got - want).abs().max()), atol=GRAD_ATOL_REL * amax,
                    ok=excess <= GRAD_ATOL_REL * amax)
            ok = (all(v <= MULTI_RTOL for v in rel.values())
                  and all(g["ok"] for g in grad.values())
                  and bool(m2["overflow"]) == bool(ref_m["overflow"])
                  and int(m2["n_alive"]) == int(ref_m["n_alive"]))
            checks["zero" if zero else "replicated"] = ok
            emit("multi_step_vs_train_step" + ("_zero" if zero else ""),
                 card=smi, backend=dist.get_backend(), world=world,
                 mesh=[1, 1], iteration=MULTI_ITER, rel_err=rel,
                 rtol=MULTI_RTOL, surfel_grads=grad,
                 loss=float(m2["loss"]), loss_train_step=float(ref_m["loss"]),
                 launches=launches if not zero else path_launches(trace),
                 within_tolerance=ok,
                 note="the sharded late step (semantics, class_dist, sky) "
                      "against train_step from copies of one state; "
                      "surfel_grads: the first Adam moments (0.1·g) at K2's "
                      "per-surfel tolerance (atol GRAD_ATOL_REL·max|g|, "
                      "rtol GRAD_RTOL)")
        del ref_s, ref_o, s2, o2

        # the slab split at full width; the same renders with K1's plain
        # version in its place (the binning and the rest unchanged), to
        # tell the design's rounding from K1's own
        def plain_render(camera, capacity):
            k1 = kernel.blend_forward
            kernel.blend_forward = (
                lambda recT, off, tx, ty, st, nq=kernel.NQ, n_gates=0,
                tile_order=None: kernel.blend_forward_plain(
                    recT, off, tx, ty, st, nq, n_gates))
            try:
                with torch.no_grad():
                    return renderer.render(camera, state, bg,
                                           duplicate_capacity=capacity,
                                           device="cuda")
            finally:
                kernel.blend_forward = k1

        settings = renderer._settings_for(cam, 1.0)
        with torch.no_grad():
            full = renderer.render(cam, state, bg, duplicate_capacity=cap,
                                   device="cuda")
        full_plain = plain_render(cam, cap)
        emit("multi_full_render_k1_vs_plain", card=smi,
             k1_vs_plain=slab_err(torch, full, full_plain, 0, H),
             note="the full 1920x1280 render through K1 against the same "
                  "render with K1's plain version: K1's own rounding at "
                  "the slab split's thresholds")
        with torch.no_grad():
            opac = state.get_opacity()[:, 0]
            geo = (state.params.xyz, state.get_scaling(),
                   state.get_rotation(), opac)
            inputs = bin_inputs_for_camera(*geo, cam.w2c, cam.K, settings)
            sur = preprocess_surfels(*geo, renderer.surfel_colors(
                state, cam, 3), cam.w2c, cam.K, settings)
            packT = kernel.pack_geometry_T(sur, state.capacity)
        slabs = {}
        for n_tile in (2, 4):
            slab = H // n_tile
            per = []
            for i in range(n_tile):
                row0 = i * slab
                k = cam.K.clone()
                k[1, 2] -= float(row0)
                cs = Camera(w2c=cam.w2c, K=k, width=W, height=slab)
                cap_s = renderer.measure_duplicate_capacity([cs], state,
                                                            device="cuda")
                with torch.no_grad():
                    rs = renderer.render(cs, state, bg,
                                         duplicate_capacity=cap_s,
                                         device="cuda")
                    b = bin_slab_from_inputs(inputs, row0, W, slab, cap_s)
                    out = rasterize_stream(
                        _gather_records(shift_packT(packT, row0),
                                        b.sorted_surfel), sur.radius,
                        renderer._settings_for(cs, 1.0), b, bg=bg)
                per.append(dict(
                    row0=row0, capacity=cap_s, overflow=bool(rs.overflow)
                    or bool(b.overflow),
                    demand_shifted_k=int(rs.demand), demand_slab_bin=int(
                        b.demand),
                    vs_full_rows=slab_err(
                        torch, rs, full, row0, slab),
                    shift_packT_vs_shifted_k=slab_err(
                        torch, renderer.finalize_render(out, cs), rs, 0,
                        slab),
                    plain_vs_full_rows_plain=slab_err(
                        torch, plain_render(cs, cap_s), full_plain, row0,
                        slab)))
            ok = all(p[k]["share_over"][f"{SLAB_ROUNDING_TOL:g}"]
                     <= FLIP_FRACTION and p[k]["max_abs_err"]
                     <= SLAB_FLIP_MAX
                     for p in per for k in ("vs_full_rows",
                                            "shift_packT_vs_shifted_k")
                     ) and not any(p["overflow"] for p in per)
            within_atol = all(p[k]["pixels_over_atol"] == 0 for p in per
                              for k in ("vs_full_rows",
                                        "shift_packT_vs_shifted_k"))
            slabs[n_tile] = ok
            emit(f"multi_slab_split_{n_tile}", card=smi, slab_rows=slab,
                 width=W, slabs=per, atol=SLAB_ATOL,
                 within_atol=within_atol,
                 rounding_tol=SLAB_ROUNDING_TOL,
                 flip_fraction=FLIP_FRACTION, flip_max=SLAB_FLIP_MAX,
                 within_tolerance=ok,
                 note="each slab rendered with K[1,2] -= row0 against the "
                      "full render's rows; the records path: full-camera "
                      "records through shift_packT, binned slab-locally by "
                      "bin_slab_from_inputs, against the shifted-K render; "
                      "max over the 3 colour channels a pixel; within_atol: "
                      "every pixel within atol (reported); the check: past "
                      "rounding_tol on at most flip_fraction of a slab, "
                      "nowhere past flip_max (two alpha-gate flips); "
                      "share_over: the share of a slab's pixels past each "
                      "error; the worst pixel's alpha on both sides; "
                      "plain_vs_full_rows_plain: the same split with K1's "
                      "plain version in both renders (reported)")
        del full, full_plain, inputs, sur, packT

        # both steps timed in turns on one state each (in place)
        a_args, b_args = fresh(), fresh()
        for f in (lambda: single(*a_args), lambda: sharded(*b_args)):
            f()
        times = {"train_step": [], "sharded_1x1": []}
        for _ in range(MULTI_TIMING_ROUNDS):
            for name, f in (("train_step", lambda: single(*a_args)),
                            ("sharded_1x1", lambda: sharded(*b_args)),
                            ("sharded_1x1", lambda: sharded(*b_args)),
                            ("train_step", lambda: single(*a_args))):
                times[name] += host_ms(torch, f, 1)
        emit("multi_step_time", card=smi, iteration=MULTI_ITER,
             ms_median={k: statistics.median(v) for k, v in times.items()},
             ms_all=times, note="host ms between synchronisations, in the "
             "turns train_step, sharded, sharded, train_step; each on its "
             "own state copy, updated in place")
        del a_args, b_args

        dryrun_multichip(1, "cuda")
        emit("multi_dryrun", ok=True, world=1,
             note="parallel/dryrun.py: the late-phase step, W 32, H 16, "
                  "48 surfels at capacity 64, in this one-rank group")
    finally:
        dist.destroy_process_group()
    if not (all(checks.values()) and all(slabs.values())):
        raise AssertionError("the sharded step differs from train_step or "
                             "a slab render from the full render")
    return launches


# The record scatter's street: the benchmark's size (1M surfels of the
# street at 1920x1280), the late step's 24 record rows and a capacity of
# 1.5x the view's demand, as the training loop's probe sizes it
SCATTER_SURFELS, SCATTER_REC, SCATTER_HEADROOM = 1_000_000, 24, 1.5


def scatter_phase(torch, smi):
    """The record scatter (``ops/rasterizer/scatter.py``, kernel
    ``csrc/scatter_sm90.cuh``) on one view of the 1M-surfel street:
    record gradients of rec 24 from a seed, NaN in the pad slots. Checks
    that the kernel gives its plain version's bits, the same bits twice
    and ``index_add_``'s under the deterministic mode (its sum over the
    whole stream with zero pads, what autograd ran before the kernel), and
    no NaN. Times (CUDA events) the scatter whole (sort and kernels), the
    stable sort alone, the kernels alone, the plain version, and
    ``index_add_`` over the whole stream in the default mode (atomics) and
    the deterministic one. The bound counts the bytes the sum needs, at
    3.35 TB/s: the live slots' gradients and surfel ids read once and the
    output written once; the sort's traffic and the kernels' own
    (the scratch, seg and the sorted slots) are counted beside it. Emits
    ``record_scatter`` and returns its kernels-line figures."""
    from streetunveiler_torch import renderer
    from streetunveiler_torch.ops.rasterizer import cuda_lib, scatter
    from streetunveiler_torch.tools.street import street_camera, \
        street_state
    n, rec = SCATTER_SURFELS, SCATTER_REC
    state = street_state(n=n, device="cuda")
    cam = street_camera(device="cuda")
    cap = renderer.measure_duplicate_capacity(
        [cam], state, headroom=SCATTER_HEADROOM, device="cuda")
    b = renderer.bin_camera(cam, state, duplicate_capacity=cap)
    idx = b.sorted_surfel
    n_live = int(b.tile_offsets[-1])
    drec = torch.randn((rec, cap), device="cuda",
                       generator=torch.Generator("cuda").manual_seed(0))
    drec[:, n_live:] = float("nan")
    zero_pads = torch.nan_to_num(drec, nan=0.0)
    del state

    def whole():
        return scatter.record_scatter_cuda(drec, idx, n + 1)

    keys, slots = torch.sort(idx, stable=True)
    seg = torch.empty(n + 2, dtype=torch.int32, device="cuda")
    scratch = torch.empty((cap, rec), device="cuda")
    out = torch.empty((n + 1, rec), device="cuda")
    lib = cuda_lib.load_library()
    stream = torch.cuda.current_stream().cuda_stream

    def kernels():
        cuda_lib.check(lib.su_record_scatter(
            drec.data_ptr(), rec, cap, keys.data_ptr(), slots.data_ptr(),
            n + 1, seg.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_device(), stream), "record_scatter launch")

    def index_add():
        return torch.zeros((rec, n + 1), device="cuda").index_add_(
            1, idx, zero_pads)

    got, again = whole(), whole()
    plain = scatter.record_scatter_plain(drec, idx, n + 1)
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        det = index_add()
        det_ms = cuda_ms(torch, index_add, 10)
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
    atomics = index_add()
    checks = dict(
        kernel_vs_plain_bit_equal=torch.equal(got, plain),
        run_to_run_bit_equal=torch.equal(got, again),
        vs_deterministic_index_add_bit_equal=torch.equal(got, det),
        finite=bool(torch.isfinite(got).all()),
        zero_column_zero=not bool(got[:, n].any()))
    nbytes = 4 * rec * n_live + 4 * n_live + 4 * rec * (n + 1)
    # beyond the bound: the sort reads the ids and writes keys and slots
    # (4 + 4 + 8 B a slot, one pass counted); the kernels read the sorted
    # ids in seg's searches, write seg, write and read back the scratch
    # and read the live slots' sorted slots (8 B)
    sort_bytes = 16 * cap
    kernel_extra_bytes = 4 * cap + 4 * (n + 2) + 2 * 4 * rec * n_live \
        + 8 * n_live
    row = dict(ms=cuda_ms(torch, whole, 20),
               sort_ms=cuda_ms(torch, lambda: torch.sort(idx, stable=True),
                               20),
               kernels_ms=cuda_ms(torch, kernels, 20),
               plain_ms=cuda_ms(torch, lambda: scatter.record_scatter_plain(
                   drec, idx, n + 1), 3),
               library_ms=cuda_ms(torch, index_add, 10),
               library_ms_deterministic=det_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               max_abs_err=float((got - plain).abs().max()))
    emit("record_scatter", card=smi, surfels=n, rec=rec, capacity=cap,
         live_slots=n_live, pad_share=1 - n_live / cap, **checks,
         default_index_add_max_abs_diff=float((got - atomics).abs().max()),
         bound_bytes=nbytes, sort_bytes=sort_bytes,
         kernel_extra_bytes=kernel_extra_bytes, **row,
         note="ms: sort and kernels; library_ms: index_add_ over the whole "
              "stream, the default mode (atomics), what autograd ran before "
              "the kernel; bound_ms: the bytes the sum needs")
    if not all(checks.values()):
        raise AssertionError(f"the record scatter failed a check: {checks}")
    return row


CULL_SURFELS = 1_000_000
# the benchmark's views of the street: 1920x1280 at f 1000 (the training
# and render cells), 1920x1080 at f 1970 (the unveil cell: a partial last
# tile row); the first is timed
CULL_VIEWS = {"1920x1280": (1920, 1280, 1000.0),
              "1920x1080": (1920, 1080, 1970.0)}


@contextlib.contextmanager
def plain_cull(tiles):
    """``tiles.ranked_table`` with the plain version in the kernel's place,
    on CUDA tensors too."""
    kernel_fn = tiles.cull_rects_cuda
    tiles.cull_rects_cuda = tiles.cull_rects_plain
    try:
        yield
    finally:
        tiles.cull_rects_cuda = kernel_fn


def cull_phase(torch, smi):
    """The binning's conic cull (kernel ``csrc/cull_sm90.cuh``, wrapper
    ``tiles.cull_rects_cuda``) on the 1M-surfel street at each of
    CULL_VIEWS: the kernel's table against its plain version's on the same
    tensors (every column; w0 and w1 on the small rows, 0 on the others),
    then ``ranked_table``'s dup_start and ranked table (every column K3
    reads) and ``bin_surfels_stream``'s whole stream with the kernel and
    with the plain version in its place, bit for bit. At 1920x1280: both
    timed by CUDA-graph replays in turns (and by CUDA events around
    back-to-back host calls), the stream's binning whole with each, and
    the bound: the bytes read and written once (center2d, ext, valid, the
    cull table; the [N, 7] table), and CULL_OPS_PER_PAIR operations for
    each rect position the test runs on (a small row's positions below
    rect_nt). Emits ``conic_cull`` and returns its kernels-line
    figures."""
    from streetunveiler_torch.ops.rasterizer import (RasterizeSettings,
                                                     cuda_lib, kernel, tiles)
    from streetunveiler_torch.ops.rasterizer.preprocess import \
        preprocess_surfels
    from streetunveiler_torch.tools.street import street_camera, \
        street_state
    n, tw, th = CULL_SURFELS, kernel.TILE_W, kernel.TILE_H
    state = street_state(n=n, device="cuda")
    checks, views, timed = {}, {}, None
    for label, (w, h, f) in CULL_VIEWS.items():
        cam = street_camera(device="cuda", width=w, height=h, focal=f)
        with torch.no_grad():
            sur = preprocess_surfels(
                state.params.xyz, state.get_scaling(), state.get_rotation(),
                state.get_opacity()[:, 0], torch.zeros((n, 3), device="cuda"),
                cam.w2c, cam.K, RasterizeSettings(width=w, height=h))
        args = (sur.cull, sur.center2d, sur.ext, sur.valid, w, h, tw, th)
        bin_args = (sur.center2d, sur.ext, sur.depth, sur.valid, w, h, tw,
                    th)
        got = tiles.cull_rects_cuda(*args)
        want = tiles.cull_rects_plain(*args)
        tbl, start = tiles.ranked_table(*bin_args, cull=sur.cull)
        cap = (-(-int(start[-1]) // tiles.S_CHUNK) + 16) * tiles.S_CHUNK
        b = tiles.bin_surfels_stream(*bin_args, cap, cull=sur.cull)
        with plain_cull(tiles):
            want_tbl, want_start = tiles.ranked_table(*bin_args,
                                                      cull=sur.cull)
            want_b = tiles.bin_surfels_stream(*bin_args, cap, cull=sur.cull)
        small, rsmall = want[:, 4] > 0, want_tbl[:, 5] > 0
        checks[label] = dict(
            table_bit_equal=(torch.equal(got[:, :5], want[:, :5])
                             and torch.equal(got[small, 5:],
                                             want[small, 5:])),
            words_zero_off_small=not bool(got[~small, 5:].any()),
            dup_start_bit_equal=torch.equal(start, want_start),
            ranked_bit_equal=(torch.equal(tbl[:, :6], want_tbl[:, :6])
                              and torch.equal(tbl[rsmall, 6:],
                                              want_tbl[rsmall, 6:])),
            stream_bit_equal=all(
                torch.equal(getattr(b, k), getattr(want_b, k))
                for k in ("sorted_surfel", "tile_offsets", "overflow",
                          "demand", "tile_order")))
        rect_nt = tiles.tile_rects(sur.center2d, sur.ext, sur.valid, w, h,
                                   tw, th)[3]
        pairs = int(torch.clamp(rect_nt[small], min=0).sum())
        views[label] = dict(valid=int(sur.valid.sum()),
                            small=int(small.sum()), tested_pairs=pairs,
                            passing_pairs=int(got[small, 3].sum()),
                            duplicates=int(start[-1]), capacity=cap)
        if timed is None:
            timed = (args, bin_args, cap, sur.cull, pairs)
    args, bin_args, cap, cull, pairs = timed
    replayed = collections.Counter()
    with torch.no_grad():
        turns = graph_rounds(torch, dict(
            kernel=lambda: tiles.cull_rects_cuda(*args),
            plain=lambda: tiles.cull_rects_plain(*args)), replayed, rounds=4,
            calls=10)
        event = dict(
            kernel=cuda_ms(torch, lambda: tiles.cull_rects_cuda(*args), 50),
            plain=cuda_ms(torch, lambda: tiles.cull_rects_plain(*args), 10))
        stream = lambda: tiles.bin_surfels_stream(*bin_args, cap, cull=cull)
        bin_kernel = graph_ms(torch, stream, replayed)
        with plain_cull(tiles):
            bin_plain = graph_ms(torch, stream, replayed)
    nbytes = n * (4 * (11 + 2 + 2) + 1 + 4 * 7)
    ops = CULL_OPS_PER_PAIR * pairs
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    ms = statistics.median(turns["kernel"])
    row = dict(ms=ms, plain_ms=statistics.median(turns["plain"]),
               event_ms=event["kernel"], plain_event_ms=event["plain"],
               bound_ms=bound_ms,
               bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                         >= ops / F32_OPS_PER_S else "operations"),
               share_of_bound=bound_ms / ms, max_abs_err=0.0,
               library_ms=None)
    emit("conic_cull", card=smi, surfels=n, checks=checks, views=views,
         kernel_turns=turns_summary(turns["kernel"]),
         plain_turns=turns_summary(turns["plain"]),
         bin_stream_device_ms=dict(kernel=bin_kernel, plain=bin_plain),
         bound_bytes=nbytes, bound_ops=ops,
         ops_every_position=CULL_OPS_PER_PAIR * tiles.CULL_KMAX * n,
         ptxas=ptxas_numbers(ptxas_summary(cuda_lib.build_log()).get(
             "cull")), replayed_launches=replayed["cull"], **row,
         note="ms, plain_ms: CUDA-graph replays in turns at 1920x1280; "
              "event_ms: CUDA events around back-to-back host calls; "
              "bin_stream_device_ms: bin_surfels_stream with the kernel and "
              "with the plain version (graph replays)")
    if not all(all(c.values()) for c in checks.values()):
        raise AssertionError(f"the conic cull failed a check: {checks}")
    return row


def partial_run(torch, only, state, cam, kind, smi):
    """``--only`` groups alone, after the build and the street scene:
    ``c1`` (the 16-step deterministically trained state and its C.1
    split), ``paths`` (phase group 17), ``data`` (phase group 18),
    ``eval`` (19), ``e2e`` (20), ``multi`` (21) and ``scatter`` (the record
    scatter at the benchmark's size, ``scatter_phase``) and ``cull`` (the
    conic cull kernel, ``cull_phase``). A quicker run
    for working on those phases; the full run is the one without
    arguments."""
    from streetunveiler_torch import renderer
    from streetunveiler_torch.config import OptimizationParams
    from streetunveiler_torch.models.sky import init_sky
    from streetunveiler_torch.ops.rasterizer import kernel
    unknown = set(only) - {"c1", "paths", "data", "eval", "e2e", "multi",
                           "scatter", "cull"}
    if unknown:
        raise SystemExit(f"--only: unknown groups {sorted(unknown)}")
    cap = renderer.measure_duplicate_capacity([cam], state, device="cuda")
    if "scatter" in only:
        scatter_phase(torch, smi)
    if "cull" in only:
        cull_phase(torch, smi)
    if "eval" in only:
        eval_phases(torch, smi)
    if "e2e" in only:
        emit("e2e_launches", **e2e_phase(torch, smi))
    if "multi" in only:
        emit("multi_launches", multi_sharded_step=multi_phases(
            torch, state_copy(state), cam, cap, smi))
    if "paths" in only:
        emit("paths_launches", **render_unveil_phases(
            torch, state_copy(state), cam, cap))
    if "data" in only:
        emit("data_launches", data_train_cli=data_phases(
            torch, state_copy(state), smi))
    if "c1" in only:
        bg, gt, gt_sem = ground_truth(torch, state, cam, cap)
        trained = deterministic_trained_state(torch, state, cam, cap, bg, gt,
                                              gt_sem, C1_STATE)
        sky = init_sky(torch.Generator().manual_seed(0), device="cuda")
        c1_split(torch, kernel, trained, cam, gt, bg, gt_sem, sky,
                 OptimizationParams(), cap, f"c1_split_late_trained_{C1_STATE}")
    print(json.dumps({"ok": True, "partial": sorted(only), "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    only = set(argv[1].split(",")) if argv[:1] == ["--only"] else set()
    if argv and not only:
        raise SystemExit("usage: chip_smoke.py "
                         "[--only c1,paths,data,eval,e2e,multi,scatter,cull]")
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
    from streetunveiler_torch import trace
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
    ptxas = ptxas_summary(cuda_lib.build_log())
    emit("build", seconds=build_s, library=os.path.relpath(
        cuda_lib.library_path(), ROOT), ptxas=ptxas)

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
    if only:
        return partial_run(torch, only, state, cam, kind, smi)

    # ---- 5a. the main path, once, with the launch counts read around it
    trace.reset_launch_counts()
    cap = renderer.measure_duplicate_capacity([cam], state, device="cuda")
    res = renderer.render(cam, state, bg, duplicate_capacity=cap,
                          device="cuda")
    torch.cuda.synchronize()
    launches = dict(trace.launch_counts)
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
    emit("k3_device_time", **k3_device_time(torch, k3_args), bytes=k3_bytes,
         bound_ms=k3_bound, note="device_ms: CUDA-graph replays (graph_ms); "
         "host_path_ms: 50 back-to-back host calls between CUDA events")

    # ---- 4. K1 against its plain version, nq=6 and nq=9
    packT = kernel.pack_geometry_T(sur, N_SURFELS)
    recT = _gather_records(packT, binning.sorted_surfel)
    off = binning.tile_offsets
    k1_args = (recT, off, binning.tiles_x, binning.tiles_y, settings, 6)
    acc, lk = kernel.blend_forward_cuda(*k1_args,
                                        tile_order=binning.tile_order)
    want_acc, want_lk, counts = kernel.blend_forward_plain(
        *k1_args, count_pairs=True)
    pairs = counts[EVALUATED]
    torch.cuda.synchronize()
    k1_err = check_blend(torch, acc, lk, want_acc, want_lk, 6,
                         "k1_vs_plain_nq6", binning.tiles_x)
    onehot = torch.nn.functional.one_hot(state.semantics.long(), 6).float()
    recT9 = _gather_records(kernel.pack_geometry_T(sur, N_SURFELS,
                                                   onehot[:, 3:6]),
                            binning.sorted_surfel)
    k1_9 = (recT9, off, binning.tiles_x, binning.tiles_y, settings, 9)
    acc9, lk9 = kernel.blend_forward_cuda(*k1_9,
                                          tile_order=binning.tile_order)
    want9 = kernel.blend_forward_plain(*k1_9)
    torch.cuda.synchronize()
    k1_err = max(k1_err, check_blend(torch, acc9, lk9, *want9, 9,
                                     "k1_vs_plain_nq9", binning.tiles_x))
    k1_ms = cuda_ms(torch, lambda: kernel.blend_forward_cuda(
        *k1_args, tile_order=binning.tile_order), 20)
    k1_plain_ms = cuda_ms(torch,
                          lambda: kernel.blend_forward_plain(*k1_args), 1)
    # records: only the stream's filled slots are read
    k1_nbytes = 4 * (recT.shape[0] * min(demand, cap) + off.numel()
                    + acc.numel() + lk.numel())
    k1_bound_bytes = k1_nbytes / HBM_BYTES_PER_S * 1e3
    k1_bound_ops = k1_ops(counts) / F32_OPS_PER_S * 1e3
    emit("k1_time", ms=k1_ms, plain_ms=k1_plain_ms, duplicates=demand,
         evaluated_pairs=pairs, bytes=k1_nbytes,
         bound_ms_bytes=k1_bound_bytes,
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

    # ---- 22. the record scatter at the benchmark's size (1M surfels)
    scatter_row = scatter_phase(torch, smi)
    # ---- 23. the conic cull at the benchmark's size (1M surfels)
    cull_row = cull_phase(torch, smi)

    # ---- 7. the training slice at full width, the late phase, then the
    # training CLI without and with the late phase
    bg, gt, gt_sem = ground_truth(torch, state, cam, cap)
    # the late phase starts from a copy of the street state taken before
    # the training phases update its parameters in place, so the inputs of
    # every *_late_full_width check are the street as built in every run
    # (when the record scatter added by atomics, the phases' state
    # differed from run to run)
    late_state = state_copy(state)
    # the render and unveil paths (phase group 17) and the data layer's
    # segment (phase group 18) run on the street as built, too
    unveil_state = state_copy(state)
    data_state = state_copy(state)
    multi_state = state_copy(state)
    # and trained ones that repeat from run to run: the training phases'
    # untimed steps under the deterministic mode, on other copies (the
    # phases' own schedule, and fewer steps)
    trained = {name: deterministic_trained_state(torch, state, cam, cap, bg,
                                                 gt, gt_sem, name)
               for name in TRAINED_STATES}
    k2, train_launches = train_phases(torch, state, cam, cap, bg, gt, gt_sem)
    late = late_phases(torch, late_state, cam, cap, bg, gt, gt_sem, trained)
    del trained
    bench_fwd_bwd(torch, state, cam)
    train_scene_synthetic(torch)
    # ---- 17. the render and unveil paths (the late training CLI's run
    # among them)
    paths = render_unveil_phases(torch, unveil_state, cam, cap)
    del unveil_state
    # ---- 18. the data layer: the Waymo-layout segment, its reader and
    # the training CLI on it
    paths["data_train_cli"] = data_phases(torch, data_state, smi)
    del data_state
    # ---- 19-21. the evaluation networks, the end-to-end run at config 2
    # and multi-device training at world size 1
    eval_phases(torch, smi)
    paths.update(e2e_phase(torch, smi))
    paths["multi_sharded_step"] = multi_phases(torch, multi_state, cam, cap,
                                               smi)
    del multi_state

    # ---- 9. the measurement tools
    tools = tool_phases(torch, k2[6]["args"], late["args"], k2[6],
                        late["trained_args"])

    # ---- 10. the probes T5-T9
    probes = probe_phases(torch)

    # ---- 11. the redesigned K1 and K2 against their first design
    redesign = redesign_phases(torch, k2[6]["args"], k2[12]["args"],
                               late["args"], ptxas)
    if not redesign["ok"]:
        raise AssertionError("a redesigned blend kernel differs from its "
                             "first design or failed its order guard, or "
                             "the tile order differs from its plain "
                             "version")
    first = redesign["first"]

    # ---- 12. the redesigned T3 and T9 against their first design
    probe_redesign = probe_redesign_phases(torch, ptxas)
    if not probe_redesign["ok"]:
        raise AssertionError("a redesigned probe kernel (T3 or T9) differs "
                             "from its first design or its plain version")

    # ---- 13. K3's redesign against its first design, the binning stage
    # split into its parts, T2 on K2's H100 design
    k3r = k3_redesign(torch, k3_args, k3_over, ptxas)
    emit("binning_split", **binning_split(torch, state, cam, cap),
         note="parts_ms: CUDA-event times of back-to-back calls, each part "
              "alone on the street's inputs; parts_device_ms: CUDA-graph "
              "replays (graph_ms); bin_step = the step's binning stage")
    t2_sm90 = bisect_bwd_sm90_phases(torch, k2[6]["args"], k2[12]["args"],
                                     late["args"], ptxas,
                                     late["trained_args"])
    if not (k3r["ok"] and t2_sm90["ok"]):
        raise AssertionError("K3's redesign differs from its first design or "
                             "its plain version, or T2 on K2's H100 design "
                             "disagrees with its plain version or with the "
                             "production K2")

    # ---- 14. T1 on K1's H100 design, T4's redesign
    t1_sm90 = bisect_fwd_sm90_phases(torch, k2[6]["args"], k2[12]["args"],
                                     late["args"], ptxas,
                                     late["trained_args"])
    t4r = micro_prefix_redesign(torch, ptxas)
    if not (t1_sm90["ok"] and t4r["ok"]):
        raise AssertionError("T1 on K1's H100 design disagrees with its "
                             "plain version or with the production K1, or "
                             "T4's redesign differs from its first design or "
                             "its plain version")

    # ---- 15. T5 and T6 redesigned, against their first design
    t56 = micro_floor_redesign(torch, ptxas, probes)
    if not t56["ok"]:
        raise AssertionError("T5/T6's redesign differs from its first design "
                             "or its plain version")

    # ---- 16. T7/T8's copy redesigned, against its first design and clone
    t78 = identity_phases(torch, *probes.pop("identity_inputs"), ptxas)
    if not t78["ok"]:
        raise AssertionError("T7/T8's redesigned copy differs from its first "
                             "design or from its input")

    # ---- 8. kernels; launches are those of the training main path, and
    # of the late path for the gated variants; launches_by_path those of
    # phase group 17's paths and phase group 18's training CLI, each read
    # around its own run (the render CLI's semantics blend is K1 at nq 9)
    k1g, k2g = late["k1"], late["k2"]
    csrc = "streetunveiler_torch/ops/rasterizer/csrc/"

    def by_path(key):
        return {path: counts[key] for path, counts in paths.items()}
    # K3: device times (CUDA-graph replays) of both designs at the street's
    # capacity, the event time of back-to-back host calls beside them
    k3s = k3r["capacities"]["street"]
    kernels = [
        dict(name="K3 tile expansion", route="cuda",
             source=csrc + "expand_sm90.cuh",
             replaces="streetunveiler_tpu/ops/rasterizer/tiles.py:160",
             launches=train_launches["expand"],
             launches_by_path=by_path("expand"), max_abs_err=0.0,
             ms=k3s["device_ms"],
             ms_first_design=k3s["device_ms_first_design"],
             host_path_ms=k3s["host_path_ms"],
             launch_floor_ms=k3r["launch_floor_ms"],
             plain_ms=k3_plain_ms, bound_ms=k3_bound, bound_by="bytes"
             if k3_bytes / HBM_BYTES_PER_S
             >= K3_OPS_PER_SLOT * capp / F32_OPS_PER_S else "operations",
             library_ms=None),
        dict(name="K1 blend forward", route="cuda",
             source=csrc + "blend_fwd_sm90.cuh",
             replaces="streetunveiler_tpu/ops/rasterizer/kernel.py:217",
             launches=train_launches["blend_fwd"],
             launches_by_path=by_path("blend_fwd"), max_abs_err=k1_err,
             ms=k1_ms, ms_first_design=first["k1", "photometric"],
             plain_ms=k1_plain_ms,
             bound_ms=max(k1_bound_bytes, k1_bound_ops),
             bound_by="operations" if k1_bound_ops >= k1_bound_bytes
             else "bytes", library_ms=None),
        dict(name="K2 blend backward", route="cuda",
             source=csrc + "blend_bwd_sm90.cuh",
             replaces="streetunveiler_tpu/ops/rasterizer/kernel.py:406",
             launches=train_launches["blend_bwd"],
             launches_by_path=by_path("blend_bwd"),
             max_abs_err=max(k2[6]["max_abs_err"], k2[12]["max_abs_err"]),
             ms=k2[6]["ms"], ms_first_design=first["k2", "photometric"],
             plain_ms=k2[6]["plain_ms"],
             bound_ms=k2[6]["bound_ms"], bound_by=k2[6]["bound_by"],
             library_ms=None),
        dict(name="K1 blend forward, gated chains (G=5, nq=12)",
             route="cuda",
             source=csrc + "blend_fwd_sm90.cuh",
             replaces="streetunveiler_tpu/ops/rasterizer/kernel.py:332",
             launches=late["launches"]["blend_fwd_gated"],
             launches_by_path=by_path("blend_fwd_gated"),
             max_abs_err=k1g["max_abs_err"], ms=k1g["ms"],
             ms_first_design=first["k1", "late"], plain_ms=k1g["plain_ms"],
             bound_ms=k1g["bound_ms"], bound_by=k1g["bound_by"],
             bound_ms_first_design_pairs=k1g["bound_ms_first_design_pairs"],
             library_ms=None),
        dict(name="K2 blend backward, gated chains (G=5, nq=12)",
             route="cuda",
             source=csrc + "blend_bwd_sm90.cuh",
             replaces="streetunveiler_tpu/ops/rasterizer/kernel.py:518",
             launches=late["launches"]["blend_bwd_gated"],
             launches_by_path=by_path("blend_bwd_gated"),
             max_abs_err=k2g["max_abs_err"], ms=k2g["ms"],
             ms_first_design=first["k2", "late"], plain_ms=k2g["plain_ms"],
             bound_ms=k2g["bound_ms"], bound_by=k2g["bound_by"],
             bound_ms_first_design_pairs=k2g["bound_ms_first_design_pairs"],
             library_ms=None),
        # the record scatter: its figures are phase group 22's, at the
        # benchmark's 1M surfels and rec 24; library_ms is index_add_'s
        dict(name="record scatter", route="cuda",
             source=csrc + "scatter_sm90.cuh",
             replaces="streetunveiler_tpu/ops/rasterizer/api.py:99",
             launches=train_launches["record_scatter"],
             launches_by_path=by_path("record_scatter"), **scatter_row),
        # the conic cull: phase group 23's figures, 1M surfels at 1920x1280
        dict(name="conic cull", route="cuda", source=csrc + "cull_sm90.cuh",
             replaces="streetunveiler_tpu/ops/rasterizer/tiles.py:102",
             launches=train_launches["cull"],
             launches_by_path=by_path("cull"), **cull_row),
    ]
    # the tools run on no main path: launches 0 there, their own count in
    # tool_launches; ms is T1/T2 full on the photometric stream, T3's
    # thread mode at k 13 and T4's fastest mode (every variant and mode in
    # the lines of phase groups 9 and 14); T1's ms, ms_first_design and
    # max_abs_err are phase group 14's (K1's H100 design), T2's phase
    # group 13's (K2's), their tool_launches groups 9 and 14's or 13's;
    # T3's ms, ms_first_design and library_ms are phase group 12's
    # back-to-back times, its tool_launches groups 9 and 12's; T4's ms,
    # ms_first_design, max_abs_err and bound are phase group 14's (its
    # redesign), its tool_launches groups 9 and 14's
    tools["T1"].update(t1_sm90["t1"])
    tools["T1"]["tool_launches"] += t1_sm90["launches"]
    tools["T4"].update(t4r["t4"])
    tools["T4"]["tool_launches"] += t4r["launches"]
    tools["T2"].update(t2_sm90["t2"])
    tools["T2"]["tool_launches"] += t2_sm90["launches"]
    tools["T3"].update(probe_redesign["t3"])
    tools["T3"]["tool_launches"] += probe_redesign["launches"][
        "micro_reduce"]
    for key, name, source, replaces in (
            ("T1", "T1 bisect_fwd variants of K1",
             csrc + "bisect_fwd_sm90.cu", "tools/bisect_fwd.py:281"),
            ("T2", "T2 bisect_bwd variants of K2",
             csrc + "bisect_bwd_sm90.cu", "tools/bisect_bwd.py:199"),
            ("T3", "T3 micro_reduce lane reductions",
             csrc + "micro_reduce_sm90.cuh", "tools/micro_reduce.py:70"),
            ("T4", "T4 micro_prefix prefix sums",
             csrc + "micro_prefix_sm90.cuh", "tools/micro_prefix.py:105")):
        r = tools[key]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=train_launches[{"T1": "bisect_fwd", "T2": "bisect_bwd",
                                     "T3": "micro_reduce",
                                     "T4": "micro_prefix"}[key]],
            tool_launches=r["tool_launches"], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r.get("library_ms"),
            **{k: r[k] for k in ("ms_first_design", "library_call",
                                 "fastest_mode", "ms_each_mode",
                                 "ms_first_design_each_mode") if k in r}))
    # T5-T9: launches are those of the probes' path in phase group 10 (each
    # tool's entry points once), tool_launches all of the group's, CUDA-graph
    # replays included; ms is T5's base variant and T6 at sb 128 (CUDA
    # events), the device time of the copies of the street's padded
    # tile_offsets and of T9 (every variant in the lines of phase group 10);
    # T9's ms, ms_first_design, library_ms and launch floor are phase group
    # 12's, its tool_launches groups 10 and 12's
    probes["T9"].update(probe_redesign["t9"])
    probes["T9"]["tool_launches"] += probe_redesign["launches"]["mmt3"]
    # T5's and T6's ms and ms_first_design are phase group 15's device
    # times (CUDA-graph replays; event_ms beside them brackets the
    # wrapper's host path too), as are their share of the bound and
    # max_abs_err (the redesign; T6's composite_ms three library calls),
    # their tool_launches groups 10 and 15's
    probes["T5"].update(t56["t5"])
    probes["T5"]["tool_launches"] += t56["launches"]["micro_floor_visit"]
    probes["T6"].update(t56["t6"])
    probes["T6"]["tool_launches"] += t56["launches"]["micro_floor_linear"]
    # T7's and T8's ms_first_design are phase group 16's device times in
    # turns, at the sizes of their ms (the padded tile_offsets, alone and
    # as a stack of one), their tool_launches groups 10 and 16's
    for key, name in (("T7", "identity_stack"), ("T8", "identity")):
        probes[key].update(t78[key.lower()])
        probes[key]["tool_launches"] += t78["launches"][name]
    for key, name, source, replaces in (
            ("T5", "T5 micro_floor visit-stream floor",
             csrc + "micro_floor_sm90.cuh", "tools/micro_floor.py:115"),
            ("T6", "T6 micro_floor linear walk",
             csrc + "micro_floor_sm90.cuh", "tools/micro_floor.py:149"),
            ("T7", "T7 probe_compose4 identity of a stack",
             csrc + "identity_sm90.cuh", "tools/probe_compose4.py:51"),
            ("T8", "T8 probe_tax identity", csrc + "identity_sm90.cuh",
             "tools/probe_tax.py:75"),
            ("T9", "T9 probe_mmt3 split-precision contraction",
             csrc + "mmt3_sm90.cuh", "tools/probe_mmt3.py:56")):
        r = probes[key]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=r["launches"], tool_launches=r["tool_launches"],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            **{k: r[k] for k in ("ms_real_steps", "csr_ms",
                                 "ms_first_design", "event_ms",
                                 "event_ms_first_design", "share_of_bound",
                                 "composite_ms", "launch_floor_ms",
                                 "vs_clone")
               if k in r}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
