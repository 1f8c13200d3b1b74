"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``streetunveiler_torch/ops/
rasterizer/csrc/`` (nvcc, sm_90a), holds each one against its plain
PyTorch version at the shapes of the full-width render, then drives the
forward render path — ``measure_duplicate_capacity`` and
``renderer.render`` — on the 300k-surfel street scene at 1920x1280 and
checks and times it, by stage with CUDA events and over three frames
under ``torch.profiler`` (the card's busy and idle share, kernels by
time). Each phase prints one JSON line; any failure raises
and the script exits non-zero. The last two lines are the kernels table
and ``{"ok": true, "device": {...}}``.

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
W, H, FOCAL, N_SURFELS = 1920, 1280, 1000.0, 300_000

# the tolerances of tests/test_kernel.py, per accumulator channel
TOL_PAYLOAD, TOL_ALPHA, TOL_DEPTH, TOL_MOMENT, TOL_MEDIAN = \
    5e-5, 2e-5, 5e-4, 5e-5, 1e-5
FLIP_FRACTION = 1e-3     # knife-edge pixels allowed at t_eps > 0


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def build_scene(n, seed=0):
    """The street scene of ``bench.py``: ground carpet + facade walls +
    clutter, splats projecting to ~4-10 px at f=1000."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n_g, n_w = n // 2, n // 3
    n_c = n - n_g - n_w
    ground = np.stack([rng.uniform(-30, 30, n_g), np.full(n_g, 2.0),
                       rng.uniform(2, 80, n_g)], 1)
    walls = np.stack([np.where(rng.random(n_w) < 0.5, -12.0, 12.0)
                      + rng.normal(0, 0.3, n_w),
                      rng.uniform(-8, 2, n_w), rng.uniform(2, 80, n_w)], 1)
    clutter = np.stack([rng.uniform(-10, 10, n_c), rng.uniform(-3, 2, n_c),
                        rng.uniform(3, 60, n_c)], 1)
    pts = np.concatenate([ground, walls, clutter]).astype(np.float32)
    depths = pts[:, 2]
    scales = (rng.uniform(3, 8, (n, 1)) * depths[:, None] / 1000.0
              ).astype(np.float32).repeat(2, 1)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, n).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    sem = np.empty(n, np.int32)
    sem[:n_g] = np.where(np.abs(ground[:, 0]) > 9.0, 1, 0)
    sem[n_g:n_g + n_w] = 2
    sem[n_g + n_w:] = np.where((clutter[:, 0] // 4).astype(int) % 2 == 0,
                               5, 3)
    return pts, scales, quats, opac, cols, sem


def street_state(seed=0):
    """SurfelState of the street scene, SH degree 3: DC from the colors,
    the rest ~ N(0, 0.05) from the seed."""
    import numpy as np
    from streetunveiler_torch.convert import state_from_arrays
    from streetunveiler_torch.ops.sh import rgb_to_sh
    pts, scales, quats, opac, cols, sem = build_scene(N_SURFELS, seed)
    n = pts.shape[0]
    rng = np.random.default_rng(seed + 1)
    z = np.zeros(n, np.float32)
    return state_from_arrays(dict(
        xyz=pts, features_dc=rgb_to_sh(cols)[:, None, :],
        features_rest=rng.normal(0, 0.05, (n, 15, 3)).astype(np.float32),
        scaling=np.log(scales), rotation=quats,
        opacity=np.log(opac / (1.0 - opac))[:, None],
        semantics=sem, alive=np.ones(n, bool), max_radii2d=z, grad_accum=z,
        denom=z, spatial_scale=np.float32(30.0)), device="cuda")


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


def check_blend(torch, acc, lk, want_acc, want_lk, nq, label):
    """K1 against its plain version: lk mismatch fraction, and per channel
    the max abs error over the pixels whose lk agrees."""
    same = (lk == want_lk)[..., 0]
    mismatch = 1.0 - float(same.float().mean())
    errs = (acc - want_acc).abs()[same].amax(dim=0).tolist()
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
    emit(label, nq=nq, lk_mismatch_frac=mismatch,
         max_abs_err_per_channel=errs, distortion_max_abs_err=dist_err,
         median_frac_over_tol=med_far, median_max_rel_err=med_rel,
         within_tolerance=ok)
    if not ok:
        raise AssertionError(f"{label}: K1 disagrees with its plain version")
    return max(errs[:nq + 5] + [dist_err])


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
    ptxas = [l.strip() for l in cuda_lib.build_log().splitlines()
             if "registers" in l or "spill" in l]
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

    # ---- the full-width scene, through a PLY round trip
    t0 = time.perf_counter()
    state0 = street_state()
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
            and not overflow and all(v > 0 for v in launches.values())):
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
    want_acc, want_lk, pairs = kernel.blend_forward_plain(
        *k1_args, count_pairs=True)
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

    # ---- 6. kernels
    kernels = [
        dict(name="K3 tile expansion", route="cuda",
             source="streetunveiler_torch/ops/rasterizer/csrc/expand.cu",
             replaces="streetunveiler_tpu/ops/rasterizer/tiles.py:160",
             launches=launches["expand"], max_abs_err=0.0, ms=k3_ms,
             plain_ms=k3_plain_ms, bound_ms=k3_bound, bound_by="bytes"
             if k3_bytes / HBM_BYTES_PER_S
             >= K3_OPS_PER_SLOT * capp / F32_OPS_PER_S else "operations",
             library_ms=None),
        dict(name="K1 blend forward", route="cuda",
             source="streetunveiler_torch/ops/rasterizer/csrc/blend_fwd.cu",
             replaces="streetunveiler_tpu/ops/rasterizer/kernel.py:217",
             launches=launches["blend_fwd"], max_abs_err=k1_err, ms=k1_ms,
             plain_ms=k1_plain_ms, bound_ms=max(k1_bound_bytes, k1_bound_ops),
             bound_by="operations" if k1_bound_ops >= k1_bound_bytes
             else "bytes", library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
