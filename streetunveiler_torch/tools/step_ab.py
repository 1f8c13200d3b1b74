"""The full-width training step of two checkouts of this repository, timed
in one run, turn by turn (for instance a parent commit unpacked with
``git archive`` into a git-ignored directory, and the working tree):

    python3 -m streetunveiler_torch.tools.step_ab --roots PARENT . \\
        --turns ABBA

Each turn is a child process that imports ``streetunveiler_torch`` from
its root (building that root's kernels into the root's own ``_build/``)
and sets up ``chip_smoke.py``'s street: 300k surfels at 1920×1280, the
target a render with the opacities raised. It then times three steps,
each ``bin_step`` + ``train_step``:

* photometric, at iteration 5000 (K1 and K2 at nq 6);
* semantic, the same with the label map (K1 and K2 at nq 12);
* late, at iteration 31001 with the labels, the per-class distortion and
  the sky (gated K1 and K2, G 5 at nq 12).

For each, the host-clock median of ``--reps`` steps between
synchronisations after 3 warm steps, and the card's busy time per step
under ``torch.profiler`` (the union of the device's kernel intervals over
3 steps). Prints one JSON line per turn, then ``step_ab_summary`` with
each root's mean over its turns. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

TRAIN_ITER0, LATE_ITER0 = 5000, 31_001     # chip_smoke.py's schedule points
PROFILED_STEPS = 3


def busy_ms_per_step(torch, step, steps=PROFILED_STEPS):
    """The union of the device's busy intervals per call of ``step``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return busy_us / 1e3 / steps


def host_ms(torch, step, reps):
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def child(root, reps):
    """One turn: the three steps of ``root``'s package."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch
    import streetunveiler_torch
    from streetunveiler_torch import renderer
    from streetunveiler_torch.config import OptimizationParams
    from streetunveiler_torch.models.sky import init_sky
    from streetunveiler_torch.ops.rasterizer import cuda_lib
    from streetunveiler_torch.tools import street
    from streetunveiler_torch.train.step import (bin_step, init_optimizer,
                                                 train_step)
    import dataclasses
    pkg = os.path.dirname(os.path.abspath(streetunveiler_torch.__file__))
    if os.path.dirname(pkg) != root:
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cuda_lib.load_library()
    build_s = time.perf_counter() - t0

    state = street.street_state(device="cuda")
    cam = street.street_camera("cuda")
    cap = renderer.measure_duplicate_capacity([cam], state, device="cuda")
    bg = torch.zeros(3, device="cuda")
    gt_state = dataclasses.replace(state, params=dataclasses.replace(
        state.params, opacity=state.params.opacity + 1.5))
    with torch.no_grad():
        gt = renderer.render(cam, gt_state, bg, duplicate_capacity=cap,
                             device="cuda").render.clamp(0.0, 1.0)
        gt_sem = renderer.render_semantic(
            cam, gt_state, duplicate_capacity=cap,
            device="cuda").argmax(dim=-1).to(torch.int32)
    opt = OptimizationParams()
    run = dict(state=state, opt_state=init_optimizer(state), sky=None,
               sky_opt=None, it=TRAIN_ITER0)

    def step(kind):
        late = kind == "late"
        b = bin_step(run["state"], cam, duplicate_capacity=cap,
                     device="cuda")
        (run["state"], run["opt_state"], run["sky"], run["sky_opt"],
         _) = train_step(
            run["state"], run["opt_state"], cam, gt, bg, run["it"], opt,
            sky_params=run["sky"], sky_opt_state=run["sky_opt"],
            gt_semantic=None if kind == "photometric" else gt_sem,
            class_dist=late, duplicate_capacity=cap, binning=b,
            device="cuda")
        run["it"] += 1

    out = dict(root=root, build_s=build_s, duplicate_capacity=cap)
    for kind in ("photometric", "semantic", "late"):
        if kind == "late":
            run["it"] = LATE_ITER0
            run["sky"] = init_sky(torch.Generator().manual_seed(0),
                                  device="cuda")
        fn = lambda: step(kind)
        for _ in range(3):
            fn()
        times = host_ms(torch, fn, reps)
        out[kind] = dict(host_ms_median=statistics.median(times),
                         host_ms_all=times,
                         card_busy_ms_per_step=busy_ms_per_step(torch, fn))
    print(json.dumps(out), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs=2, metavar=("A", "B"),
                    help="the two checkouts' roots, A then B")
    ap.add_argument("--turns", default="ABBA",
                    help="the order of the turns, one letter per turn")
    ap.add_argument("--reps", type=int, default=12)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child, args.reps)
    if not args.roots or set(args.turns) - {"A", "B"}:
        ap.error("--roots A B and --turns over A and B are needed")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    turns = []
    for letter in args.turns:
        root = args.roots["AB".index(letter)]
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", root, "--reps", str(args.reps)],
                           capture_output=True, text=True, check=False)
        if p.returncode:
            sys.stderr.write(p.stderr[-4000:])
            raise SystemExit(f"turn {letter} ({root}) failed: "
                             f"rc {p.returncode}")
        line = json.loads(p.stdout.strip().splitlines()[-1])
        line["turn"] = letter
        print(json.dumps(dict(phase="step_ab_turn", **line)), flush=True)
        turns.append(line)
    summary = {}
    for letter in "AB":
        mine = [t for t in turns if t["turn"] == letter]
        summary[letter] = dict(root=args.roots["AB".index(letter)], **{
            kind: {k: statistics.mean(t[kind][k] for t in mine)
                   for k in ("host_ms_median", "card_busy_ms_per_step")}
            for kind in ("photometric", "semantic", "late")})
    print(json.dumps(dict(phase="step_ab_summary", card=card,
                          turns=args.turns, reps=args.reps, **summary)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
