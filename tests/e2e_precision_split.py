"""Config 2's training, cut down, through both packages' training CLIs on
the CPU, to split the held-out PSNR and surfel counts of the port's
config-2 run from those of the JAX package's TPU record
(``docs/e2e_config2_torch.json`` against ``docs/e2e_config2.json``).

Runs, each a process of its own, all on the same synthetic street and seed
(4,000 points, 16 cameras at 160×120, focal 140, the held-out i % 8 == 0
views; config 2's flags otherwise: SH degree 0, ``--max_screen_size 100``,
capacity 2× the points, with densification from iteration 100 to 250 so
that 300 iterations densify as config 2's 1,200 do from 500 to 1,000):

* ``port``: ``streetunveiler_torch.cli.train --device cpu`` (float32);
* ``jax``: ``streetunveiler_tpu.cli.train`` on the CPU (float32);
* ``jax_bf16``, ``jax_bf16_conv``, ``jax_bf16_dot``: the JAX CLI with a
  TPU's DEFAULT precision emulated: convolutions and/or dot_generals whose
  precision is unset or DEFAULT round both float32 operands to bfloat16
  first (one bfloat16 pass, float32 accumulation), as a TPU computes them.
  The package's own HIGHEST-precision products are left as they are.

Prints one JSON line per run with its log points (iteration, loss, PSNR,
surfels alive) and its held-out PSNR, then a summary line.

    JAX_PLATFORMS=cpu python tests/e2e_precision_split.py \
        [--runs port,jax,jax_bf16,jax_bf16_conv,jax_bf16_dot] [--out DIR]

About 15-25 minutes on 8 CPU cores, most of it the ground-truth renders of
the CPU oracle.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = ("port", "jax", "jax_bf16", "jax_bf16_conv", "jax_bf16_dot")
ITERATIONS = 300
FLAGS = ["--scene", "synthetic", "--eval", "--iterations", str(ITERATIONS),
         "--capacity", "8000", "--sh_degree", "0", "--max_screen_size", "100",
         "--synthetic_points", "4000", "--synthetic_cameras", "16",
         "--synthetic_width", "160", "--synthetic_height", "120",
         "--synthetic_focal", "140", "--densify_from_iter", "100",
         "--densify_until_iter", "250", "--log_every", "16",
         "--eval_every", "100", "--save_every", str(ITERATIONS), "--seed",
         "0"]
LINE = re.compile(r"^\[(\d+)\] loss=([\d.e+-]+) psnr=([\d.e+-]+) "
                  r"alive=(\d+).*?(?:test_psnr=([\d.e+-]+))?$")


def _bf16_default_precision(ops):
    """Round the float32 operands of DEFAULT-precision convolutions
    (``"conv"``) and dot_generals (``"dot"``) to bfloat16."""
    import jax
    import jax._src.lax.lax as lax_impl
    import jax.numpy as jnp

    def default(p):
        if isinstance(p, (tuple, list)):
            return all(default(q) for q in p)
        return p is None or p == jax.lax.Precision.DEFAULT

    def rnd(x):
        x = jnp.asarray(x)
        return (x.astype(jnp.bfloat16).astype(jnp.float32)
                if x.dtype == jnp.float32 else x)

    conv0, dot0 = jax.lax.conv_general_dilated, lax_impl.dot_general

    def conv(lhs, rhs, *a, precision=None, **k):
        if default(precision):
            lhs, rhs = rnd(lhs), rnd(rhs)
        return conv0(lhs, rhs, *a, precision=precision, **k)

    def dot(lhs, rhs, dimension_numbers, precision=None, *a, **k):
        if default(precision):
            lhs, rhs = rnd(lhs), rnd(rhs)
        return dot0(lhs, rhs, dimension_numbers, precision, *a, **k)

    if "conv" in ops:
        jax.lax.conv_general_dilated = conv
    if "dot" in ops:
        lax_impl.dot_general = dot
        jax.lax.dot_general = dot


def _worker(run, model_path):
    sys.path.insert(0, ROOT)
    argv = ["--model_path", model_path] + FLAGS
    if run == "port":
        import torch
        torch.set_num_threads(int(os.environ.get("SPLIT_TORCH_THREADS", 2)))
        from streetunveiler_torch.cli.train import main
        return main(argv + ["--device", "cpu"])
    if run.startswith("jax_bf16"):
        _bf16_default_precision(run[len("jax_bf16_"):] or "conv,dot")
    from streetunveiler_tpu.cli.train import main
    return main(argv)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default=",".join(RUNS))
    ap.add_argument("--out", default=None,
                    help="directory for the runs' model dirs and logs")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--model_path", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return _worker(args.worker, args.model_path)

    runs = args.runs.split(",")
    if set(runs) - set(RUNS):
        raise SystemExit(f"unknown runs {set(runs) - set(RUNS)}; "
                         f"choose from {RUNS}")
    out = args.out or tempfile.mkdtemp(prefix="e2e_precision_split_")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONUNBUFFERED="1")
    procs = {}
    for run in runs:
        log = open(os.path.join(out, f"{run}.log"), "w")
        procs[run] = (subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", run,
             "--model_path", os.path.join(out, run)],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT), log)
    summary = {}
    for run, (proc, log) in procs.items():
        rc = proc.wait()
        log.close()
        points = []
        with open(os.path.join(out, f"{run}.log")) as f:
            for line in f:
                m = LINE.match(line.strip())
                if m:
                    points.append(dict(
                        iteration=int(m[1]), loss=float(m[2]),
                        psnr=float(m[3]), alive=int(m[4]),
                        test_psnr=float(m[5]) if m[5] else None))
        rec = dict(run=run, rc=rc, log_points=points)
        print(json.dumps(rec), flush=True)
        if rc != 0 or not points:
            raise SystemExit(f"run {run} failed (rc {rc}); see "
                             f"{os.path.join(out, run + '.log')}")
        summary[run] = dict(test_psnr=points[-1]["test_psnr"],
                            alive=points[-1]["alive"],
                            psnr=points[-1]["psnr"])
    print(json.dumps(dict(summary=summary, iterations=ITERATIONS)),
          flush=True)


if __name__ == "__main__":
    main()
