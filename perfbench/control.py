"""Readings that set the limits of ``correct``, for one cell over many
seeds in one process (so that set-up is paid once a seed, not once a
process):

    python3 -m perfbench.control --workload <cell> --seeds 11 12 13 ... \
        [--controls 3] [--seconds 3] [--out chiprun_out/control.jsonl]

For each seed it sets the cell up and runs a short window at the cell's
load (a training window runs one chunk at the least); then it prints one JSON line with the
program's numbers against the reference (the lower readings) and, for the
first ``--controls`` seeds, the control's (the reference computed in
TF32, the precision below the configuration's float32 with TF32 off) and,
for a training cell, those of the planted fault ``half_batch`` (the
losses over half the image). Runs on the card only; the benchmark's own
runs never run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


def reading(entry, spec, dev, seed: int, control: bool,
            seconds: float) -> dict:
    """One seed's line: the program's numbers against the reference and,
    with ``control``, the control's and (training) the fault's."""
    from .trace import Tracer
    t0 = time.perf_counter()
    cell = entry.Cell(spec, dev)
    cell.setup(seed)
    cell.window(seconds, Tracer(False, dev))
    if spec.traffic["entry"] == "render":
        prog = cell.program_frames()
    else:
        prog = cell.program_result()
    cell.release()
    want = cell.replay()
    line = {"workload": spec.name, "seed": seed,
            "program": cell.numbers(prog, want)}
    if control:
        line["control_tf32"] = cell.numbers(cell.replay(tf32=True), want)
        if spec.traffic["entry"] == "train":
            line["fault_half_batch"] = cell.numbers(
                cell.replay(half_batch=True), want)
    line["seconds"] = time.perf_counter() - t0
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from . import harness
    root = os.getcwd()
    spec = harness.load_spec(root, args.workload)
    harness.prepare_process(root)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    entry = harness.load_entry(root, spec.traffic["entry"])
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(args.out, "a")) if args.out else None
        for i, seed in enumerate(args.seeds):
            text = json.dumps(reading(entry, spec, dev, seed,
                                      i < args.controls, args.seconds))
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
