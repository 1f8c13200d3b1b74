"""Readings that set the limits of ``correct`` in an unveil cell, over many
seeds in one process (set-up is paid once a seed, not once a process):

    python3 -m perfbench.unveil_control --workload <cell> --seeds 11 12 \
        ... [--controls 3] [--seconds 3] [--out control.jsonl]

For each seed it sets the cell up and runs a short window (one chunk at
the least), then prints one JSON line with the program's numbers against
the reference (the lower readings) and, for the first ``--controls``
seeds, the control's (the reference computed in TF32, the precision below
the configuration's float32 with TF32 off) and those of three faults
planted in the reference's place: ``half_batch`` (the L1 over the image's
upper half), ``mask_ignored`` (every alive row trains) and ``unchanged``
(a step that returns the deltas and moments it was given). Runs on the
card only, through ``perfbench.control``'s command; the benchmark's own
runs never run it.
"""

from __future__ import annotations

import sys
import time

FAULTS = {"fault_half_batch": dict(half_batch=True),
          "fault_mask_ignored": dict(mask_ignored=True),
          "fault_unchanged": dict(unchanged=True)}


def reading(entry, spec, dev, seed: int, control: bool,
            seconds: float) -> dict:
    from .trace import Tracer
    t0 = time.perf_counter()
    cell = entry.Cell(spec, dev)
    cell.setup(seed)
    stats = cell.window(seconds, Tracer(False, dev))
    prog = cell.program_result()
    cell.release()
    want = cell.replay()
    line = {"workload": spec.name, "seed": seed,
            "rate": cell.end_to_end(stats), "failed": stats["failed"],
            "program": cell.numbers(prog, want)}
    if control:
        line["control_tf32"] = cell.numbers(cell.replay(tf32=True), want)
        for name, mode in FAULTS.items():
            line[name] = cell.numbers(cell.replay(**mode), want)
    line["seconds"] = time.perf_counter() - t0
    return line


def main(argv=None) -> int:
    """``perfbench.control``'s command, with this module's ``reading``."""
    from . import control
    control.reading = reading
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
