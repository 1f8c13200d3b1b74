"""Run one cell of the benchmark once, on the card this process sees:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``;
with ``--trace 1`` also ``breakdown``); the numbers that decided
``correct`` close standard error. Without a card, or with fewer cards than
the cell asks for, it prints no result and exits with 3.
"""

from __future__ import annotations

import argparse
import sys


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.run")
    ap.add_argument("--workload", required=True,
                    help="a cell of BENCHMARK.json (perfbench/workloads/)")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True,
                    help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: a traced run that reports the per-layer "
                         "metrics")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from . import harness
    return harness.main(args)


if __name__ == "__main__":
    sys.exit(main())
