"""Device timing and the card's identity for the measurement tools."""

from __future__ import annotations

import statistics
import subprocess

import torch


def median_ms(fn, reps=10):
    """Median device time of ``fn`` over ``reps`` calls, each between its
    own pair of CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def card():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def require_cuda(device):
    """Raise unless ``device`` is a CUDA device that exists: the tools time
    the card and never fall back to the CPU."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("timing needs a CUDA device; with --device cpu "
                           "the tool only checks the plain versions")
