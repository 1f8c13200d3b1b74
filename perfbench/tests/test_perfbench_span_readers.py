"""The readers of the program's own ranges and counters, each on a reading
made by hand (times in milliseconds on the trace's nanosecond clock),
against the value worked out by hand, and None where the ranges or the
counters are absent, as a program without them gives."""

from __future__ import annotations

import types

import pytest
import torch

from perfbench import harness
from perfbench.trace import Tracer

from .cells import ROOT

MS = 10 ** 6
SPANS = {
    "train.iteration": [(0, 100), (100, 200), (200, 300)],
    "train.bin": [(5, 20), (105, 120)],
    "bin.cull": [(6, 8)],
    "raster.record_scatter": [(50, 60), (150, 160)],
    "sky.forward": [(30, 35)],
    "sky.backward": [(61, 70)],
    "view": [(0, 50), (100, 200)],
}
# (name, start, duration, launch)
OPS = [("bin", 10, 4, 6), ("bin", 14, 2, 12), ("index_add", 60, 20, 55),
       ("sky", 40, 5, 31), ("sky_bwd", 80, 6, 65), ("bin", 110, 4, 106),
       ("index_add", 150, 30, 152), ("other", 250, 10, 240),
       ("copy", 310, 5, None)]
BUSY = [(10, 16), (40, 45), (60, 86), (110, 114), (150, 180), (250, 260),
        (310, 315)]


def reading(kind="train", spans=True):
    t = Tracer(enabled=False, device="cpu")
    if spans:
        t.spans = {k: [(a * MS, b * MS) for a, b in v]
                   for k, v in SPANS.items()}
    t.device_ops = [(n, s * MS, d * MS, None if lt is None else lt * MS)
                    for n, s, d, lt in OPS]
    t.busy = [(a * MS, b * MS) for a, b in BUSY]
    return types.SimpleNamespace(kind=kind, tracer=t, steps=2)


def read(metric, r):
    return harness.load_reader(ROOT, metric).read(r)


@pytest.mark.parametrize("metric,kind,want", [
    # the scatter's two launches: (20 + 30) / 2 steps
    ("record_scatter_ms.train", "train", 25.0),
    # the sky's forward 5 and backward 6, over 2 steps
    ("sky_ms.train", "train", 5.5),
    # launched in train.bin: 4 + 2 + 4
    ("bin_ms.train", "train", 5.0),
    ("cull_ms.train", "train", 2.0),
    # launches in the three iterations: 5, 2, 1
    ("launches_per_step.train", "train", 2),
    # idle in the iterations: 100 − 37, 100 − 34, 100 − 10
    ("step_idle_ms.train", "train", 66.0),
    # idle in the views: 50 − 11, 100 − 34
    ("view_idle_ms.render", "render", 52.5),
])
def test_span_reader_by_hand(metric, kind, want):
    assert read(metric, reading(kind)) == pytest.approx(want)
    assert read(metric, reading(kind, spans=False)) is None
    other = "render" if kind == "train" else "train"
    assert read(metric, reading(other)) is None


def test_pad_share_by_hand():
    from streetunveiler_torch import trace
    trace.reset_counters()
    assert read("pad_share.train", reading()) is None
    with torch.profiler.profile():
        trace.count("raster.slots", 1000)
        trace.count("raster.duplicates", torch.tensor(600, dtype=torch.int32))
        trace.count("raster.slots", 500)
        trace.count("raster.duplicates", torch.tensor(150))
    # 1 − 750 / 1500
    assert read("pad_share.train", reading()) == pytest.approx(50.0)
    assert read("pad_share.train", reading("render")) is None
    trace.reset_counters()
    assert read("pad_share.train", reading()) is None
