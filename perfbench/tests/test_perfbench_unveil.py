"""The unveil cell on the CPU at a miniature: a sound run reads correct, and
faults planted in the program's delta step read not correct (the pattern
of ``test_perfbench_harness.py``): the train mask ignored (every alive row
trains), the L1 over half the image, and a step that returns the deltas
unchanged."""

from __future__ import annotations

import copy

import pytest
import torch

from perfbench import harness

from .cells import ROOT, SEED

CELL = "street-1920x1080-unveil.reopt"


def mini_unveil(root: str = ROOT):
    """The unveil cell cut to a CPU miniature: the street at 128×72 with
    6,000 surfels (three vehicle bands of ~170 to remove) over 6 views,
    the field of view kept; chunks of 6 iterations."""
    spec = harness.load_spec(root, CELL)
    c = spec.config
    c.update(n_surfels=6000, width=128, height=72,
             focal=c["focal"] * 128 / c["width"], n_views=6)
    spec.traffic["chunk"] = 6
    return spec


def run(seconds=0.0):
    return harness.run_cell(ROOT, mini_unveil(), SEED, seconds, False,
                            torch.device("cpu"))


def _mask_ignored(monkeypatch):
    from streetunveiler_torch.pipeline import reoptimize
    orig = reoptimize.apply_deltas
    monkeypatch.setattr(reoptimize, "apply_deltas",
                        lambda base, deltas, mask, *a: orig(
                            base, deltas, base.alive, *a))


def _half_image(monkeypatch):
    from streetunveiler_torch.pipeline import reoptimize
    orig = reoptimize.l1_loss
    monkeypatch.setattr(reoptimize, "l1_loss", lambda a, b: orig(
        a[:a.shape[0] // 2], b[:b.shape[0] // 2]))


def _unchanged(monkeypatch):
    from streetunveiler_torch.pipeline import reoptimize
    orig = reoptimize.reoptimize_step

    def step(base, deltas, opt_state, *a, **k):
        out = orig(base, copy.deepcopy(deltas), copy.deepcopy(opt_state),
                   *a, **k)
        return deltas, opt_state, out[2]
    monkeypatch.setattr(reoptimize, "reoptimize_step", step)


def test_sound_run_is_correct():
    result = run(0.3)
    assert result["correct"] is True, result["compared"]
    assert result["failed"] == 0
    assert result["compared"]["frozen_gap"]["value"] == 0.0
    assert set(result["metrics"]) == {"train_rays_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["mask_ignored", "half_image",
                                   "unchanged"])
def test_planted_fault_is_not_correct(monkeypatch, fault):
    {"mask_ignored": _mask_ignored, "half_image": _half_image,
     "unchanged": _unchanged}[fault](monkeypatch)
    result = run()
    assert result["correct"] is False, result["compared"]
