"""Miniature cells that run on the CPU, for the benchmark's tests."""

from __future__ import annotations

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = ("street-1920x1280.train-late", "street-1920x1280.render-view")
SEED = 2 ** 31 + 12345

def mini(name: str, root: str = ROOT):
    """The cell ``name`` with its configuration cut to a CPU miniature:
    the street at 128×96 with 600 surfels over 4 views (the field of view
    kept); chunks of 6 iterations."""
    from perfbench import harness
    spec = harness.load_spec(root, name)
    c = spec.config
    c.update(n_surfels=600, width=128, height=96,
             focal=c["focal"] * 128 / c["width"], n_views=4)
    spec.traffic["chunk"] = 6
    return spec
