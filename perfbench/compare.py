"""The numbers that decide ``correct``.

Training cells compare segments of the program's steps (the set-up steps,
and the last steps of the window's newest chunk) with the plain
reference's from the same state, views and targets:

* ``loss_gap``: the relative gap of the segment's first step's loss (its
  later steps start from states that the reference's own rounding has
  already moved: Adam's first step from fresh moments moves every element
  by ±lr whatever the size of its gradient, so a gradient at round-off
  moves by the sign of its rounding; each step's gaps are kept for the
  record as ``loss_gaps``);
* ``grad_gap``: the first gradient as the optimizer got it (its first
  moment after one step over 1 − β1), by the worst leaf: the gap between
  the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf;
* ``change_gap``: the same of the parameters' change over the steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (they move under Adam by round-off alone);
* ``stats_gap``: the largest difference of the densification statistics
  (exact: both sides gate them off past ``densify_until_iter``).

Render cells compare sampled frames of the window with the reference's
render of their views: ``mismatch_share``, the largest share, over the
frames and their outputs, of values off the reference by more than the
output's tolerance.
"""

from __future__ import annotations

import statistics

import torch

BETA1 = 0.9
# a leaf whose reference gradient norm is under this share of the median
# leaf's is left out of the change
ROUNDOFF_LEAF = 1e-3


def norm(t) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def worst_leaf(prog: dict, want: dict, names) -> tuple:
    """(gap, leaf): the largest |‖prog‖ − ‖want‖| over max(‖want‖, the
    median leaf's ‖want‖), over ``names``."""
    names = list(names)
    if not names:
        return 0.0, ""
    ref_norms = {k: norm(want[k]) for k in names}
    med = statistics.median(ref_norms.values())
    gaps = {k: abs(norm(prog[k]) - ref_norms[k]) / max(ref_norms[k], med,
                                                       1e-30)
            for k in names}
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def training_numbers(prog: dict, want: dict) -> dict:
    """``prog``/``want``: ``losses`` (per step), ``g1`` (leaf → first
    gradient), ``change`` (leaf → θ after the steps − θ before), ``stats``
    (name → densification statistic after the steps). Returns the
    numbers and, for the record, the leaves that set them."""
    loss_gaps = [abs(p - w) / max(abs(w), 1e-30)
                 for p, w in zip(prog["losses"], want["losses"])]
    nonempty = [k for k, v in want["g1"].items() if v.numel()]
    g_norms = {k: norm(want["g1"][k]) for k in nonempty}
    med = statistics.median(g_norms.values())
    moving = [k for k in nonempty if g_norms[k] >= ROUNDOFF_LEAF * med]
    grad_gap, grad_leaf = worst_leaf(prog["g1"], want["g1"], nonempty)
    change_gap, change_leaf = worst_leaf(prog["change"], want["change"],
                                         moving)
    stats_gap = max(float((prog["stats"][k].double()
                           - want["stats"][k].double()).abs().max())
                    for k in want["stats"])
    return dict(loss_gap=loss_gaps[0], grad_gap=grad_gap,
                change_gap=change_gap, stats_gap=stats_gap,
                loss_gaps=loss_gaps, grad_leaf=grad_leaf,
                change_leaf=change_leaf,
                left_out=sorted(set(nonempty) - set(moving)))


# per output the render CLI writes: (absolute tolerance, relative
# tolerance); the semantic argmax counts every label that differs
FRAME_TOLERANCES = {"image": (1e-4, 0.0), "depth": (1e-4, 1e-4),
                    "normal": (1e-4, 0.0), "semantics": (0.5, 0.0)}


def mismatch_share(prog: dict, want: dict) -> tuple:
    """(share, output): the largest share of an output's values farther
    from the reference's than ``atol + rtol·|reference|``."""
    worst = (0.0, "")
    for k, (atol, rtol) in FRAME_TOLERANCES.items():
        p = torch.as_tensor(prog[k], dtype=torch.float64)
        w = torch.as_tensor(want[k], dtype=torch.float64)
        off = (p - w).abs() > atol + rtol * w.abs()
        off |= torch.isnan(p) != torch.isnan(w)
        share = float(off.double().mean())
        if share > worst[0]:
            worst = (share, k)
    return worst
