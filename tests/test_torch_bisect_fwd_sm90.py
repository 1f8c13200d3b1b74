"""T1 on K1's H100 design: the plain versions of the bisection variants
under the production K1's exact pair skip (``bisect_fwd.DESIGNS["sm90"]``).

* The sm90 ``full`` equals the production plain K1 (its skip applied) at
  G 0 and 5, and the JAX tool's ``full`` (its Pallas kernel in interpret
  mode).
* The skip drops only pairs that change no output under each variant's
  own chain rules, so every variant gives the same bits under both
  designs; the pairs each design evaluates are the production plain K1's
  counts: equal at G 0, fewer under the sm90 design on the dense gated
  stack.
* The wrappers take a design, refuse an unknown one and CPU tensors, and
  never fall back; the CLI takes ``--design`` and defaults to the card.

The kernels themselves are held against these plain versions, and ``full``
against the production K1 bit for bit, on a card by ``chip_smoke.py``
(``bisect_fwd_sm90``).
"""

import os
import sys

import numpy as np
import pytest
import torch

from streetunveiler_torch import trace
from streetunveiler_torch.ops.rasterizer import kernel, tiles
from streetunveiler_torch.tools import bisect_fwd, street

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_bisect import _jax_fwd, interpret, stream  # noqa: E402,F401

torch.set_num_threads(1)

FIRST, SM90 = bisect_fwd.DESIGNS["first"], bisect_fwd.DESIGNS["sm90"]


@pytest.fixture(scope="module")
def port_streams():
    """The port's binning of the miniature street: photometric (nq 6) and
    late (nq 12, G 5) blend arguments."""
    mini = street.MINI
    state = street.street_state(mini["n"], device="cpu", scale=mini["scale"])
    cam = street.street_camera("cpu", mini["width"], mini["height"],
                               mini["focal"])
    out = {}
    for late in (False, True):
        s = street.street_stream(state, cam, late=late, device="cpu")
        out[s[6]] = s
    return out


@pytest.fixture(scope="module")
def plain(port_streams):
    """``bisect_forward_plain`` on the miniature, memoised on (variant, G,
    design), with the pairs it counts."""
    memo = {}

    def run(variant, n_gates, design):
        key = (variant, n_gates, design)
        if key not in memo:
            memo[key] = bisect_fwd.bisect_forward_plain(
                variant, *port_streams[n_gates], tile_batch=8,
                count_pairs=True, **bisect_fwd.DESIGNS[design])
        return memo[key]
    return run


@pytest.mark.parametrize("n_gates", [0, 5])
def test_sm90_full_equals_production_plain_k1(port_streams, plain, n_gates):
    """Up to the order of the chunked products (T1 walks the stream's
    absolute 128-slot chunks, the production plain K1 each tile's own):
    1e-5 of each channel's largest magnitude, lk and every lk_g exact, and
    the same evaluated pairs."""
    s = port_streams[n_gates]
    want_acc, want_lk, counts = kernel.blend_forward_plain(
        *s, tile_batch=8, count_pairs=True, skip_rule=True)
    got_acc, got_lk, got_counts = plain("full", n_gates, "sm90")
    np.testing.assert_array_equal(got_lk.numpy(), want_lk.numpy())
    ch = kernel.ch_for(s[5])
    for g in range(n_gates):
        np.testing.assert_array_equal(got_acc[..., ch + 4 * g + 3].numpy(),
                                      want_acc[..., ch + 4 * g + 3].numpy())
    scale = want_acc.abs().amax(dim=(0, 1)).clamp(min=1.0)
    assert float(((got_acc - want_acc).abs().amax(dim=(0, 1)) / scale)
                 .max()) <= 1e-5
    assert got_counts["evaluated"] == counts["evaluated_skip_rule"]
    assert plain("full", n_gates, "first")[2]["evaluated"] \
        == counts["evaluated"]


def test_sm90_full_matches_jax_tool(stream, interpret):
    want_acc, want_lk = _jax_fwd(stream, "full")
    trace.reset_launch_counts()
    acc, lk = bisect_fwd.bisect_forward("full", *stream["port"],
                                        design="sm90")
    assert not any(trace.launch_counts.values())
    lk_ok = lk.numpy() == want_lk
    assert 1.0 - lk_ok.mean() <= 1e-3
    scale = np.maximum(1.0, np.abs(want_acc).max(axis=(0, 1)))
    err = np.abs(acc.numpy() - want_acc)[lk_ok[..., 0]].max(axis=0) / scale
    assert err.max() <= 1e-4, err.tolist()


@pytest.mark.parametrize("n_gates", [0, 5])
def test_evaluated_pairs_follow_each_design(n_gates):
    """On the dense-occlusion stack, whose other classes' chains outlive
    the main chain: the sm90 design evaluates the production plain K1's
    skip-rule pairs, the first design every pair a live chain reaches;
    the skip drops pairs only where gated chains run."""
    s = street.dense_streams("cpu")[n_gates]
    _, _, counts = kernel.blend_forward_plain(*s, tile_batch=8,
                                              count_pairs=True)
    got = {d: bisect_fwd.bisect_forward_plain(
        "full", *s, tile_batch=8, count_pairs=True, **kw)[2]["evaluated"]
        for d, kw in bisect_fwd.DESIGNS.items()}
    assert got["sm90"] == counts["evaluated_skip_rule"]
    assert got["first"] == counts["evaluated"]
    if n_gates:
        assert got["sm90"] < got["first"]
    else:
        assert got["sm90"] == got["first"]


@pytest.mark.parametrize("n_gates", [0, 5])
@pytest.mark.parametrize("variant", bisect_fwd.VARIANTS)
def test_stand_ins_are_the_same_under_both_designs(plain, variant, n_gates):
    acc, lk, count = plain(variant, n_gates, "sm90")
    acc0, lk0, count0 = plain(variant, n_gates, "first")
    np.testing.assert_array_equal(acc.numpy(), acc0.numpy())
    assert (lk is None) == (lk0 is None) == (variant == "floor_nolk")
    if lk is not None:
        np.testing.assert_array_equal(lk.numpy(), lk0.numpy())
    assert count["evaluated"] <= count0["evaluated"]
    if not n_gates or variant in bisect_fwd.FLOORS:
        assert count["evaluated"] == count0["evaluated"]


def test_wrappers_take_a_design_and_never_fall_back(port_streams):
    s = port_streams[0]
    order = tiles.tile_order(s[1])
    trace.reset_launch_counts()
    for design, kw in (("sm90", dict(tile_order=order)), ("first", {})):
        with pytest.raises(ValueError):   # CPU tensors
            bisect_fwd.bisect_forward_cuda("full", *s, design=design, **kw)
    with pytest.raises(ValueError):
        bisect_fwd.bisect_forward_cuda("full", *s, design="second")
    with pytest.raises(ValueError):
        bisect_fwd.bisect_forward_cuda("full", *s, design="first",
                                       tile_order=order)
    with pytest.raises(ValueError):       # sm90 variants: (6, 0), (12, 5)
        bisect_fwd.bisect_forward_cuda("floor", *s[:5], 12, 0,
                                       tile_order=order)
    with pytest.raises(ValueError):
        bisect_fwd.bisect_forward("full", *s, design="second")
    assert trace.launch_counts["bisect_fwd"] == 0
    acc, lk = bisect_fwd.bisect_forward("floor_nolk", *s, design="sm90")
    assert lk is None and bool((acc == acc[..., :1]).all())


def test_cli_takes_the_design(capsys):
    bisect_fwd.main(["floor", "--device", "cpu", "--design", "first"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert '"design": "first"' in lines[-1]
    with pytest.raises(SystemExit):
        bisect_fwd.main(["floor", "--device", "cpu", "--design", "second"])
    if not torch.cuda.is_available():   # the entry point defaults to the card
        with pytest.raises(RuntimeError, match="CUDA"):
            bisect_fwd.main(["floor"])
