"""Port vs JAX: the per-step floor probes T5 (the visit-stream floor) and
T6 (the linear walk) of ``tools/micro_floor.py``, as their plain PyTorch
versions, and the refusals of their wrappers.

The Pallas kernels are taken from the tool's own ``pl.pallas_call``, run
in interpret mode on 24 chunks, 8 tiles and 32 steps (the tool's stream
generator at that size, with padding). The TPU leaves the outputs' first
values undefined, and the interpreter fills them with NaN: ``prefetch2``
adds to blocks it never zeroed, ``static_out`` leaves tiles 1-7 unwritten,
and T6 never zeroes. The port defines them (outputs start at zero; a
block a step does not write keeps its value), so every plain output is
held to a numpy formula of that function, folded in f32 in stream order,
and to the Pallas kernel wherever the interpreter's value is finite. The
tolerance is 1e-6 relative: the chunk sums are taken in another order.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from streetunveiler_torch import trace  # noqa: E402
from streetunveiler_torch.tools import micro_floor  # noqa: E402

# the JAX tool puts its own directory first on the import path when
# imported; the port is imported above, and the path is put back
_saved_path = list(sys.path)
import micro_floor as jmicro_floor  # noqa: E402
sys.path[:] = _saved_path

torch.set_num_threads(1)

N_CHUNKS, N_TILES, VCAP = 24, 8, 32
RTOL = 1e-6


@pytest.fixture(scope="module")
def data():
    rec = np.random.default_rng(1).random((24, N_CHUNKS * 128)).astype(
        np.float32)
    tile_of, chunk_of, first, n = jmicro_floor.make_visits(
        N_CHUNKS - 1, N_TILES, VCAP)
    assert n < VCAP
    return rec, tile_of, chunk_of, first


def _run_jax(monkeypatch, build, *args):
    """The tool's Pallas kernel in interpret mode: the outputs of the first
    ``pl.pallas_call`` of ``build``'s loop (whose first call takes rec
    unperturbed)."""
    outs, pallas_call = [], pl.pallas_call

    def capture(*a, **kw):
        call = pallas_call(*a, interpret=True, **kw)

        def run(*args):
            out = call(*args)
            outs.append([np.array(o) for o in out])
            return out
        return run

    monkeypatch.setattr(jmicro_floor, "ITERS", 1)
    monkeypatch.setattr(jmicro_floor.pl, "pallas_call", capture)
    with jax.disable_jit():
        build(*args)
    return outs[0]


def _formula(rec, steps, width, n_tiles):
    """The defined function in numpy: steps (block, lane block, first) in
    stream order, first None for "every step adds"."""
    acc = np.zeros(n_tiles, np.float32)
    for blk, c, f in steps:
        if f is not None and f > 0:
            acc[blk] = np.float32(0)
        if f is None or f >= 0:
            s = rec[:, c * width:(c + 1) * width].sum(dtype=np.float32)
            acc[blk] = np.float32(acc[blk] + np.float32(s * np.float32(1e-30)))
    return np.broadcast_to(acc[:, None, None], (n_tiles, 512, 12))


def _close(got, want):
    """got == want within RTOL where want is finite (exact where zero);
    returns the number of elements compared."""
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=0)
    return int(ok.sum())


def test_make_visits_equals_the_tools():
    for args in ((N_CHUNKS - 1, N_TILES, VCAP),
                 (micro_floor.N_CHUNKS - 1, micro_floor.N_TILES,
                  micro_floor.VCAP)):
        want = jmicro_floor.make_visits(*args)
        got = micro_floor.make_visits(*args)
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        assert got[3] == want[3]


@pytest.mark.parametrize("variant", micro_floor.VARIANTS)
def test_visit_floor_plain_matches_jax_tool(data, monkeypatch, variant):
    rec, tile_of, chunk_of, first = data
    want = _run_jax(monkeypatch, lambda *a: jmicro_floor.build_visit(
        variant, VCAP, N_TILES)(*a), jnp.asarray(rec), jnp.asarray(tile_of),
        jnp.asarray(chunk_of), jnp.asarray(first))
    trace.reset_launch_counts()
    got = micro_floor.micro_floor_visit(
        variant, torch.as_tensor(rec), torch.as_tensor(tile_of),
        torch.as_tensor(chunk_of), torch.as_tensor(first), N_TILES)
    assert not any(trace.launch_counts.values())
    got = [g.numpy() for g in got]
    assert len(got) == len(want) == (2 if variant == "base" else 1)
    assert got[0].shape == want[0].shape == (N_TILES, 512, 12)
    blocks = np.zeros_like(tile_of) if variant == "static_out" else tile_of
    steps = [(b, c, None if variant == "prefetch2" else f)
             for b, c, f in zip(blocks, chunk_of, first)]
    formula = _formula(rec, steps, 128, N_TILES)
    np.testing.assert_allclose(got[0], formula, rtol=RTOL, atol=0)
    compared = _close(got[0], want[0])
    if variant == "base":
        assert not got[1].any()
        assert _close(got[1], want[1]) == want[1].size
    # the interpreter's NaN: only where the TPU leaves blocks undefined
    if variant in ("base", "alldone", "one_out", "no_scratch"):
        assert compared == want[0].size
    elif variant == "static_out":
        assert np.isfinite(want[0][0]).all() and got[0][0, 0, 0] > 0
        assert not got[0][1:].any()
    if variant == "prefetch2":
        # the padding steps add the last chunk to tile 0, after its real
        # visits; every other tile holds one_out's sum
        one_out = _formula(rec, list(zip(tile_of, chunk_of, first)), 128,
                           N_TILES)
        assert (first < 0).any() and got[0][0, 0, 0] > one_out[0, 0, 0]
        np.testing.assert_allclose(got[0][1:], one_out[1:], rtol=RTOL)


@pytest.mark.parametrize("sblock", micro_floor.SBLOCKS)
def test_linear_floor_plain_matches_formula(data, monkeypatch, sblock):
    rec = data[0]
    grid = N_CHUNKS * 128 // sblock
    tile_map = np.minimum(np.arange(grid) * N_TILES // grid,
                          N_TILES - 1).astype(np.int32)
    fn, grid_n = jmicro_floor.build_linear(sblock, N_CHUNKS * 128, N_TILES)
    assert grid_n == grid
    want = _run_jax(monkeypatch, fn, jnp.asarray(rec), jnp.asarray(tile_map))
    port_map = micro_floor.linear_tile_map(grid, N_TILES)
    np.testing.assert_array_equal(port_map.numpy(), tile_map)
    trace.reset_launch_counts()
    got = micro_floor.micro_floor_linear(sblock, torch.as_tensor(rec),
                                         port_map, N_TILES).numpy()
    assert not any(trace.launch_counts.values())
    assert got.shape == want[0].shape == (N_TILES, 512, 12)
    formula = _formula(rec, [(b, v, None) for v, b in enumerate(tile_map)],
                       sblock, N_TILES)
    np.testing.assert_allclose(got, formula, rtol=RTOL, atol=0)
    _close(got, want[0])
    visited = np.bincount(tile_map, minlength=N_TILES) > 0
    assert (got[visited] > 0).all() and not got[~visited].any()


def test_floor_wrappers_refuse(data):
    """Unknown variants and widths raise; the ``*_cuda`` wrappers launch or
    raise, never a plain fallback; visits outside rec or the tiles
    raise."""
    rec, tile_of, chunk_of, first = map(torch.as_tensor, data)
    with pytest.raises(ValueError):
        micro_floor.micro_floor_visit("roll", rec, tile_of, chunk_of, first,
                                      N_TILES)
    with pytest.raises(ValueError):
        micro_floor.micro_floor_visit("alldone", rec, tile_of, chunk_of,
                                      first, 2)
    with pytest.raises(ValueError):
        micro_floor.micro_floor_visit("base", rec, tile_of, chunk_of + 99,
                                      first, N_TILES)
    with pytest.raises(ValueError):
        micro_floor.micro_floor_visit_cuda("base", rec, tile_of, chunk_of,
                                           first, N_TILES)
    tile_map = micro_floor.linear_tile_map(N_CHUNKS, N_TILES)
    with pytest.raises(ValueError):
        micro_floor.micro_floor_linear(64, rec, tile_map, N_TILES)
    with pytest.raises(ValueError):
        micro_floor.micro_floor_linear(256, rec, tile_map, N_TILES)
    with pytest.raises(ValueError):
        micro_floor.micro_floor_linear_cuda(128, rec, tile_map, N_TILES)


@pytest.mark.parametrize("real_only", [False, True])
@pytest.mark.parametrize("variant", ["base", "static_out", "prefetch2"])
def test_visit_csr_lists_each_blocks_steps_in_stream_order(data, variant,
                                                          real_only):
    """The CSR the kernel walks: block t's steps, in stream order, at
    order[offsets[t]:offsets[t + 1]]; with ``real_only`` the steps that
    neither zero nor add (the padding, first −1) are left out, except under
    ``prefetch2``, where every step adds."""
    rec, tile_of, chunk_of, first = data
    order, offsets = micro_floor.visit_csr(
        variant, *map(torch.as_tensor, (rec, tile_of, chunk_of, first)),
        N_TILES, real_only=real_only)
    assert order.dtype == offsets.dtype == torch.int32
    blocks = np.zeros_like(tile_of) if variant == "static_out" else tile_of
    kept = np.ones(VCAP, bool) if variant == "prefetch2" or not real_only \
        else first >= 0
    assert offsets.numpy()[-1] == kept.sum()
    assert kept.sum() < VCAP or not real_only or variant == "prefetch2"
    for t in range(N_TILES):
        want = np.flatnonzero((blocks == t) & kept)
        np.testing.assert_array_equal(
            order.numpy()[offsets[t]:offsets[t + 1]], want)
