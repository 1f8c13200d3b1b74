"""Port vs JAX: the probes T7 (``probe_compose4``'s identity of a stack),
T8 (``probe_tax``'s identity) and T9 (``probe_mmt3``'s split-precision
contraction), as their plain PyTorch versions, the probes' path as a
whole, and the refusals of their wrappers.

* T7 and T8 bit for bit against ``pallas_identity`` / ``_pallas_identity``
  of the tools in interpret mode.
* The path, on the 600-surfel miniature of the street (``street.MINI``):
  the port's binning → identity → record gather → blend equals its
  unlaundered path bit for bit in every mode of both probes, and agrees
  with the JAX path (binning, ``pallas_identity`` of the seven visit
  arrays, gather, ``blend_stream(..., interpret=True)``) within the
  tolerances of ``tests/test_kernel.py:46-53`` per accumulator channel,
  on the tiles the stream visits (JAX leaves the others undefined), with
  early termination's knife-edge allowed at 0.1% of pixels. The median
  depth (up to 80 on the street, where test_kernel's 1e-5 is about an
  ulp) is held within 1e-5 relative, as ``tests/test_torch_blend.py``'s
  ``assert_median_close`` holds it everywhere: t = det/kz cancels on the
  grazing ground plane, and 0.6% of the pixels differ by 1e-6 to 5.7e-6
  relative.
* T9 against the tool's kernel in interpret mode on the tool's inputs,
  with a DEFAULT product's operands rounded to bf16 as the TPU's one MXU
  pass does (the CPU interpreter takes DEFAULT at f32): within 1e-6
  relative (sums in another order).
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import streetunveiler_torch  # noqa: E402
from bench import build_scene  # noqa: E402
from streetunveiler_tpu.ops.rasterizer import RasterizeSettings as JSettings  # noqa: E402
from streetunveiler_tpu.ops.rasterizer import api as japi  # noqa: E402
from streetunveiler_tpu.ops.rasterizer import kernel as jkernel  # noqa: E402
from streetunveiler_tpu.ops.rasterizer import tiles as jtiles  # noqa: E402
from streetunveiler_tpu.ops.rasterizer.preprocess import \
    preprocess_surfels as jpre  # noqa: E402
from streetunveiler_torch import trace  # noqa: E402
from streetunveiler_torch.tools import (probe_compose4, probe_mmt3,  # noqa: E402
                                        probe_tax, street)

# the JAX tools put their own directories first on the import path when
# imported; both packages are imported above from this checkout, and the
# path is put back as it was
_saved_path = list(sys.path)
import probe_compose4 as jcompose4  # noqa: E402
import probe_mmt3 as jmmt3  # noqa: E402
import probe_tax as jtax  # noqa: E402
sys.path[:] = _saved_path

torch.set_num_threads(1)

FLIP_FRACTION = 1e-3
MINI = {k: street.MINI[k] for k in ("n", "width", "height", "focal",
                                    "scale")}


def test_imports_come_from_this_checkout():
    for mod in (streetunveiler_torch, jkernel, jmmt3, jtax, jcompose4):
        assert os.path.abspath(mod.__file__).startswith(ROOT + os.sep), mod


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("n", [1000, 1024, 4801])
def test_identity_copy_matches_pallas_identity(interpret, n):
    x = np.random.default_rng(n).integers(-2 ** 31, 2 ** 31 - 1, n,
                                          dtype=np.int32)
    want = np.array(jtax._pallas_identity(jnp.asarray(x)))
    trace.reset_launch_counts()
    got = probe_tax.identity_copy(torch.as_tensor(x))
    assert not any(trace.launch_counts.values())
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), x)


def test_identity_copy_stack_matches_pallas_identity(interpret):
    xs = np.random.default_rng(7).integers(-2 ** 31, 2 ** 31 - 1,
                                           (7, 1000), dtype=np.int32)
    want = jcompose4.pallas_identity(*map(jnp.asarray, xs))
    trace.reset_launch_counts()
    got = probe_compose4.identity_copy_stack(*map(torch.as_tensor, xs))
    assert not any(trace.launch_counts.values())
    assert len(got) == len(want) == 7
    for g, w, x in zip(got, want, xs):
        np.testing.assert_array_equal(g.numpy(), np.array(w))
        np.testing.assert_array_equal(g.numpy(), x)


@pytest.fixture(scope="module")
def port_ctx():
    return street.probe_inputs(**MINI, device="cpu")


@pytest.fixture(scope="module")
def jax_path():
    """The JAX path of ``tools/probe_compose4.py`` (its ``full`` mode) on
    the miniature: binning, ``pallas_identity`` of the visit arrays,
    gather, ``blend_stream`` in interpret mode."""
    pts, scales, quats, opac, cols, _ = build_scene(MINI["n"])
    scales = scales * np.float32(MINI["scale"])
    w, h, f = MINI["width"], MINI["height"], MINI["focal"]
    K = jnp.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], jnp.float32)
    st = JSettings(width=w, height=h, znear=0.2, zfar=100.0)
    n = pts.shape[0]

    @jax.jit
    def binning(*scene):
        sur = jpre(*scene, jnp.eye(4), K, st)
        b = jtiles.bin_surfels_stream(
            sur.center2d, sur.ext, sur.depth, sur.valid, w, h,
            jkernel.TILE_W, jkernel.TILE_H,
            japi.default_duplicate_capacity(n, w, h), 64, cull=sur.cull,
            interpret=True)
        return b, jkernel.pack_geometry_T(sur, n)

    b, packT = binning(*map(jnp.asarray, (pts, scales, quats, opac, cols)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        va = jcompose4.pallas_identity(
            b.tile_of_visit, b.chunk_of_visit, b.first_of_tile,
            b.last_of_tile, b.init_rev, b.lane_lo, b.lane_hi)
    recT = jnp.take(packT, b.sorted_surfel, axis=1)
    tiles_x, tiles_y = int(b.tiles_x), int(b.tiles_y)
    acc, lk = jax.jit(lambda recT, *va: jkernel.blend_stream(
        recT, *va, tiles_x * tiles_y, tiles_x, st, True))(recT, *va)
    return dict(acc=np.array(acc), lk=np.array(lk),
                tile_offsets=np.array(b.tile_offsets),
                sorted_surfel=np.array(b.sorted_surfel))


def test_probe_path_laundered_equals_plain_and_jax(port_ctx, jax_path):
    trace.reset_launch_counts()
    outs = {m: probe_compose4.make(m, port_ctx)()
            for m in probe_compose4.MODES}
    outs.update({f"tax_{v}_x{c}": probe_tax.make(v, c, port_ctx)()
                 for v, c in probe_tax.VARIANTS})
    assert not any(trace.launch_counts.values())
    acc, lk = outs["k_bin"]
    for mode, (a, k) in outs.items():
        assert torch.equal(a, acc) and torch.equal(k, lk), mode
    # the port's binning is JAX's, exactly
    off = port_ctx.binning.tile_offsets.numpy()
    np.testing.assert_array_equal(off, jax_path["tile_offsets"])
    total = int(off[-1])
    np.testing.assert_array_equal(
        port_ctx.binning.sorted_surfel.numpy()[:total],
        jax_path["sorted_surfel"][:total])
    visited = np.diff(off) > 0
    assert visited.sum() >= 12
    acc, lk = acc.numpy()[visited], lk.numpy()[visited]
    jacc, jlk = jax_path["acc"][visited], jax_path["lk"][visited]
    lk_ok = lk == jlk
    assert 1.0 - lk_ok.mean() <= FLIP_FRACTION
    same = lk_ok[..., 0]
    nq = 6
    tol = [5e-5] * nq + [2e-5, 5e-4, 0.0, 5e-5, 5e-5]
    for c in range(nq + 5):
        err = np.abs(acc[..., c] - jacc[..., c])[same]
        assert err.max() <= tol[c], (c, float(err.max()))
    med, jmed = acc[..., nq + 5][same], jacc[..., nq + 5][same]
    # the median is t = det/kz of one pair; on the street's grazing
    # ground it cancels, and XLA and torch round det and kz differently
    np.testing.assert_allclose(med, jmed, rtol=1e-5, atol=1e-5)
    assert float(jacc[..., nq].max()) > 0.5


def _tpu_default_dot(dot_general):
    """``lax.dot_general`` as a TPU takes it: at Precision.DEFAULT both
    operands rounded to bf16 (one MXU pass), products summed in f32."""
    def dot(a, b, dimension_numbers, precision=None,
            preferred_element_type=None):
        if precision in (None, jax.lax.Precision.DEFAULT):
            a = a.astype(jnp.bfloat16).astype(jnp.float32)
            b = b.astype(jnp.bfloat16).astype(jnp.float32)
        return dot_general(a, b, dimension_numbers,
                           precision=jax.lax.Precision.HIGHEST,
                           preferred_element_type=preferred_element_type)
    return dot


def test_mmt3_plain_matches_jax_tool(monkeypatch, capsys):
    got_in, got_out, pallas_call = [], [], pl.pallas_call

    def capture(*a, **kw):
        call = pallas_call(*a, interpret=True, **kw)

        def run(*args):
            got_in.extend(np.array(x) for x in args)
            out = call(*args)
            got_out.extend(np.array(o) for o in out)
            return out
        return run

    monkeypatch.setattr(jmmt3.pl, "pallas_call", capture)
    monkeypatch.setattr(jax.lax, "dot_general",
                        _tpu_default_dot(jax.lax.dot_general))
    jmmt3.main()
    assert "max rel err vs VPU truth" in capsys.readouterr().out
    w, b = probe_mmt3.make_inputs("cpu")
    np.testing.assert_array_equal(w.numpy(), got_in[0])
    np.testing.assert_array_equal(b.numpy(), got_in[1])
    trace.reset_launch_counts()
    outs = probe_mmt3.mmt3(w, b)
    assert not any(trace.launch_counts.values())
    assert len(outs) == len(got_out) == 4
    for name, g, want in zip(probe_mmt3.WAYS + ("truth",), outs, got_out):
        assert g.shape == want.shape == (512, 7), name
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-6, err_msg=name)
    err = probe_mmt3.truth_errors(outs)
    assert all(0 < e <= 2.0 ** -14 for e in err.values()), err
    # the lo·lo term is dropped: a, b and c agree to the bit
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_hi8_matches_jax():
    x = np.concatenate([
        np.random.default_rng(3).standard_normal(4096).astype(np.float32),
        np.array([0.0, -0.0, 1e-40, -1e-40, 3.4e38, np.inf, -np.inf],
                 np.float32)])
    want = np.array(jkernel._hi8(jnp.asarray(x)))
    got = probe_mmt3.hi8(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_probe_wrappers_refuse(port_ctx):
    """The ``*_cuda`` wrappers launch or raise, never a plain fallback;
    unknown modes, variants, shapes and ``--hlo`` raise."""
    x = torch.arange(300, dtype=torch.int32)
    with pytest.raises(ValueError):
        probe_tax.identity_copy_cuda(x)
    with pytest.raises(ValueError):
        probe_tax.copy_cuda(probe_tax.pad_lanes(x))
    with pytest.raises(ValueError):
        probe_tax.identity_copy(x.float())
    with pytest.raises(ValueError):
        probe_compose4.identity_copy_stack_cuda(x, x)
    with pytest.raises(ValueError):
        probe_compose4.identity_copy_stack(x, x[:-1])
    with pytest.raises(ValueError):
        probe_compose4.make("k_bin_launder2", port_ctx)
    with pytest.raises(ValueError):
        probe_tax.make("launder", 2, port_ctx)
    with pytest.raises(SystemExit, match="HLO"):
        probe_tax.main(["--hlo", "--device", "cpu"])
    w, b = probe_mmt3.make_inputs("cpu")
    with pytest.raises(ValueError):
        probe_mmt3.mmt3_cuda(w, b)
    with pytest.raises(ValueError):
        probe_mmt3.mmt3(w, b[:7])


@pytest.mark.parametrize("tool", ["micro_floor", "probe_compose4",
                                  "probe_tax", "probe_mmt3"])
def test_probe_entry_points_default_to_the_card(tool):
    """Without ``--device cpu`` each probe's main needs a CUDA device and
    raises where there is none, before it builds anything."""
    import importlib
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: main would run on it")
    main = importlib.import_module(f"streetunveiler_torch.tools.{tool}").main
    with pytest.raises(RuntimeError, match="CUDA"):
        main([])
