"""Port vs JAX: the bisection tools' kernels T1 (blend forward variants)
and T2 (blend backward variants), as their plain PyTorch versions.

On the 600-surfel miniature of the street scene (``bench.build_scene``,
128×96, the full-width field of view with the splats scaled by 1920/128),
binned and gathered by the JAX package, each plain variant is held against
the Pallas kernel of ``tools/bisect_fwd.py`` / ``tools/bisect_bwd.py`` of
the same name, run in interpret mode:

* T1: each accumulator channel within 1e-4 of the channel's largest
  magnitude (at least 1) over the pixels whose lk agrees, lk on all but
  0.1% of pixels (the knife-edge of early termination, as in
  ``tests/test_torch_blend.py``). ``full_nopair``'s stand-in α is
  unbounded, so its sums reach ~1e7 and cancel: 1e-3 there.
* T2: each record row within 1e-4 of the ``full`` variant's largest
  gradient on that row, on the slots below the stream's total (the Pallas
  kernel leaves later slots unwritten).

The TPU's ``full_noexp``/``no_exp`` linearised another exp than the port's,
so those two are held against the Pallas ``full`` with the JAX package's
exp swapped in the test: ``blendmath``'s exp(x) → 1 + x for T1, and for T2
``log1p(−α)`` → −log1p(α), which turns the exp-of-log suffix into the
port's T = U·(1+α). The five TPU-only T1 variants compute ``full``'s output
by another formulation and are held against the port's ``full``.
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
from jax.experimental.pallas import tpu as pltpu

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import bisect_bwd as jbisect_bwd  # noqa: E402
import bisect_fwd as jbisect_fwd  # noqa: E402
from bench import build_scene  # noqa: E402
from streetunveiler_tpu.ops.rasterizer import RasterizeSettings as JSettings  # noqa: E402
from streetunveiler_tpu.ops.rasterizer import api as japi  # noqa: E402
from streetunveiler_tpu.ops.rasterizer import blendmath as jblendmath  # noqa: E402
from streetunveiler_tpu.ops.rasterizer import kernel as jkernel  # noqa: E402
from streetunveiler_tpu.ops.rasterizer import tiles as jtiles  # noqa: E402
from streetunveiler_tpu.ops.rasterizer.preprocess import \
    preprocess_surfels as jpre  # noqa: E402
from streetunveiler_torch import trace  # noqa: E402
from streetunveiler_torch.ops.rasterizer import RasterizeSettings, kernel  # noqa: E402
from streetunveiler_torch.tools import bisect_bwd, bisect_fwd, street  # noqa: E402

torch.set_num_threads(1)

FLIP_FRACTION = 1e-3
ZNEAR, ZFAR = 0.2, 100.0


class _Swapped:
    """``jax.numpy`` with one function replaced (a module's ``jnp``)."""

    def __init__(self, **fns):
        self.fns = fns

    def __getattr__(self, name):
        return self.fns.get(name, getattr(jnp, name))


@pytest.fixture(scope="module")
def stream():
    """The JAX package's binning, records, visits and production forward
    on the miniature street, and the port's arguments on the same data."""
    mini = street.MINI
    pts, scales, quats, opac, cols, _ = build_scene(mini["n"])
    scales = scales * np.float32(mini["scale"])
    w, h, f = mini["width"], mini["height"], mini["focal"]
    K = jnp.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], jnp.float32)
    st = JSettings(width=w, height=h, znear=ZNEAR, zfar=ZFAR)
    n = pts.shape[0]

    @jax.jit
    def binning(*scene):
        sur = jpre(*scene, jnp.eye(4), K, st)
        b = jtiles.bin_surfels_stream(
            sur.center2d, sur.ext, sur.depth, sur.valid, w, h,
            jkernel.TILE_W, jkernel.TILE_H,
            japi.default_duplicate_capacity(n, w, h), cull=sur.cull,
            interpret=True)
        return b, japi._gather_records(jkernel.pack_geometry_T(sur, n),
                                       b.sorted_surfel)

    b, recT = binning(*map(jnp.asarray, (pts, scales, quats, opac, cols)))
    tiles_x, tiles_y = int(b.tiles_x), int(b.tiles_y)
    acc, lk = jax.jit(lambda recT, b: jkernel._blend_fwd_call(
        recT, b.tile_of_visit, b.chunk_of_visit, b.first_of_tile, b.lane_lo,
        b.lane_hi, tiles_x * tiles_y, tiles_x, st, True))(recT, b)
    dacc = bisect_bwd.cotangents(torch.as_tensor(np.array(acc)), 6, 0)
    port = (torch.as_tensor(np.array(recT)),
            torch.as_tensor(np.array(b.tile_offsets)), tiles_x, tiles_y,
            RasterizeSettings(width=w, height=h, znear=ZNEAR, zfar=ZFAR))
    return dict(b=b, recT=recT, acc=acc, lk=lk, dacc=dacc, port=port,
                total=int(b.tile_offsets[-1]))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _jax_fwd(s, variant):
    b = s["b"]
    n_tiles = s["port"][2] * s["port"][3]
    call = jbisect_fwd.build_call(variant, b.tile_of_visit.shape[0], n_tiles,
                                  s["port"][2], ZNEAR, ZFAR)
    out = jax.jit(call)(b.tile_of_visit, b.chunk_of_visit, b.first_of_tile,
                        b.lane_lo, b.lane_hi, s["recT"])
    return np.array(out[0]), (np.array(out[1]) if len(out) > 1 else None)


def _jax_bwd(s, variant):
    """tools/bisect_bwd.py:198-231's call of ``make_kernel``."""
    b = s["b"]
    vcap = b.tile_of_visit.shape[0]
    cap = s["recT"].shape[1]
    rev = lambda g: vcap - 1 - g
    rec_spec = pl.BlockSpec((jkernel.REC, jkernel.S_CHUNK),
                            lambda g, t, c, l, ir, lo_, hi_: (0, c[rev(g)]),
                            memory_space=pltpu.VMEM)
    pix_spec = lambda w: pl.BlockSpec(
        (1, jkernel.PIX, w), lambda g, t, c, l, ir, lo_, hi_: (t[rev(g)], 0, 0),
        memory_space=pltpu.VMEM)
    kern = jbisect_bwd.make_kernel(variant, vcap, s["port"][2], ZNEAR, ZFAR)
    call = pl.pallas_call(
        kern,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=6, grid=(vcap,),
            in_specs=[rec_spec, pix_spec(jkernel.CH), pix_spec(1),
                      pix_spec(jkernel.CH)],
            out_specs=[rec_spec],
            scratch_shapes=[pltpu.VMEM((jkernel.PIX, 8), jnp.float32)]),
        out_shape=[jax.ShapeDtypeStruct((jkernel.REC, cap), jnp.float32)],
    )
    out = jax.jit(call)(b.tile_of_visit, b.chunk_of_visit, b.last_of_tile, b.init_rev,
      b.lane_lo, b.lane_hi, s["recT"], s["acc"], s["lk"],
      jnp.asarray(s["dacc"].numpy()))[0]
    return np.array(out)


FWD_CASES = bisect_fwd.VARIANTS + bisect_fwd.TPU_ONLY


@pytest.mark.parametrize("variant", FWD_CASES)
def test_bisect_fwd_plain_matches_jax_tool(stream, interpret, monkeypatch,
                                           variant):
    jax_variant = variant
    if variant == "full_noexp":
        jax_variant = "full"
        monkeypatch.setattr(jblendmath, "jnp",
                            _Swapped(exp=lambda x: 1.0 + x))
    want_acc, want_lk = _jax_fwd(stream, jax_variant)
    port_variant = "full" if variant in bisect_fwd.TPU_ONLY else variant
    trace.reset_launch_counts()
    acc, lk = bisect_fwd.bisect_forward_plain(port_variant, *stream["port"],
                                              tile_batch=2)
    assert not any(trace.launch_counts.values())
    acc = acc.numpy()
    assert acc.shape == want_acc.shape
    if want_lk is None:
        assert lk is None
        same = np.ones(acc.shape[:2], bool)
    else:
        lk_ok = lk.numpy() == want_lk
        assert 1.0 - lk_ok.mean() <= FLIP_FRACTION, variant
        same = lk_ok[..., 0]
    scale = np.maximum(1.0, np.abs(want_acc).max(axis=(0, 1)))
    tol = 1e-3 if variant == "full_nopair" else 1e-4
    err = np.abs(acc - want_acc)[same].max(axis=0) / scale
    assert err.max() <= tol, (variant, err.tolist())


@pytest.mark.parametrize("variant", bisect_bwd.VARIANTS)
def test_bisect_bwd_plain_matches_jax_tool(stream, interpret, monkeypatch,
                                           variant):
    if "bwd_full" not in stream:
        stream["bwd_full"] = _jax_bwd(stream, "full")[:, :stream["total"]]
    scale = np.abs(stream["bwd_full"]).max(axis=1)
    if variant == "full":
        want = stream["bwd_full"]
    elif variant == "no_exp":
        monkeypatch.setattr(jbisect_bwd, "jnp",
                            _Swapped(log1p=lambda x: -jnp.log1p(-x)))
        want = _jax_bwd(stream, "full")[:, :stream["total"]]
    else:
        want = _jax_bwd(stream, variant)[:, :stream["total"]]
    args = stream["port"] + (torch.as_tensor(np.array(stream["acc"])),
                             torch.as_tensor(np.array(stream["lk"])),
                             stream["dacc"], 6, 0)
    trace.reset_launch_counts()
    got = bisect_bwd.bisect_backward_plain(variant, *args, tile_batch=2)
    assert not any(trace.launch_counts.values())
    got = got.numpy()
    assert np.isfinite(want).all()
    assert not got[:, stream["total"]:].any()
    err = np.abs(got[:, :stream["total"]] - want).max(axis=1) / scale
    assert err.max() <= 1e-4, (variant, err.tolist())


@pytest.fixture(scope="module")
def port_streams():
    """The port's own binning of the miniature: photometric (nq 6) and
    late (nq 12, G 5) records, with the production forward's acc and lk."""
    mini = street.MINI
    state = street.street_state(mini["n"], device="cpu", scale=mini["scale"])
    cam = street.street_camera("cpu", mini["width"], mini["height"],
                               mini["focal"])
    out = {}
    for late in (False, True):
        s = street.street_stream(state, cam, late=late, device="cpu")
        acc, lk = kernel.blend_forward_plain(*s, tile_batch=2)
        out[s[6]] = (s, acc, lk)
    return out


@pytest.fixture(scope="module")
def t1_plain():
    """``bisect_forward_plain`` memoised on (variant, stream), for the
    tests that share its outputs."""
    memo = {}

    def run(variant, s):
        key = (variant, s[5], s[6])
        if key not in memo:
            memo[key] = bisect_fwd.bisect_forward_plain(variant, *s,
                                                        tile_batch=2)
        return memo[key]
    return run


@pytest.mark.parametrize("n_gates", [0, 5])
def test_plain_full_equals_production(port_streams, t1_plain, n_gates):
    """T1's and T2's plain ``full`` are the production plain K1 and K2,
    up to the order of their chunked products (1e-5 of each channel's or
    row's largest magnitude; lk and every lk_g exact)."""
    s, acc, lk = port_streams[n_gates]
    nq = s[5]
    got_acc, got_lk = t1_plain("full", s)
    np.testing.assert_array_equal(got_lk.numpy(), lk.numpy())
    scale = acc.abs().amax(dim=(0, 1)).clamp(min=1.0)
    assert float(((got_acc - acc).abs().amax(dim=(0, 1)) / scale).max()) \
        <= 1e-5
    a = s[:5] + (acc, lk, bisect_bwd.cotangents(acc, nq, n_gates), nq,
                 n_gates)
    want = kernel.blend_backward_plain(*a, tile_batch=2)
    got = bisect_bwd.bisect_backward_plain("full", *a, tile_batch=2)
    row = want.abs().amax(dim=1).clamp(min=1e-30)
    assert float(((got - want).abs().amax(dim=1) / row).max()) <= 1e-5


def test_gated_variants_keep_the_main_chain(port_streams, t1_plain):
    """At G = 5 the T1 variants with their own chain rules keep the main
    channels and lk of the same variant without gates (the main chain never
    reads the gates), and the floor fills every channel alike."""
    s, _, _ = port_streams[5]
    ungated = s[:6] + (0,)
    ch = kernel.ch_for(s[5])
    for v in ("full", "floor", "full_noprefix", "full_notrigger",
              "full_nosums", "full_nolkmax"):
        acc, lk = t1_plain(v, s)
        acc0, lk0 = t1_plain(v, ungated)
        assert acc.shape[-1] == ch + 4 * 5
        np.testing.assert_array_equal(acc[..., :ch].numpy(),
                                      acc0.numpy(), err_msg=v)
        if lk is not None:
            np.testing.assert_array_equal(lk.numpy(), lk0.numpy(), err_msg=v)
        if v in bisect_fwd.FLOORS:
            assert bool((acc == acc[..., :1]).all())


def test_wrappers_raise_on_cpu_tensors(stream):
    """The ``*_cuda`` wrappers launch or raise: never a plain fallback."""
    recT, off, tx, ty, st = stream["port"]
    with pytest.raises(ValueError):
        bisect_fwd.bisect_forward_cuda("full", recT, off, tx, ty, st)
    acc = torch.as_tensor(np.array(stream["acc"]))
    lk = torch.as_tensor(np.array(stream["lk"]))
    with pytest.raises(ValueError):
        bisect_bwd.bisect_backward_cuda("full", recT, off, tx, ty, st, acc,
                                        lk, stream["dacc"])
    with pytest.raises(ValueError):
        bisect_fwd.bisect_forward_cuda("full_kogge", recT, off, tx, ty, st)
    with pytest.raises(ValueError):
        bisect_bwd.bisect_backward_cuda("full", recT, off, tx, ty, st, acc,
                                        lk, stream["dacc"], nq=9)


def test_street_scene_is_the_bench_scene():
    """The package's street scene, which ``chip_smoke.py`` and the tools
    build, is ``bench.py``'s, output for output."""
    for got, want in zip(street.build_scene(1000, seed=3),
                         build_scene(1000, seed=3)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
