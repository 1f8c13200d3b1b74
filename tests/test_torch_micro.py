"""Port vs JAX: the micro-probes T3 (``micro_reduce``) and T4
(``micro_prefix``), as their plain PyTorch versions, and the refusals of
every measurement-tool wrapper.

* T3 against the Pallas kernel of ``tools/micro_reduce.py`` (``build``, in
  interpret mode, at NV = 8 blocks): f32 modes within 1e-5 relative (the
  sums are taken in another order). The ``mma`` mode rounds x and the
  weights to bf16 as its tensor-core kernel does, while the CPU
  interpreter takes Precision.DEFAULT at f32: within 2^-7 relative (two
  roundings of ≤ 2^-9 each, and a rounding of the sum).
* T4 against the Pallas kernel of ``tools/micro_prefix.py``, a closure
  inside ``main`` taken from the tool's own ``pl.pallas_call`` and run in
  interpret mode on 2 tiles of 66 chunks: ``serial`` and ``mma_3xtf32``
  against ``highest``, ``warpscan`` against ``roll``, ``mma_bf16`` and
  ``mma_bf16x2`` against ``default`` and ``split2``. The CPU interpreter
  takes Precision.DEFAULT at f32, so the test rounds a DEFAULT product's
  operands to bf16 as the TPU's one MXU pass does. The f32 modes agree
  within 1e-6 of each channel's largest magnitude (another summation
  order). The bf16 modes within 1e-4: XLA's and torch's exp and log1p
  differ in the last bit on ~0.5% of the operands, and where that flips a
  bf16 rounding (one log1p(−w0) of the 8.65M here) the pixel's later
  transmittances move by up to 2^-8 of the term; that one flip moved
  channel 4 by 1.0e-5 of its largest value.
"""

import functools
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "tools"))

import micro_prefix as jmicro_prefix  # noqa: E402
import micro_reduce as jmicro_reduce  # noqa: E402
from streetunveiler_torch import trace  # noqa: E402
from streetunveiler_torch.ops.rasterizer import cuda_lib  # noqa: E402
from streetunveiler_torch.tools import micro_prefix, micro_reduce  # noqa: E402

torch.set_num_threads(1)

NV = 8
JAX_MODE = {"pair": "pair", "thread": "vpu", "warp": "vpu", "mma": "mxu"}
CHUNKS = 132
JAX_PREFIX_MODE = {"serial": "highest", "warpscan": "roll",
                   "mma_bf16": "default", "mma_bf16x2": "split2",
                   "mma_3xtf32": "highest"}


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(0).random((512, NV * 128)).astype(
        np.float32)


@pytest.mark.parametrize("mode,k", micro_reduce.MODES)
def test_micro_reduce_plain_matches_jax_tool(x, monkeypatch, mode, k):
    outs, pallas_call = [], pl.pallas_call

    def capture(*a, **kw):
        call = pallas_call(*a, interpret=True, **kw)

        def run(*args):
            out = call(*args)
            outs.append(np.array(out))
            return out
        return run

    monkeypatch.setattr(jmicro_reduce, "NV", NV)
    monkeypatch.setattr(jmicro_reduce, "ITERS", 1)
    monkeypatch.setattr(jmicro_reduce.pl, "pallas_call", capture)
    with jax.disable_jit():
        jmicro_reduce.build(JAX_MODE[mode], k)(jnp.asarray(x))
    want = outs[0]                  # the first call's input is x itself
    trace.reset_launch_counts()
    got = micro_reduce.micro_reduce(mode, k, torch.as_tensor(x)).numpy()
    assert not any(trace.launch_counts.values())
    assert got.shape == want.shape == (512, 128)
    cols = 1 if mode == "pair" else k
    assert not got[:, cols:].any() and not want[:, cols:].any()
    rtol = 2.0 ** -7 if mode == "mma" else 1e-5
    np.testing.assert_allclose(got[:, :cols], want[:, :cols], rtol=rtol)


class _Captured(Exception):
    """Raised by the stand-in ``pallas_call`` once it holds the kernel."""


@pytest.fixture(scope="module")
def prefix_kern():
    """The Pallas kernel of ``tools/micro_prefix.py`` (the closure ``kern``
    :43-102 inside ``main``) and the tool's grid spec, taken from its first
    ``pl.pallas_call`` (:105), which raises before anything runs; the
    tool's 207 MB input is drawn at one chunk instead."""
    got = {}

    def capture(kernel, **kw):
        got.update(kern=kernel.func, grid_spec=kw["grid_spec"])
        raise _Captured

    small = types.SimpleNamespace(
        float32=np.float32, random=types.SimpleNamespace(
            default_rng=lambda seed: types.SimpleNamespace(
                standard_normal=lambda shape, dtype: np.zeros(
                    (shape[0], 128), dtype))))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", capture)
        mp.setattr(jmicro_prefix, "np", small)
        with pytest.raises(_Captured):
            jmicro_prefix.main()
    return got


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


@pytest.fixture(scope="module")
def rec():
    return np.random.default_rng(0).standard_normal(
        (24, CHUNKS * 128), dtype=np.float32)


@pytest.fixture(scope="module")
def jax_prefix(prefix_kern, rec):
    """The tool's kernel in interpret mode on ``rec``, per TPU mode, with
    the tool's block specs at CHUNKS chunks (2 tiles of 66)."""
    outs = {}

    def run(mode):
        if mode not in outs:
            gs = prefix_kern["grid_spec"]
            call = pl.pallas_call(
                functools.partial(prefix_kern["kern"], mode=mode),
                grid_spec=pltpu.PrefetchScalarGridSpec(
                    num_scalar_prefetch=0, grid=(CHUNKS,),
                    in_specs=gs.in_specs, out_specs=gs.out_specs),
                out_shape=[jax.ShapeDtypeStruct((CHUNKS // 66, 512, 16),
                                                jnp.float32)],
                interpret=True)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax.lax, "dot_general",
                           _tpu_default_dot(jax.lax.dot_general))
                outs[mode] = np.array(call(jnp.asarray(rec))[0])
        return outs[mode]
    return run


@pytest.mark.parametrize("mode", micro_prefix.MODES)
def test_micro_prefix_plain_matches_formula(rec, jax_prefix, mode):
    want = jax_prefix(JAX_PREFIX_MODE[mode])
    trace.reset_launch_counts()
    got = micro_prefix.micro_prefix(mode, torch.as_tensor(rec)).numpy()
    assert not any(trace.launch_counts.values())
    assert got.shape == want.shape == (2, 512, 16)
    scale = np.abs(want).max(axis=(0, 1))
    assert scale.min() > 0
    err = np.abs(got - want).max(axis=(0, 1)) / scale
    tol = 1e-4 if mode in ("mma_bf16", "mma_bf16x2") else 1e-6
    assert err.max() <= tol, (mode, err.tolist())


def test_micro_wrappers_raise_on_cpu_tensors(x, rec):
    """The ``*_cuda`` wrappers launch or raise: never a plain fallback."""
    with pytest.raises(ValueError):
        micro_reduce.micro_reduce_cuda("thread", 4, torch.as_tensor(x))
    with pytest.raises(ValueError):
        micro_reduce.micro_reduce_cuda("mma", 4, torch.as_tensor(x))
    with pytest.raises(ValueError):
        micro_prefix.micro_prefix_cuda("serial", torch.as_tensor(rec))
    with pytest.raises(ValueError):
        micro_prefix.micro_prefix("roll", torch.as_tensor(rec))


def test_load_library_raises_without_nvcc(tmp_path, monkeypatch):
    """Without a built library and without nvcc, loading the kernels
    raises; nothing falls back to the plain versions."""
    monkeypatch.setattr(cuda_lib, "_lib", None)
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_lib.load_library()
