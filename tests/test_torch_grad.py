"""Port vs JAX: gradients through the port's ``rasterize``.

A loss over every output that carries gradient (colour with background,
alpha, expected depth, normal, distortion), differentiated with respect
to the five inputs and ``center2d_offset`` (the screen-space gradient
densification reads): the port's tiled path (preprocess → binning →
gather → K1/K2 plain versions → scatter) against JAX
``rasterize(interpret=True)`` and against the port's differentiable
untiled oracle, on the kernel-test scene, on a dense occlusion stack and
with empty tiles.

Tolerances: ``tests/test_kernel.py:86`` (atol 2e-4·max|g|, rtol 1e-3);
on the dense stack the relative l2 bound of ``tests/test_kernel.py:264``
(2e-4), because its gradients are sums of large cancelling per-pair
terms.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streetunveiler_tpu.ops.rasterizer import RasterizeSettings as JSettings
from streetunveiler_tpu.ops.rasterizer import rasterize as jrasterize
from streetunveiler_torch.ops.rasterizer import (RasterizeSettings,
                                                 rasterize, rasterize_oracle)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("means", "scales", "quats", "opacity", "colors", "center2d_offset")


def random_scene(n=300, seed=0, W=64, H=48, f=50.0):
    """The scene of tests/test_kernel.py:18."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                      rng.uniform(3.0, 12.0, n)], 1).astype(np.float32)
    scales = rng.uniform(0.05, 0.6, (n, 2)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.05, 0.95, n).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return (means, scales, quats, opac, cols), K, (W, H)


def dense_scene():
    """tools/verify_device_parity.py's tame dense stack (the scene of
    tests/test_kernel.py:264): deep, mostly opaque, no grazing monsters."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from verify_device_parity import dense_scene as jdense
    args, _, K, st = jdense(n=1500, tame=True)
    return (tuple(np.array(a) for a in args), np.array(K),
            (st.width, st.height))


def empty_tile_scene():
    """Every surfel in the top-left quarter of a 128x96 image."""
    args, K, _ = random_scene(n=40, W=128, H=96)
    means = args[0].copy()
    means[:, 0] = -np.abs(means[:, 0]) * 0.5 - 1.0
    means[:, 1] = -np.abs(means[:, 1]) * 0.5 - 1.0
    return (means,) + args[1:], K, (128, 96)


def _loss_terms(out, tgt):
    """Every output that carries gradient (color with background, alpha,
    expected depth, normal, distortion)."""
    return ((out.color - tgt) ** 2).sum() + 0.3 * out.distortion.sum() \
        + 0.1 * (out.normal ** 2).sum() + 0.05 * out.expected_depth.sum() \
        + 0.2 * out.alpha.sum()


def _port_grads(fn, args, K, W, H, tgt, bg, **kw):
    ta = [torch.tensor(a, requires_grad=True) for a in args]
    off = torch.zeros((args[0].shape[0], 2), requires_grad=True)
    out = fn(*ta, torch.eye(4), torch.as_tensor(K),
             RasterizeSettings(width=W, height=H), bg=torch.as_tensor(bg),
             center2d_offset=off, **kw)
    loss = _loss_terms(out, torch.as_tensor(tgt))
    return [g.numpy() for g in torch.autograd.grad(loss, ta + [off])]


def _jax_grads(fn, args, K, W, H, tgt, bg, **kw):
    def loss(*a):
        out = fn(*a[:5], jnp.eye(4), jnp.asarray(K),
                 JSettings(width=W, height=H), bg=jnp.asarray(bg),
                 center2d_offset=a[5], **kw)
        return _loss_terms(out, tgt)
    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(6)))(
        *[jnp.asarray(a) for a in args],
        jnp.zeros((args[0].shape[0], 2), jnp.float32))]


def assert_grads_close(got, want, l2=False):
    for name, a, b in zip(NAMES, got, want):
        scale = np.abs(b).max()
        assert scale > 0, f"zero reference gradient for {name}"
        assert np.isfinite(a).all(), name
        if l2:
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel < 2e-4, (name, rel)
        else:
            np.testing.assert_allclose(a, b, atol=2e-4 * scale, rtol=1e-3,
                                       err_msg=f"gradient of {name}")


@pytest.mark.parametrize("which", ["kernel_test", "dense", "empty_tiles"])
def test_rasterize_gradients_match_jax_and_oracle(which):
    args, K, (W, H) = {"kernel_test": random_scene, "dense": dense_scene,
                       "empty_tiles": empty_tile_scene}[which]()
    tgt = np.random.default_rng(1).uniform(0, 1, (H, W, 3)).astype(
        np.float32)
    bg = np.array([0.0, 0.5, 1.0], np.float32)
    tiled = _port_grads(rasterize, args, K, W, H, tgt, bg)
    oracle = _port_grads(rasterize_oracle, args, K, W, H, tgt, bg)
    jax_tiled = _jax_grads(jrasterize, args, K, W, H, tgt, bg,
                           interpret=True)
    dense = which == "dense"
    assert_grads_close(tiled, oracle, l2=dense)
    assert_grads_close(tiled, jax_tiled, l2=dense)
