"""Port vs JAX: every ``SurfelScreen`` field of ``preprocess_surfels``,
and the surfel state built by ``create_from_pcd``.

Geometry within 1e-5 relative (to the field's largest magnitude: the
3-wide contractions are summed in another order than XLA's), ``valid``
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streetunveiler_tpu.models import gaussians as jgs
from streetunveiler_tpu.ops.rasterizer import RasterizeSettings as JSettings
from streetunveiler_tpu.ops.rasterizer.preprocess import \
    preprocess_surfels as jpre
from streetunveiler_torch.models import gaussians as tgs
from streetunveiler_torch.ops.rasterizer import RasterizeSettings
from streetunveiler_torch.ops.rasterizer.preprocess import preprocess_surfels

torch.set_num_threads(1)


def random_scene(n=300, seed=0, W=64, H=48, f=50.0, zspread=(3.0, 12.0)):
    rng = np.random.default_rng(seed)
    means = np.stack([
        rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
        rng.uniform(*zspread, n)], axis=1).astype(np.float32)
    scales = rng.uniform(0.05, 0.6, (n, 2)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.05, 0.95, n).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return (means, scales, quats, opac, cols), np.eye(4, dtype=np.float32), \
        K, (W, H)


def tilted_scene():
    """Off-center principal point, a rotated and translated camera, and a
    nonzero center2d offset tap."""
    args, _, _, (W, H) = random_scene(seed=3, zspread=(2.0, 20.0))
    ang = 0.3
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    tilt = np.array([[1, 0, 0], [0, np.cos(0.2), -np.sin(0.2)],
                     [0, np.sin(0.2), np.cos(0.2)]], np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = tilt @ R
    w2c[:3, 3] = [0.4, -0.3, 1.5]
    K = np.array([[61.0, 0, 20.5], [0, 58.0, 31.0], [0, 0, 1]], np.float32)
    return args, w2c, K, (W, H)


def both(scene, offset=None):
    args, w2c, K, (W, H) = scene
    jsur = jpre(*map(jnp.asarray, args), jnp.asarray(w2c), jnp.asarray(K),
                JSettings(width=W, height=H),
                center2d_offset=None if offset is None
                else jnp.asarray(offset))
    tsur = preprocess_surfels(*map(torch.as_tensor, args),
                              torch.as_tensor(w2c), torch.as_tensor(K),
                              RasterizeSettings(width=W, height=H),
                              center2d_offset=None if offset is None
                              else torch.as_tensor(offset))
    return jsur, tsur


FIELDS = ["M", "center2d", "depth", "normal", "opacity", "color", "radius",
          "ext", "valid", "cull"]


@pytest.mark.parametrize("case", ["random", "tilted"])
@pytest.mark.parametrize("field", FIELDS)
def test_surfel_screen_field(case, field):
    if case == "random":
        jsur, tsur = both(random_scene())
    else:
        off = np.random.default_rng(9).normal(0, 0.3, (300, 2)).astype(
            np.float32)
        jsur, tsur = both(tilted_scene(), offset=off)
    a = np.asarray(getattr(jsur, field))
    b = getattr(tsur, field).numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype == bool:
        np.testing.assert_array_equal(b, a)
        assert 0 < a.sum() < a.size, "both culled and kept surfels expected"
    else:
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * scale)


def test_create_from_pcd_matches_jax():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-5, 5, (200, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    sem = rng.integers(0, 6, 200).astype(np.int32)
    js = jgs.create_from_pcd(pts, cols, sem, spatial_scale=7.0, capacity=256)
    ts = tgs.create_from_pcd(pts, cols, sem, spatial_scale=7.0, capacity=256,
                             device="cpu")
    for name in ("xyz", "features_dc", "features_rest", "rotation",
                 "opacity"):
        np.testing.assert_allclose(getattr(ts.params, name).numpy(),
                                   np.asarray(getattr(js.params, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    # log-scales come from two KD-tree implementations
    np.testing.assert_allclose(ts.params.scaling.numpy(),
                               np.asarray(js.params.scaling), atol=1e-5)
    np.testing.assert_array_equal(ts.semantics.numpy(), np.asarray(js.semantics))
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    assert int(ts.num_alive) == int(js.num_alive) == 200
    np.testing.assert_allclose(ts.get_opacity().numpy(),
                               np.asarray(js.get_opacity()), atol=1e-7)
    np.testing.assert_allclose(ts.get_rotation().numpy(),
                               np.asarray(js.get_rotation()), atol=1e-6)
    np.testing.assert_array_equal(ts.semantic_mask(0b101).numpy(),
                                  np.asarray(js.semantic_mask(0b101)))
