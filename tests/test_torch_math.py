"""Port vs JAX: transforms, spherical harmonics, cameras, depth→normal.

The same numpy inputs go through both packages; tolerance 1e-6 absolute
(scaled by the magnitude where the values are large)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streetunveiler_tpu.ops import depth_normal as jdn
from streetunveiler_tpu.ops import sh as jsh
from streetunveiler_tpu.ops import transforms as jtf
from streetunveiler_tpu.scene import cameras as jcam
from streetunveiler_torch.ops import depth_normal as tdn
from streetunveiler_torch.ops import sh as tsh
from streetunveiler_torch.ops import transforms as ttf
from streetunveiler_torch.scene import cameras as tcam

torch.set_num_threads(1)

ATOL = 1e-6


def close(jax_val, torch_val, atol=ATOL, scale=False):
    a = np.asarray(jax_val)
    b = torch_val.detach().cpu().numpy() if torch.is_tensor(torch_val) \
        else np.asarray(torch_val)
    tol = atol * max(1.0, float(np.abs(a).max())) if scale else atol
    np.testing.assert_allclose(b, a, rtol=0, atol=tol)


def _pose(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    R = np.asarray(jtf.quat_to_rotmat(jnp.asarray(q, jnp.float32)))
    t = rng.normal(size=3).astype(np.float32) * 3
    return R.astype(np.float32), t


def test_quat_to_rotmat():
    q = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    close(jtf.quat_to_rotmat(jnp.asarray(q)),
          ttf.quat_to_rotmat(torch.as_tensor(q)))


def test_inverse_sigmoid():
    x = np.linspace(0.01, 0.99, 50, dtype=np.float32)
    close(jtf.inverse_sigmoid(jnp.asarray(x)),
          ttf.inverse_sigmoid(torch.as_tensor(x)))


@pytest.mark.parametrize("recenter", [False, True])
def test_world_to_view(recenter):
    R, t = _pose(1)
    kw = dict(translate=np.array([0.5, -1.0, 2.0], np.float32), scale=1.7) \
        if recenter else {}
    j = jtf.world_to_view(R, t, **kw)
    k = ttf.world_to_view(torch.as_tensor(R), torch.as_tensor(t), **kw)
    close(j, k, scale=True)
    close(jtf.camera_center_from_w2c(j), ttf.camera_center_from_w2c(k),
          scale=True)


@pytest.mark.parametrize("with_k", [False, True])
def test_projection_matrix(with_k):
    if with_k:
        K = np.array([[800.0, 0, 310.0], [0, 790.0, 250.0], [0, 0, 1]],
                     np.float32)
        j = jtf.projection_matrix(0.01, 100.0, 0.0, 0.0, K=jnp.asarray(K),
                                  width=640, height=480)
        k = ttf.projection_matrix(0.01, 100.0, 0.0, 0.0,
                                  K=torch.as_tensor(K), width=640, height=480)
    else:
        j = jtf.projection_matrix(0.2, 50.0, 1.1, 0.8)
        k = ttf.projection_matrix(0.2, 50.0, 1.1, 0.8)
    close(j, k, scale=True)


def test_fov_focal_roundtrip():
    for fov, px in ((0.9, 640), (1.4, 1920)):
        assert ttf.fov2focal(fov, px) == jtf.fov2focal(fov, px)
        f = ttf.fov2focal(fov, px)
        assert ttf.focal2fov(f, px) == jtf.focal2fov(f, px)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_sh_basis_and_eval(degree):
    rng = np.random.default_rng(degree)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    k = (degree + 1) ** 2
    coeffs = rng.normal(size=(128, k, 3)).astype(np.float32)
    close(jsh.sh_basis(jnp.asarray(d), degree),
          tsh.sh_basis(torch.as_tensor(d), degree))
    close(jsh.eval_sh(degree, jnp.asarray(coeffs), jnp.asarray(d)),
          tsh.eval_sh(degree, torch.as_tensor(coeffs), torch.as_tensor(d)),
          scale=True)
    assert tsh.num_sh_bases(degree) == jsh.num_sh_bases(degree) == k


def test_rgb_sh_roundtrip():
    rgb = np.random.default_rng(3).uniform(0, 1, (64, 3)).astype(np.float32)
    close(jsh.rgb_to_sh(jnp.asarray(rgb)), tsh.rgb_to_sh(torch.as_tensor(rgb)))
    sh = np.array(jsh.rgb_to_sh(jnp.asarray(rgb)))
    close(jsh.sh_to_rgb(jnp.asarray(sh)), tsh.sh_to_rgb(torch.as_tensor(sh)))


def test_camera():
    R, t = _pose(4)
    K = np.array([[500.0, 0, 160.0], [0, 510.0, 120.0], [0, 0, 1]],
                 np.float32)
    jc = jcam.make_camera(R, t, K, 320, 240)
    tc = tcam.make_camera(R, t, K, 320, 240, device="cpu")
    close(jc.w2c, tc.w2c)
    close(jc.K, tc.K)
    close(jc.camera_center, tc.camera_center, scale=True)
    close(jc.world_view_transform, tc.world_view_transform)
    close(jc.full_proj_transform, tc.full_proj_transform, scale=True)
    assert abs(jc.fovx - tc.fovx) < 1e-6 and abs(jc.fovy - tc.fovy) < 1e-6
    jr, tr = jc.resize(2.0), tc.resize(2.0)
    assert (jr.width, jr.height) == (tr.width, tr.height)
    close(jr.K, tr.K)


def test_depth_to_normal():
    rng = np.random.default_rng(5)
    h, w = 24, 32
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = (5.0 + 0.05 * xx + 0.02 * yy
             + 0.1 * rng.normal(size=(h, w))).astype(np.float32)
    K = np.array([[40.0, 0, 16.0], [0, 40.0, 12.0], [0, 0, 1]], np.float32)
    jp = jdn.depth_to_points_view(jnp.asarray(depth), jnp.asarray(K))
    tp = tdn.depth_to_points_view(torch.as_tensor(depth), torch.as_tensor(K))
    close(jp, tp, scale=True)
    close(jdn.depth_to_normal(jnp.asarray(depth), jnp.asarray(K)),
          tdn.depth_to_normal(torch.as_tensor(depth), torch.as_tensor(K)))
