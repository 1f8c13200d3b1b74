"""Port vs JAX: the sky model (``models/sky.py``) and the MLP library
(``models/mlp.py``), with the JAX parameters converted leaf for leaf
(``convert.sky_from_arrays``).

* ``freq_embed``, ``hash_encode`` (negative coordinates, int32 products
  that wrap, grid coordinates that saturate and a hash equal to INT_MIN),
  ``camera_rays``, ``sky_forward`` and ``render_sky``: 1e-6 absolute;
* the gradients of a sky loss with respect to every parameter:
  2e-5·max|g| absolute plus 1e-4 relative (the MLP's products sum in
  another order, and ``render_sky`` adds the origin's share of the first
  layer separately);
* ``test_sky_trains``: 50 plain gradient steps fit a constant colour, as
  ``tests/test_sky.py:34`` does;
* ``apply_mlp`` for each activation, with and without skips: 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streetunveiler_tpu.models import mlp as jmlp
from streetunveiler_tpu.models import sky as jsky
from streetunveiler_tpu.train.checkpoint import _flatten
from streetunveiler_torch.convert import sky_from_arrays
from streetunveiler_torch.models import mlp as tmlp
from streetunveiler_torch.models import sky as tsky

torch.set_num_threads(1)

ATOL = 1e-6


def port_sky(jparams):
    return sky_from_arrays(_flatten(jparams, "sky"), device="cpu")


@pytest.fixture(scope="module")
def params():
    jp = jsky.init_sky(jax.random.PRNGKey(0))
    # larger tables and biases than the init's ±1e-4 and zeros, so that
    # the hash features and every bias move the output
    rng = np.random.default_rng(0)
    noise = lambda a: jnp.asarray(
        rng.normal(0, 0.3, a.shape).astype(np.float32)) + a
    jp = jsky.SkyParams(hash_tables=noise(jp.hash_tables), mlp_w=jp.mlp_w,
                        mlp_b=tuple(noise(b) for b in jp.mlp_b))
    return jp, port_sky(jp)


def test_init_sky_structure():
    jp = jsky.init_sky(jax.random.PRNGKey(0))
    tp = tsky.init_sky(torch.Generator().manual_seed(0), device="cpu")
    jleaves = _flatten(jp, "")
    assert list(tp.named_tensors()) == list(jleaves)
    for key, t in tp.named_tensors().items():
        assert tuple(t.shape) == jleaves[key].shape, key
    assert float(tp.hash_tables.abs().max()) <= 1e-4
    assert not any(float(b.abs().max()) for b in tp.mlp_b)
    # ~N(0, 2/fan_in) weights
    np.testing.assert_allclose(float(tp.mlp_w[1].std()),
                               (2.0 / 64) ** 0.5, rtol=0.1)


def test_freq_embed_matches_jax():
    x = np.random.default_rng(1).normal(0, 3, (7, 3)).astype(np.float32)
    got = tsky.freq_embed(torch.as_tensor(x)).numpy()
    want = np.asarray(jsky.freq_embed(jnp.asarray(x)))
    assert got.shape == want.shape == (7, 63)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_hash_encode_matches_jax(params):
    jp, tp = params
    rng = np.random.default_rng(2)
    pts = np.concatenate([
        rng.uniform(-1, 1, (20, 3)),            # near the origin
        rng.uniform(-3000, 3000, (20, 3)),      # products wrap in int32
        [[-2.0 ** 27, 0.0, 0.0],                # hash == INT_MIN: abs keeps it
         [2.0 ** 27, -1.0, 0.5],                # saturates, then base + 1 wraps
         [1e12, -1e12, 3.0],                    # saturates at every level
         [0.0, 0.0, 0.0]]]).astype(np.float32)
    got = tsky.hash_encode(tp, torch.as_tensor(pts)).numpy()
    want = np.asarray(jsky.hash_encode(jp, jnp.asarray(pts)))
    assert got.shape == want.shape == (len(pts), 32)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.abs(want).max() > 0.1


def test_camera_rays_matches_jax():
    H, W, f = 17, 23, 10.0
    K = np.array([[f, 0, W / 2], [0, 1.3 * f, H / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.linalg.qr(np.random.default_rng(3).normal(
        size=(3, 3)))[0]
    c2w[:3, 3] = [1.0, -2.0, 0.5]
    to, td = tsky.camera_rays(H, W, torch.as_tensor(K), torch.as_tensor(c2w))
    jo, jd = jsky.camera_rays(H, W, jnp.asarray(K), jnp.asarray(c2w))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)
    # the reference convention: the centre pixel looks along −z
    o, d = tsky.camera_rays(17, 17, torch.tensor(
        [[f, 0, 8.5], [0, f, 8.5], [0, 0, 1]]), torch.eye(4))
    np.testing.assert_allclose(d[8, 8].numpy(), [-0.05, 0.05, -1.0],
                               atol=1e-6)


def _camera(H=24, W=32, f=20.0, seed=4):
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.linalg.qr(np.random.default_rng(seed).normal(
        size=(3, 3)))[0]
    c2w[:3, 3] = [0.7, -1.2, 2.5]
    return H, W, K, c2w


def test_sky_forward_and_render_sky_match_jax(params):
    jp, tp = params
    rng = np.random.default_rng(5)
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    origins = rng.normal(0, 2, (50, 3)).astype(np.float32)
    got = tsky.sky_forward(tp, torch.as_tensor(dirs), torch.as_tensor(origins))
    want = np.asarray(jsky.sky_forward(jp, jnp.asarray(dirs),
                                       jnp.asarray(origins)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert want.std() > 0.05
    H, W, K, c2w = _camera()
    got = tsky.render_sky(tp, H, W, torch.as_tensor(K), torch.as_tensor(c2w))
    want = np.asarray(jsky.render_sky(jp, H, W, jnp.asarray(K),
                                      jnp.asarray(c2w)))
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # render_sky (origin encoded once) is sky_forward on broadcast rays
    o, d = tsky.camera_rays(H, W, torch.as_tensor(K), torch.as_tensor(c2w))
    np.testing.assert_allclose(tsky.sky_forward(tp, d, o).numpy(),
                               got.numpy(), atol=ATOL)


def test_sky_loss_gradients_match_jax(params):
    jp, tp = params
    H, W, K, c2w = _camera()
    tgt = np.random.default_rng(6).uniform(0, 1, (H, W, 3)).astype(
        np.float32)

    def jloss(p):
        img = jsky.render_sky(p, H, W, jnp.asarray(K), jnp.asarray(c2w))
        return jnp.mean((img - tgt) ** 2)

    jg = _flatten(jax.grad(jloss)(jp), "")
    leaves = tp.map(lambda t: t.clone().requires_grad_(True))
    img = tsky.render_sky(leaves, H, W, torch.as_tensor(K),
                          torch.as_tensor(c2w))
    loss = torch.mean((img - torch.as_tensor(tgt)) ** 2)
    np.testing.assert_allclose(float(loss.detach()), float(jloss(jp)),
                               rtol=1e-5)
    named = leaves.named_tensors()
    grads = torch.autograd.grad(loss, list(named.values()))
    for (key, _), g in zip(named.items(), grads):
        want = jg[key]
        assert np.abs(want).max() > 0, key
        np.testing.assert_allclose(g.numpy(), want,
                                   atol=2e-5 * np.abs(want).max(), rtol=1e-4,
                                   err_msg=key)


def test_sky_trains():
    """tests/test_sky.py:34: 50 plain gradient steps fit a constant colour
    through the sigmoid."""
    tp = tsky.init_sky(torch.Generator().manual_seed(2), device="cpu")
    H, W, f = 16, 16, 10.0
    K = torch.tensor([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    target = torch.tensor([0.8, 0.3, 0.1]).expand(H, W, 3)

    def loss(p):
        return torch.mean((tsky.render_sky(p, H, W, K, torch.eye(4))
                           - target) ** 2)

    with torch.no_grad():
        l0 = float(loss(tp))
    for _ in range(50):
        leaves = tp.map(lambda t: t.detach().requires_grad_(True))
        grads = iter(torch.autograd.grad(
            loss(leaves), list(leaves.named_tensors().values())))
        tp = leaves.map(lambda t: (t - 1e-2 * next(grads)).detach())
    with torch.no_grad():
        l1 = float(loss(tp))
    assert l1 < l0 * 0.3, (l0, l1)


@pytest.mark.parametrize("activation,skips,out_act", [
    ("relu", (), "none"), ("relu", (2,), "sigmoid"), ("tanh", (), "none"),
    ("softplus", (1,), "none"), ("sine", (), "none")])
def test_apply_mlp_matches_jax(activation, skips, out_act):
    jp = jmlp.init_mlp(jax.random.PRNGKey(3), 7, 4, depth=3, width=16,
                       skips=skips, activation=activation,
                       output_activation=out_act)
    tp = tmlp.MLPParams(
        weights=tuple(torch.as_tensor(np.array(w)) for w in jp.weights),
        biases=tuple(torch.as_tensor(np.array(b)) for b in jp.biases),
        skips=tuple(skips), activation=activation,
        output_activation=out_act)
    x = np.random.default_rng(7).normal(size=(11, 7)).astype(np.float32)
    np.testing.assert_allclose(
        tmlp.apply_mlp(tp, torch.as_tensor(x)).numpy(),
        np.asarray(jmlp.apply_mlp(jp, jnp.asarray(x))), atol=ATOL)
    # the port's init has the same shapes
    mine = tmlp.init_mlp(torch.Generator().manual_seed(3), 7, 4, depth=3,
                         width=16, skips=skips, activation=activation,
                         output_activation=out_act, device="cpu")
    assert [tuple(w.shape) for w in mine.weights] == \
        [w.shape for w in jp.weights]
    assert tmlp.apply_mlp(mine, torch.as_tensor(x)).shape == (11, 4)
