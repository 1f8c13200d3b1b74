"""Port vs JAX: ``renderer.render`` of a state built by the JAX package
and carried across by ``convert.py``; ``measure_duplicate_capacity``; the
PLY round trip; the checkpoint key layout; and the isolation guard (the
port imports neither ``jax`` nor ``streetunveiler_tpu``).

Tolerances as ``tests/test_torch_blend.py``; the depth→normal pseudo
surface and the normalized depth divide by alpha, so they are compared
where alpha > 0.5."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streetunveiler_tpu import renderer as jrenderer
from streetunveiler_tpu.models import gaussians as jgs
from streetunveiler_tpu.scene.cameras import Camera as JCamera
from streetunveiler_tpu.train.checkpoint import _flatten
from streetunveiler_tpu.utils import ply as jply
from streetunveiler_torch import convert, renderer, trace
from streetunveiler_torch.scene.cameras import Camera
from streetunveiler_torch.utils import ply as tply

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, F = 64, 48, 50.0
ATOL = dict(render=5e-5, rend_alpha=2e-5, rend_normal=5e-5, rend_dist=5e-5,
            expected_depth=5e-4, median_depth=1e-5)


@pytest.fixture(scope="module")
def jax_state():
    rng = np.random.default_rng(0)
    n = 300
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                    rng.uniform(3, 12, n)], 1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    sem = rng.integers(0, 6, n).astype(np.int32)
    st = jgs.create_from_pcd(pts, cols, sem, spatial_scale=10.0,
                             capacity=320, sh_degree=3)
    # view-dependent color through every SH band, larger and more opaque
    # splats than the kNN init so that the image is covered
    rest = rng.normal(0, 0.05, st.params.features_rest.shape)
    params = st.params.__class__(
        xyz=st.params.xyz, features_dc=st.params.features_dc,
        features_rest=jnp.asarray(rest, jnp.float32),
        scaling=st.params.scaling + 1.0, rotation=st.params.rotation,
        opacity=st.params.opacity + 3.0)
    import dataclasses
    return dataclasses.replace(st, params=params)


@pytest.fixture(scope="module")
def cameras():
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.3, -0.2, 0.5]
    jc = JCamera(w2c=jnp.asarray(w2c), K=jnp.asarray(K), width=W, height=H)
    tc = Camera(w2c=torch.as_tensor(w2c), K=torch.as_tensor(K), width=W,
                height=H)
    return jc, tc


@pytest.fixture(scope="module")
def port_state(jax_state):
    return convert.state_from_arrays(_flatten(jax_state, "state"),
                                     device="cpu")


def compare_results(jres, tres, mask_alpha=True):
    for f, tol in ATOL.items():
        a = np.asarray(getattr(jres, f))
        b = getattr(tres, f).numpy()
        if f == "median_depth":
            err = np.abs(a - b)
            assert (err > tol).mean() <= 1e-3, f
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=tol)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=f)
    # screen radii are geometry: 1e-5 relative (unbounded conics read 1e6)
    np.testing.assert_allclose(tres.radii.numpy(), np.asarray(jres.radii),
                               rtol=1e-5, atol=1e-5)
    covered = np.asarray(jres.rend_alpha) > 0.5
    assert covered.mean() > 0.3
    np.testing.assert_allclose(tres.surf_depth.numpy()[covered],
                               np.asarray(jres.surf_depth)[covered],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tres.surf_normal.numpy()[covered],
                               np.asarray(jres.surf_normal)[covered],
                               atol=1e-3)
    assert bool(tres.overflow) == bool(jres.overflow)
    assert int(tres.demand) == int(jres.demand)


def test_convert_carries_every_leaf(jax_state, port_state):
    for name in ("xyz", "features_dc", "features_rest", "scaling",
                 "rotation", "opacity"):
        np.testing.assert_array_equal(
            getattr(port_state.params, name).numpy(),
            np.asarray(getattr(jax_state.params, name)))
    for name in ("semantics", "alive", "max_radii2d", "grad_accum", "denom",
                 "spatial_scale"):
        np.testing.assert_array_equal(getattr(port_state, name).numpy(),
                                      np.asarray(getattr(jax_state, name)))
    assert port_state.sh_degree == jax_state.sh_degree == 3


def test_checkpoint_npz_layout(jax_state, tmp_path):
    """``splatting.npz`` as the JAX checkpoint writes it (state leaves
    under the prefix ``state``, beside optimizer leaves)."""
    blob = {"iteration": np.asarray(7)}
    blob.update(_flatten(jax_state, "state"))
    blob["opt.mu.xyz"] = np.zeros((320, 3), np.float32)
    np.savez(tmp_path / "splatting.npz", **blob)
    st = convert.load_checkpoint_state(str(tmp_path), device="cpu")
    np.testing.assert_array_equal(st.params.xyz.numpy(),
                                  np.asarray(jax_state.params.xyz))
    np.testing.assert_array_equal(st.alive.numpy(),
                                  np.asarray(jax_state.alive))


def test_render_matches_jax(jax_state, port_state, cameras):
    jc, tc = cameras
    bg = np.array([0.2, 0.1, 0.0], np.float32)
    jres = jrenderer.render(jc, jax_state, jnp.asarray(bg), interpret=True,
                            depth_ratio=0.3)
    tres = renderer.render(tc, port_state, bg, depth_ratio=0.3,
                           device="cpu")
    compare_results(jres, tres)
    assert float(tres.rend_alpha.max()) > 0.5


def test_render_semantic_matches_jax(jax_state, port_state, cameras):
    """nq = 9: one-hot classes as color + 3 extra payload channels."""
    jc, tc = cameras
    jp = jrenderer.render_semantic(jc, jax_state, interpret=True)
    tp = renderer.render_semantic(tc, port_state, device="cpu")
    assert tp.shape == (H, W, 6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=5e-5)


def test_measure_duplicate_capacity_matches_jax(jax_state, port_state,
                                                cameras):
    jc, tc = cameras
    j = jrenderer.measure_duplicate_capacity([jc], jax_state, interpret=True)
    t = renderer.measure_duplicate_capacity([tc], port_state, device="cpu")
    assert t == j and t % 128 == 0


def test_ply_roundtrip(jax_state, port_state, cameras, tmp_path):
    """JAX ``state_to_ply`` → port ``state_from_ply`` → the same render as
    the carried-across state (dead slots only add culled surfels)."""
    _, tc = cameras
    path = str(tmp_path / "point_cloud.ply")
    jply.state_to_ply(path, jax_state)
    st = tply.state_from_ply(path, spatial_scale=10.0, device="cpu")
    assert int(st.num_alive) == int(jax_state.num_alive)
    a = renderer.render(tc, port_state, np.zeros(3, np.float32),
                        device="cpu")
    b = renderer.render(tc, st, np.zeros(3, np.float32), device="cpu")
    for f in ("render", "rend_alpha", "rend_normal", "rend_dist",
              "surf_depth", "median_depth"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      getattr(a, f).numpy(), err_msg=f)
    # and back out through the port's writer, read by the JAX reader
    path2 = str(tmp_path / "again.ply")
    tply.state_to_ply(path2, st)
    d = jply.load_surfel_ply(path2)
    np.testing.assert_array_equal(d["xyz"], np.asarray(
        jax_state.params.xyz)[np.asarray(jax_state.alive)])


def test_cpu_render_launches_no_kernel(port_state, cameras):
    _, tc = cameras
    trace.reset_launch_counts()
    renderer.render(tc, port_state, np.zeros(3, np.float32), device="cpu")
    assert not any(trace.launch_counts.values())


GUARD = r"""
import importlib, pkgutil, sys
import streetunveiler_torch
names = [m.name for m in pkgutil.walk_packages(
    streetunveiler_torch.__path__, "streetunveiler_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib",
                                            "streetunveiler_tpu")))
assert not bad, bad
assert len(names) >= 30, names
for mod in ("train.step", "train.loop", "train.losses", "train.optim",
            "train.schedule", "train.checkpoint", "cli.train", "cli.common",
            "scene.scene", "scene.readers.synthetic", "scene.readers.basic",
            "config", "utils.semantics", "utils.logging", "models.sky",
            "models.mlp"):
    assert "streetunveiler_torch." + mod in names, mod
import torch
if not torch.cuda.is_available():
    import tempfile
    import numpy as np
    from streetunveiler_torch import renderer
    from streetunveiler_torch.cli import train as cli_train
    from streetunveiler_torch.config import OptimizationParams
    from streetunveiler_torch.models.gaussians import create_from_pcd
    from streetunveiler_torch.scene.cameras import Camera
    from streetunveiler_torch.train.step import init_optimizer, train_step
    st = create_from_pcd(np.random.default_rng(0).normal(size=(16, 3)),
                         np.zeros((16, 3)), np.zeros(16), 1.0, device="cpu")
    cam = Camera(w2c=torch.eye(4), K=torch.eye(3), width=32, height=16)
    tmp = tempfile.mkdtemp()
    for call in (lambda: renderer.render(cam, st, np.zeros(3)),
                 lambda: create_from_pcd(np.zeros((4, 3)), np.zeros((4, 3)),
                                         np.zeros(4), 1.0),
                 lambda: train_step(st, init_optimizer(st), cam,
                                    torch.zeros(16, 32, 3), np.zeros(3), 1,
                                    OptimizationParams()),
                 lambda: cli_train.main(["--model_path", tmp,
                                         "--iterations", "1"])):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA" in str(e), e
        else:
            raise AssertionError("ran on the CPU without device='cpu'")
print("ISOLATED", len(names))
"""


def test_port_imports_no_jax_and_defaults_to_cuda():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", GUARD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "ISOLATED" in out.stdout
