"""Port vs JAX: the synthetic street scene and the ``Scene`` container.

The same seed gives the same points, colours, semantics, cameras and
normalisation (numpy draws in the same order), and GT images rendered by
each package's own untiled oracle on the CPU within the blend tolerances
(colour 5e-5 on all but 0.1% of pixels; labels may differ only where two
classes tie). ``Scene``
builds the same cameras and initial state, and writes the same
``cameras.json`` and a PLY the JAX package reads back.
"""

import json

import numpy as np
import pytest
import torch

from streetunveiler_tpu.scene.readers import \
    make_synthetic_street as jmake_street
from streetunveiler_tpu.scene.scene import Scene as JScene
from streetunveiler_tpu.train.checkpoint import _flatten
from streetunveiler_tpu.utils import ply as jply
from streetunveiler_torch.scene.readers import make_synthetic_street
from streetunveiler_torch.scene.scene import Scene

torch.set_num_threads(1)

SIZES = dict(n_points=400, n_cameras=5, width=64, height=48, focal=45.0,
             seed=5, eval_split=True, llffhold=4)


@pytest.fixture(scope="module")
def infos():
    return jmake_street(**SIZES), make_synthetic_street(**SIZES,
                                                        device="cpu")


def test_synthetic_street_matches_jax(infos):
    j, t = infos
    for f in ("points", "colors", "semantics"):
        np.testing.assert_array_equal(getattr(t.point_cloud, f),
                                      getattr(j.point_cloud, f), err_msg=f)
    assert t.background == j.background
    assert t.camera_frame_dict == j.camera_frame_dict
    np.testing.assert_array_equal(t.nerf_normalization["translate"],
                                  j.nerf_normalization["translate"])
    assert t.nerf_normalization["radius"] == j.nerf_normalization["radius"]
    assert len(t.train_cameras) == len(j.train_cameras) == 3
    assert len(t.test_cameras) == len(j.test_cameras) == 2
    for tc, jc in zip(t.train_cameras + t.test_cameras,
                      j.train_cameras + j.test_cameras):
        for f in ("R", "T", "K"):
            np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
        assert (tc.width, tc.height, tc.image_name) == (
            jc.width, jc.height, jc.image_name)
        assert tc.image.shape == (48, 64, 3) and tc.image.dtype == np.float32
        # early termination is a knife-edge on f32 rounding: ≤ 0.1% of
        # pixels may flip (tests/test_torch_blend.py)
        bad = (np.abs(tc.image - jc.image) > 5e-5).any(axis=-1)
        assert bad.mean() <= 1e-3, bad.sum()
        same = tc.semantics == jc.semantics
        assert same.mean() > 0.99, same.mean()
    assert np.unique(np.concatenate([c.semantics.ravel()
                                     for c in t.train_cameras])).size >= 3


def test_scene_matches_jax(infos, tmp_path):
    j, t = infos
    js = JScene(j, model_path=str(tmp_path / "j"))
    ts = Scene(t, model_path=str(tmp_path / "t"), device="cpu")
    assert ts.cameras_extent == js.cameras_extent
    assert ts.background == js.background
    for tc, jc in zip(ts.train_cameras, js.train_cameras):
        np.testing.assert_array_equal(tc.w2c.numpy(), np.asarray(jc.w2c))
        np.testing.assert_array_equal(tc.K.numpy(), np.asarray(jc.K))
    jstate = js.create_state(capacity=1000)
    tstate = ts.create_state(capacity=1000)
    blob = _flatten(jstate, "state")
    for name in ("xyz", "features_dc", "features_rest", "scaling",
                 "rotation", "opacity"):
        np.testing.assert_allclose(getattr(tstate.params, name).numpy(),
                                   blob[f"state.params.{name}"], rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    for name in ("semantics", "alive", "spatial_scale"):
        np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                      blob[f"state.{name}"])
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    with open(js.save_cameras_json()) as f1, \
            open(ts.save_cameras_json()) as f2:
        a, b = json.load(f1), json.load(f2)
    assert len(a) == len(b) == 3
    for ea, eb in zip(a, b):
        np.testing.assert_allclose(eb["position"], ea["position"], atol=1e-6)
        np.testing.assert_allclose(eb["rotation"], ea["rotation"], atol=1e-6)
        assert (eb["fx"], eb["width"]) == (ea["fx"], ea["width"])
    ts.save(tstate, 7)
    d = jply.load_surfel_ply(str(tmp_path / "t" / "point_cloud" /
                                 "iteration_7" / "point_cloud.ply"))
    np.testing.assert_array_equal(d["xyz"], tstate.params.xyz.numpy()[
        tstate.alive.numpy()])
    back = ts.load(7, capacity=1000)
    np.testing.assert_array_equal(back.params.xyz.numpy(),
                                  tstate.params.xyz.numpy())
