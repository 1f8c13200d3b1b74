"""Port vs JAX: the evaluation networks and the evaluation CLI.

* LPIPS-VGG: the five tap features and the distance against
  ``lpips_pair`` at 64×48 and at an odd size, where the 2×2 pools floor;
* InceptionV3 pool3 against ``inception_pool3`` on one input that
  upsamples to 299 and one that downsamples (the JAX resize antialiases
  when it downsamples, and the port matches it);
* both loaders refuse wrong shapes;
* ``evaluate_dirs`` with LPIPS against the JAX package's;
* the VGG-tap FID on identical and on distinct directories;
* the evaluation CLI's three ``--fid`` branches;
* the port's weight writer against the repo-root ``tools/
  export_eval_weights.py`` on one set of state dicts.

Tolerances: rtol 1e-4 / atol 1e-5 (``tests/test_inception.py:109``) on
the distances and the pool3 features; the LPIPS tap features, which grow
to ~20 and sum up to 4608 products a value, take the same rtol and an atol
of 1e-5 × the tap's largest magnitude. The weights are the random-init
ones of the end-to-end tool (``np.random.default_rng(0)``).
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streetunveiler_tpu.evaluation import inception as jinc
from streetunveiler_tpu.evaluation import lpips as jlpips
from streetunveiler_tpu.evaluation import metrics as jmetrics
from streetunveiler_torch.cli import evaluate as tcli
from streetunveiler_torch.evaluation import inception as tinc
from streetunveiler_torch.evaluation import lpips as tlpips
from streetunveiler_torch.evaluation import metrics as tmetrics
from streetunveiler_torch.tools import e2e_config2 as te2e
from streetunveiler_torch.tools import export_eval_weights as texport

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_exporter():
    """The repo-root writer, loaded from its file (no sys.path change)."""
    spec = importlib.util.spec_from_file_location(
        "_root_export_eval_weights",
        os.path.join(REPO, "tools", "export_eval_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("evalw")
    return te2e.make_eval_weights(str(d))


def _dump(dirp, imgs):
    from PIL import Image
    os.makedirs(dirp, exist_ok=True)
    for i, im in enumerate(imgs):
        Image.fromarray((im * 255).astype(np.uint8)).save(
            os.path.join(dirp, f"{i:05d}.png"))


@pytest.mark.parametrize("hw", [(48, 64), (37, 53)])
def test_lpips_matches_jax(weights, hw):
    lpips_npz, _ = weights
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, hw + (3,)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    jp = jlpips.load_lpips_weights(lpips_npz)
    tm = tlpips.load_lpips_weights(lpips_npz, device="cpu")

    jf = jlpips._vgg_features(jp, jnp.asarray(a)[None])
    with torch.no_grad():
        tf = tm.features(torch.from_numpy(a).permute(2, 0, 1)[None])
    assert len(jf) == len(tf) == 5
    for j, t in zip(jf, tf):
        assert tuple(j.shape) == tuple(t.shape)
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=RTOL,
                                   atol=ATOL * max(1.0, np.abs(j).max()))
    want = float(jlpips.lpips_pair(jp, jnp.asarray(a), jnp.asarray(b)))
    got = float(tlpips.lpips_pair(tm, a, b))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hw", [(40, 56), (240, 320)],
                         ids=["upsample", "downsample"])
def test_inception_matches_jax(weights, hw):
    _, inc_npz = weights
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (1,) + hw + (3,)).astype(np.float32)
    want = np.asarray(jinc.inception_pool3(
        jinc.load_inception_weights(inc_npz), jnp.asarray(x)))
    got = tinc.inception_pool3(
        tinc.load_inception_weights(inc_npz, device="cpu"), x).numpy()
    assert got.shape == want.shape == (1, 2048)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_loaders_reject_wrong_shapes(tmp_path, weights):
    blob = dict(np.load(weights[1]))
    blob["Conv2d_1a_3x3.conv.weight"] = np.zeros((32, 4, 3, 3), np.float32)
    bad = str(tmp_path / "bad_inception.npz")
    np.savez(bad, **blob)
    with pytest.raises(ValueError, match="Conv2d_1a_3x3"):
        tinc.load_inception_weights(bad, device="cpu")
    with pytest.raises(ValueError, match="Conv2d_1a_3x3"):
        jinc.load_inception_weights(bad)

    blob = dict(np.load(weights[0]))
    blob["lin2"] = np.zeros((1, 128), np.float32)
    bad = str(tmp_path / "bad_lpips.npz")
    np.savez(bad, **blob)
    with pytest.raises(ValueError, match="lin2"):
        tlpips.load_lpips_weights(bad, device="cpu")


def test_evaluate_dirs_with_lpips_matches_jax(tmp_path, weights):
    rng = np.random.default_rng(0)
    gt = [rng.random((32, 40, 3)).astype(np.float32) for _ in range(3)]
    near = [np.clip(g + rng.normal(0, 0.05, g.shape), 0, 1
                    ).astype(np.float32) for g in gt]
    _dump(str(tmp_path / "gt"), gt)
    _dump(str(tmp_path / "r"), near)
    want = jmetrics.evaluate_dirs(str(tmp_path / "r"), str(tmp_path / "gt"),
                                  lpips_weights=weights[0])
    got = tmetrics.evaluate_dirs(str(tmp_path / "r"), str(tmp_path / "gt"),
                                 lpips_weights=weights[0], device="cpu")
    assert set(got) == set(want) == {"n", "psnr", "ssim", "lpips"}
    assert got["n"] == want["n"] == 3
    for k in ("psnr", "ssim", "lpips"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_vgg_feature_fid(tmp_path, weights):
    fn = tlpips.vgg_feature_fn(weights[0], device="cpu")
    rng = np.random.default_rng(0)
    f = fn(rng.uniform(0, 1, (64, 64, 3)).astype(np.float32))
    assert f.shape == (64 + 128 + 256 + 512 + 512,)
    assert np.isfinite(f).all()
    a = [rng.uniform(0, 1, (32, 32, 3)).astype(np.float32) for _ in range(4)]
    b = [np.clip(x + rng.normal(0, 0.3, x.shape), 0, 1).astype(np.float32)
         for x in a]
    _dump(str(tmp_path / "ra"), a)
    _dump(str(tmp_path / "rb"), b)
    same = tmetrics.fid_from_dirs(str(tmp_path / "ra"), str(tmp_path / "ra"),
                                  fn)
    diff = tmetrics.fid_from_dirs(str(tmp_path / "ra"), str(tmp_path / "rb"),
                                  fn)
    # 4 samples in 1472 dimensions: the covariances are singular, which
    # leaves sqrtm noise on identical dirs; distinct dirs clear it
    assert abs(same) < 0.05
    assert diff > 10 * max(same, 1e-6)


def test_frechet_distance_without_scipy_disp(monkeypatch):
    """Newer scipy's ``sqrtm`` takes no ``disp`` and returns the root
    alone; the distance is the same either way (and the JAX package's)."""
    from scipy import linalg
    rng = np.random.default_rng(4)
    a, b = rng.normal(size=(40, 6)), rng.normal(size=(40, 6)) + 0.5
    stats = (*tmetrics.activation_stats(a), *tmetrics.activation_stats(b))
    want = jmetrics.frechet_distance(*stats)
    orig = linalg.sqrtm

    def sqrtm_new(m):
        return orig(m, disp=False)[0]
    monkeypatch.setattr(linalg, "sqrtm", sqrtm_new)
    np.testing.assert_allclose(tmetrics.frechet_distance(*stats), want,
                               rtol=1e-10)


def test_evaluate_cli_fid_branches(tmp_path, weights, capsys):
    rng = np.random.default_rng(3)
    gt = [rng.random((24, 32, 3)).astype(np.float32) for _ in range(2)]
    r = [np.clip(g + rng.normal(0, 0.1, g.shape), 0, 1).astype(np.float32)
         for g in gt]
    _dump(str(tmp_path / "gt"), gt)
    _dump(str(tmp_path / "r"), r)
    base = ["--render_path", str(tmp_path / "r"), "--gt_path",
            str(tmp_path / "gt"), "--device", "cpu"]

    out = tcli.main(base + ["--fid", "--lpips_weights", weights[0],
                            "--inception_weights", weights[1]])
    assert set(out) == {"n", "psnr", "ssim", "lpips", "fid"}
    assert np.isfinite(out["fid"])
    assert json.loads(capsys.readouterr().out.strip()) == out

    out = tcli.main(base + ["--fid", "--lpips_weights", weights[0]])
    assert set(out) == {"n", "psnr", "ssim", "lpips", "fid_vgg"}
    assert np.isfinite(out["fid_vgg"])

    with pytest.raises(SystemExit, match="--fid needs --inception_weights"):
        tcli.main(base + ["--fid"])


def test_weight_writer_matches_the_jax_tool(tmp_path):
    jexp = _jax_exporter()
    vgg, lins, sd = te2e.random_eval_state_dicts(seed=5)
    sd["fc.weight"] = torch.zeros(10, 2048)
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(4, 768, 1, 1)
    for name, obj in (("vgg", vgg), ("lins", lins), ("inc", sd)):
        torch.save(obj, str(tmp_path / f"{name}.pth"))
    pairs = []
    for tag, mod in (("port", texport), ("jax", jexp)):
        lp, inc = str(tmp_path / f"{tag}_lpips.npz"), \
            str(tmp_path / f"{tag}_inc.npz")
        mod.export_lpips_from_pth(str(tmp_path / "vgg.pth"),
                                  str(tmp_path / "lins.pth"), lp)
        mod.export_inception(str(tmp_path / "inc.pth"), inc)
        pairs.append((np.load(lp), np.load(inc)))
    (pl, pi), (jl, ji) = pairs
    for p, j in ((pl, jl), (pi, ji)):
        assert sorted(p.files) == sorted(j.files)
        for k in j.files:
            assert p[k].dtype == j[k].dtype and p[k].shape == j[k].shape, k
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    assert not any(k.startswith(("fc.", "AuxLogits")) for k in pi.files)
    assert sorted(pl.files) == sorted(
        [f"conv{i}" for i in range(26)] + [f"lin{i}" for i in range(5)])
