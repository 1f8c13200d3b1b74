"""Port vs JAX: the render path — ``ops/tsdf.py``, ``mesh.py``,
``utils/render_paths.py``, ``evaluation/metrics.py``, the checkpoint
discovery helpers, the training log's panels and profiler trace, and the
render CLI.

The same numpy inputs go through both packages. Tolerances:
``integrate_tsdf`` tsdf, weight and colour to atol 1e-5 (the view
transform is a 3-wide f32 contraction, rounded apart); ``surface_nets``
and ``keep_large_clusters`` exact on the same arrays; PSNR/SSIM of
``evaluate_dirs`` to 1e-4 dB / 1e-6; the render CLI's PNGs within one
level of 255 (a float difference of one ulp can move a byte), its meshes
with the same vertex and face counts and vertices within 1e-3 voxels.
The JAX side renders through its Pallas kernels in interpret mode, as its
own tests run them on the CPU.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from streetunveiler_tpu import mesh as jmesh
from streetunveiler_tpu.cli import render as jcli_render
from streetunveiler_tpu.evaluation import metrics as jmetrics
from streetunveiler_tpu.ops import tsdf as jtsdf
from streetunveiler_tpu.train import checkpoint as jckpt
from streetunveiler_tpu.utils import render_paths as jpaths
from streetunveiler_torch import mesh as tmesh
from streetunveiler_torch.cli import render as tcli_render
from streetunveiler_torch.evaluation import metrics as tmetrics
from streetunveiler_torch.ops import tsdf as ttsdf
from streetunveiler_torch.train import checkpoint as tckpt
from streetunveiler_torch.utils import render_paths as tpaths

torch.set_num_threads(1)

SYNTH = ["--synthetic_points", "600", "--synthetic_cameras", "4",
         "--synthetic_width", "64", "--synthetic_height", "48",
         "--synthetic_focal", "45"]


def _view_inputs(seed=0, h=48, w=64):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(3, 8, (h, w)).astype(np.float32)
    depth[rng.random((h, w)) < 0.1] = 0.0
    color = rng.random((h, w, 3)).astype(np.float32)
    alpha = rng.random((h, w)).astype(np.float32)
    K = np.array([[45, 0, w / 2], [0, 45, h / 2], [0, 0, 1]], np.float32)
    ang = 0.1 + 0.05 * seed
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                   [-np.sin(ang), 0, np.cos(ang)]]
    w2c[:3, 3] = [0.2, -0.1, 0.3]
    return depth, color, alpha, w2c, K


@pytest.fixture(scope="module")
def fused():
    """Two views fused by both packages into the same grid (the port in
    chunks of 5,000 voxels, so the chunking is crossed)."""
    import jax.numpy as jnp
    lo = np.array([-3, -2, 2.5], np.float32)
    size = np.array([6, 4, 6], np.float32)
    jv = jtsdf.make_volume(lo, size, 0.1)
    tv = ttsdf.make_volume(lo, size, 0.1, device="cpu")
    for seed in (0, 1):
        depth, color, alpha, w2c, K = _view_inputs(seed)
        jv = jtsdf.integrate_tsdf(jv, jnp.asarray(depth), jnp.asarray(color),
                                  jnp.asarray(w2c), jnp.asarray(K),
                                  trunc=0.3, alpha=jnp.asarray(alpha))
        ttsdf.integrate_tsdf(tv, depth, color, w2c, K, trunc=0.3,
                             alpha=alpha, chunk=5000)
    return jv, tv


def test_integrate_tsdf_matches_jax(fused):
    jv, tv = fused
    for f in ("tsdf", "weight", "color"):
        np.testing.assert_allclose(getattr(tv, f).numpy(),
                                   np.asarray(getattr(jv, f)), atol=1e-5,
                                   rtol=0, err_msg=f)
    assert float(tv.weight.max()) == 2.0


def test_surface_nets_and_clusters_match_jax(fused):
    jv, _ = fused
    args = (np.asarray(jv.tsdf), np.asarray(jv.weight),
            np.asarray(jv.origin), jv.voxel_size)
    want = jtsdf.surface_nets(*args, color=np.asarray(jv.color))
    got = ttsdf.surface_nets(*args, color=np.asarray(jv.color))
    assert want[1].shape[0] > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # an empty volume
    empty = ttsdf.surface_nets(np.ones((4, 4, 4)), np.ones((4, 4, 4)),
                               np.zeros(3), 1.0)
    assert empty[0].shape == (0, 3) and empty[2] is None
    rng = np.random.default_rng(5)
    graphs = [want, (rng.random((500, 3)), rng.integers(0, 500, (300, 3)),
                     None)]
    for verts, faces, colors in graphs:
        for frac in (0.0, 0.005, 0.02, 0.3):
            g = tmesh.keep_large_clusters(verts, faces, colors, frac)
            w = jmesh.keep_large_clusters(verts, faces, colors, frac)
            for a, b in zip(g, w):
                if b is None:
                    assert a is None
                else:
                    np.testing.assert_array_equal(a, b)


def test_save_mesh_ply_matches_jax(fused, tmp_path):
    jv, _ = fused
    verts, faces, colors = jtsdf.surface_nets(
        np.asarray(jv.tsdf), np.asarray(jv.weight), np.asarray(jv.origin),
        jv.voxel_size, color=np.asarray(jv.color))
    for c in (colors, None):
        jtsdf.save_mesh_ply(str(tmp_path / "j.ply"), verts, faces, c)
        ttsdf.save_mesh_ply(str(tmp_path / "t.ply"), verts, faces, c)
        assert (tmp_path / "j.ply").read_bytes() == \
            (tmp_path / "t.ply").read_bytes()


def _dump(dirp, imgs):
    from PIL import Image
    os.makedirs(dirp, exist_ok=True)
    for i, im in enumerate(imgs):
        Image.fromarray((im * 255).astype(np.uint8)).save(
            os.path.join(dirp, f"{i:05d}.png"))


def test_eval_paths_match_jax(tmp_path):
    """``tests/test_eval_paths.py``'s cases on both packages (the VGG FID
    and LPIPS: ``tests/test_torch_eval.py``)."""
    rng = np.random.default_rng(0)
    gt = [rng.random((32, 32, 3)).astype(np.float32) for _ in range(3)]
    near = [np.clip(g + rng.normal(0, 0.01, g.shape), 0, 1
                    ).astype(np.float32) for g in gt]
    _dump(str(tmp_path / "gt"), gt)
    _dump(str(tmp_path / "r"), near)
    got = tmetrics.evaluate_dirs(str(tmp_path / "r"), str(tmp_path / "gt"),
                                 device="cpu")
    want = jmetrics.evaluate_dirs(str(tmp_path / "r"), str(tmp_path / "gt"))
    assert got["n"] == want["n"] == 3
    assert got["psnr"] > 35 and got["ssim"] > 0.9
    assert abs(got["psnr"] - want["psnr"]) < 1e-4
    assert abs(got["ssim"] - want["ssim"]) < 1e-6
    # a weight file that does not exist is skipped, as the JAX package
    # skips it: no LPIPS
    got = tmetrics.evaluate_dirs(str(tmp_path / "r"), str(tmp_path / "gt"),
                                 lpips_weights=str(tmp_path / "w.npz"),
                                 device="cpu")
    want = jmetrics.evaluate_dirs(str(tmp_path / "r"), str(tmp_path / "gt"),
                                  lpips_weights=str(tmp_path / "w.npz"))
    assert set(got) == set(want) == {"n", "psnr", "ssim"}

    a = rng.normal(size=(500, 8))
    b = rng.normal(size=(500, 8)) + 3.0
    for x, y in ((a, a), (a, b), (rng.normal(size=(5, 16)),
                                 rng.normal(size=(5, 16)) + 2.0)):
        st_x, st_y = tmetrics.activation_stats(x), tmetrics.activation_stats(y)
        for s, w in zip(st_x, jmetrics.activation_stats(x)):
            np.testing.assert_array_equal(s, w)
        assert tmetrics.frechet_distance(*st_x, *st_y) == \
            jmetrics.frechet_distance(*st_x, *st_y)
    assert tmetrics.frechet_distance(*st_x, *st_x) < 1e-4
    feat = lambda img: img.reshape(-1, 3).mean(0)
    assert tmetrics.fid_from_dirs(str(tmp_path / "r"), str(tmp_path / "gt"),
                                  feat) == jmetrics.fid_from_dirs(
        str(tmp_path / "r"), str(tmp_path / "gt"), feat)

    th = np.linspace(0, 2 * np.pi, 20, endpoint=False)
    c2ws = np.stack([np.eye(4)] * 20)
    c2ws[:, :3, 3] = np.stack([3 * np.cos(th), 2 * np.sin(th),
                               0.1 * rng.random(20)], 1)
    np.testing.assert_array_equal(
        tpaths.generate_ellipse_path(c2ws, n_frames=24),
        jpaths.generate_ellipse_path(c2ws, n_frames=24))
    for g, w in zip(tpaths.transform_poses_pca(c2ws),
                    jpaths.transform_poses_pca(c2ws)):
        np.testing.assert_array_equal(g, w)

    _dump(str(tmp_path / "fr"), [rng.random((16, 16, 3)) for _ in range(4)])
    gif_t = tpaths.write_video(str(tmp_path / "fr"), str(tmp_path / "t"))
    gif_j = jpaths.write_video(str(tmp_path / "fr"), str(tmp_path / "j"))
    assert gif_t.endswith(".gif")
    with open(gif_t, "rb") as f, open(gif_j, "rb") as g:
        assert f.read() == g.read()


def test_checkpoint_discovery_matches_jax(tmp_path):
    mp = str(tmp_path)
    for name in ("iteration_7", "iteration_30", "iteration_x", "other"):
        os.makedirs(os.path.join(mp, "point_cloud", name))
    for r in (1, 2, 5):
        os.makedirs(os.path.join(mp, f"instance_workspace_{r}"))
    for r in (1, 2):
        d = os.path.join(mp, f"instance_workspace_{r}", "checkpoint")
        os.makedirs(d)
        open(os.path.join(d, "point_cloud.ply"), "w").close()
    pc = os.path.join(mp, "point_cloud")
    for t, j in ((tckpt.search_max_iteration(pc), 30),
                 (tckpt.search_max_iteration(pc + "_none"), None),
                 (tckpt.search_max_inpaint_round(mp), 5),
                 (tckpt.search_max_inpaint_round(mp + "_none"), 0)):
        assert t == j
    assert tckpt.search_max_iteration(pc) == jckpt.search_max_iteration(pc)
    assert tckpt.search_max_inpaint_round(mp) == \
        jckpt.search_max_inpaint_round(mp)
    assert tckpt.latest_unveiled_checkpoint(mp) == \
        jckpt.latest_unveiled_checkpoint(mp) == os.path.join(
            mp, "instance_workspace_2", "checkpoint", "point_cloud.ply")
    assert tckpt.latest_unveiled_checkpoint(mp + "_none") is None


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny model trained by the port's training CLI with the sky and
    semantics (600 points, 4 cameras at 64x48, one held out), with its
    training log panels and a profiler trace."""
    from streetunveiler_torch.cli import train as cli_train
    mp = str(tmp_path_factory.mktemp("model") / "m")
    cli_train.main(["--model_path", mp, "--iterations", "6", "--eval",
                    "--sky", "--semantics", "--log_every", "3",
                    "--eval_every", "0", "--profile", "--device", "cpu"]
                   + SYNTH)
    return mp


def test_cli_train_profile_and_logger(model_dir, tmp_path):
    """``--profile`` writes a Chrome trace that holds the step's own ranges;
    ``TrainLogger`` writes scalars as JSON lines (the loop's
    ``perf/rays_per_s`` among them) and ``train_scene(panel_every=)``'s
    panels as PNGs."""
    import json

    from streetunveiler_torch.cli.common import load_scene_info
    from streetunveiler_torch.config import load_config
    from streetunveiler_torch.scene.scene import Scene
    from streetunveiler_torch.train.loop import train_scene
    from streetunveiler_torch.utils.logging import TrainLogger
    with open(os.path.join(model_dir, "logs", "profile", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"train.forward", "train.backward"} <= names
    model = load_config(model_dir)["model"]
    scene = Scene(load_scene_info(model, device="cpu"), device="cpu")
    state = scene.create_state()
    from PIL import Image
    logger = TrainLogger(str(tmp_path / "logs"))
    train_scene(scene, state, load_config(model_dir)["optimization"],
                iterations=4, log_every=2, logger=logger, panel_every=4,
                device="cpu")
    logger.close()
    panels = tmp_path / "logs" / "panels" / "render"
    assert sorted(os.listdir(panels)) == ["000004.png"]
    assert np.asarray(Image.open(panels / "000004.png")).shape == (48, 64, 3)
    with open(tmp_path / "logs" / "train_log.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [2, 4]
    assert recs[-1]["perf/rays_per_s"] == pytest.approx(
        recs[-1]["perf/iters_per_s"] * 64 * 48) and \
        recs[-1]["perf/rays_per_s"] > 0


def _png(path):
    from PIL import Image
    return np.asarray(Image.open(path)).astype(np.int16)


def _ply(path):
    with open(path, "rb") as f:
        data = f.read()
    head, body = data.split(b"end_header\n", 1)
    lines = head.decode().splitlines()
    nv = int(next(l for l in lines if l.startswith("element vertex")
                  ).split()[-1])
    nf = int(next(l for l in lines if l.startswith("element face")
                  ).split()[-1])
    vdt = [("xyz", "<f4", 3)] + ([("rgb", "u1", 3)]
                                 if "property uchar red" in lines else [])
    v = np.frombuffer(body, dtype=vdt, count=nv)
    return v["xyz"], nf


VOXEL = 0.1


@pytest.fixture(scope="module")
def rendered(model_dir, tmp_path_factory):
    """``cli.render --semantics --voxel_size 0.1`` of both packages on
    copies of one checkpoint: (JAX dir, port dir, the port's summary)."""
    root = tmp_path_factory.mktemp("render")
    dirs = {}
    for name in ("j", "t"):
        dirs[name] = str(root / name)
        shutil.copytree(model_dir, dirs[name])
    flags = ["--semantics", "--voxel_size", str(VOXEL)]
    jcli_render.main(["--model_path", dirs["j"]] + flags)
    summary = tcli_render.main(["--model_path", dirs["t"], "--device",
                                "cpu"] + flags)
    return dirs["j"], dirs["t"], summary


def test_render_cli_matches_jax(rendered):
    """Every PNG within one level, the same meshes."""
    jdir, tdir, summary = rendered
    assert summary["unveiled"] is None and summary["iteration"] == 6
    assert summary["train_views"] == 3 and summary["test_views"] == 1
    assert np.isfinite(summary["train_psnr"])
    n_png = 0
    for split in ("train", "test"):
        for sub in ("renders", "gt", "depth", "normal", "semantic"):
            rel = os.path.join(split, "ours_6", sub)
            names = sorted(os.listdir(os.path.join(jdir, rel)))
            assert names == sorted(os.listdir(os.path.join(tdir, rel)))
            for n in names:
                a = _png(os.path.join(jdir, rel, n))
                b = _png(os.path.join(tdir, rel, n))
                assert a.shape == b.shape
                assert np.abs(a - b).max() <= 1, (rel, n)
                n_png += 1
    assert n_png == 20
    for name in ("fuse.ply", "fuse_post.ply"):
        vj, fj = _ply(os.path.join(jdir, "train", "ours_6", name))
        vt, ft = _ply(os.path.join(tdir, "train", "ours_6", name))
        assert vt.shape == vj.shape and ft == fj and fj > 0, name
        np.testing.assert_allclose(vt, vj, atol=1e-3 * VOXEL, rtol=0)
    assert summary["mesh_faces"] == _ply(os.path.join(
        tdir, "train", "ours_6", "fuse.ply"))[1]


def test_extract_mesh_matches_render_cli(rendered):
    """``extract_mesh`` with the CLI's arguments and the default cluster
    filter gives the CLI's ``fuse_post.ply``."""
    from streetunveiler_torch.cli.common import load_scene_info
    from streetunveiler_torch.config import load_config
    from streetunveiler_torch.renderer import measure_duplicate_capacity
    from streetunveiler_torch.scene.scene import Scene
    _, tdir, summary = rendered
    model = load_config(tdir)["model"]
    scene = Scene(load_scene_info(model, device="cpu"), model_path=tdir,
                  device="cpu")
    state = scene.load(6)
    cap = measure_duplicate_capacity(scene.train_cameras, state,
                                     device="cpu")
    assert cap == summary["duplicate_capacity"]
    verts, faces, colors = tmesh.extract_mesh(
        scene.train_cameras[::3], state, bg=scene.background,
        voxel_size=VOXEL, duplicate_capacity=cap, device="cpu")
    vp, fp = _ply(os.path.join(tdir, "train", "ours_6", "fuse_post.ply"))
    assert faces.shape[0] == fp > 0
    np.testing.assert_array_equal(verts, vp)
    assert colors.shape == verts.shape
