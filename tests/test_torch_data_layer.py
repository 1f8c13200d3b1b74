"""Port vs JAX: the data layer's pieces — COLMAP parsing
(``streetunveiler_torch/scene/colmap.py``), ``ops/umeyama.py``,
``scene/readers/projection.py`` (colorization on the device),
``utils/pcd.py`` (the voxel downsample on the device) and
``cli/preprocess.py`` — on the same seeded numpy inputs as the JAX
package's modules.

Tolerances: the COLMAP models, colorization (colours, labels, seen), the
frustum masks, the label conversion and the COLMAP commands exactly; the
projected pixels and depths within 1e-10 relative (numpy's matrix
product rounds apart from the port's fixed order by an ulp); ``umeyama``
within 1e-10; the voxel downsample exactly and in order against the JAX
package's host library (the path that package runs when its library
loads), and as voxel-keyed sets within 1e-6 against its numpy fallback
(another key rounding and another order), on points away from voxel
edges as ``tests/test_native.py`` holds the two JAX paths.
"""

import os
import struct

import numpy as np
import pytest
import torch

import streetunveiler_tpu.native as jnative
from streetunveiler_tpu.cli import preprocess as jpre
from streetunveiler_tpu.ops import umeyama as jumeyama
from streetunveiler_tpu.scene import colmap as jcolmap
from streetunveiler_tpu.scene.readers import projection as jproj
from streetunveiler_tpu.utils import pcd as jpcd
from streetunveiler_torch.cli import preprocess
from streetunveiler_torch.ops import umeyama
from streetunveiler_torch.scene import colmap
from streetunveiler_torch.scene.readers import projection
from streetunveiler_torch.utils import pcd

torch.set_num_threads(1)


# ----------------------------------------------------------- COLMAP models

def colmap_model(seed=0, n_images=4, n_points=30):
    """A COLMAP model: three cameras of different models, images with
    their 2D points (at least one each), points with tracks."""
    rng = np.random.default_rng(seed)
    cams = {1: ("PINHOLE", 64, 48, [50.0, 51.0, 32.0, 24.0]),
            2: ("SIMPLE_RADIAL", 80, 60, [60.0, 40.0, 30.0, 0.01]),
            3: ("OPENCV", 64, 48, [50.0, 50.0, 31.5, 23.5, 0.1, -0.02,
                                   1e-3, 2e-3])}
    images = {}
    for i in range(1, n_images + 1):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        npts = int(rng.integers(1, 5))
        images[i] = (q, rng.normal(size=3), 1 + (i - 1) % 3,
                     f"frame_{i:03d}.png", rng.uniform(0, 60, (npts, 2)),
                     rng.integers(-1, n_points, npts))
    points = {pid: (rng.normal(size=3) * 5, rng.integers(0, 256, 3),
                    float(rng.random()),
                    rng.integers(1, n_images + 1, (int(rng.integers(0, 4)),
                                                   2)))
              for pid in range(1, n_points + 1)}
    return cams, images, points


def write_colmap_binary(d, cams, images, points):
    os.makedirs(d, exist_ok=True)
    ids = {name: mid for mid, (name, _) in colmap.CAMERA_MODELS.items()}
    with open(os.path.join(d, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cid, (model, w, h, params) in cams.items():
            f.write(struct.pack("<iiQQ", cid, ids[model], w, h))
            f.write(struct.pack("<" + "d" * len(params), *params))
    with open(os.path.join(d, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for iid, (q, t, cid, name, xys, pids) in images.items():
            f.write(struct.pack("<i4d3di", iid, *q, *t, cid))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(xys)))
            for (x, y), pid in zip(xys, pids):
                f.write(struct.pack("<ddq", x, y, pid))
    with open(os.path.join(d, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for pid, (xyz, rgb, err, track) in points.items():
            f.write(struct.pack("<Q3d3Bd", pid, *xyz, *map(int, rgb), err))
            f.write(struct.pack("<Q", len(track)))
            for a, b in track:
                f.write(struct.pack("<ii", a, b))


def write_colmap_text(d, cams, images, points):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "cameras.txt"), "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        for cid, (model, w, h, params) in cams.items():
            f.write(f"{cid} {model} {w} {h} "
                    + " ".join(repr(float(p)) for p in params) + "\n")
    with open(os.path.join(d, "images.txt"), "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        for iid, (q, t, cid, name, xys, pids) in images.items():
            f.write(" ".join([str(iid)] + [repr(float(v)) for v in q]
                             + [repr(float(v)) for v in t]
                             + [str(cid), name]) + "\n")
            f.write(" ".join(f"{x!r} {y!r} {int(p)}"
                             for (x, y), p in zip(xys.tolist(), pids))
                    + "\n")
    with open(os.path.join(d, "points3D.txt"), "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        for pid, (xyz, rgb, err, track) in points.items():
            f.write(" ".join([str(pid)] + [repr(float(v)) for v in xyz]
                             + [str(int(v)) for v in rgb] + [repr(err)]
                             + [str(int(v)) for v in np.ravel(track)])
                    + "\n")


def assert_models_equal(got, want):
    (gc, gi, gp), (wc, wi, wp) = got, want
    assert sorted(gc) == sorted(wc) and sorted(gi) == sorted(wi)
    for k in wc:
        assert gc[k][:4] == wc[k][:4]
        np.testing.assert_array_equal(gc[k].params, wc[k].params)
    for k in wi:
        g, w = gi[k], wi[k]
        assert (g.id, g.camera_id, g.name) == (w.id, w.camera_id, w.name)
        for a, b in [(g.qvec, w.qvec), (g.tvec, w.tvec), (g.xys, w.xys),
                     (g.point3D_ids, w.point3D_ids)]:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for a, b in zip(gp, wp):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", ["binary", "text"])
def test_colmap_model_matches_jax(tmp_path, fmt):
    model = colmap_model()
    d = str(tmp_path / fmt)
    (write_colmap_binary if fmt == "binary" else write_colmap_text)(d, *model)
    got = colmap.load_colmap_model(d)
    assert_models_equal(got, jcolmap.load_colmap_model(d))
    cams, images, points = model
    assert got[1][2].name == images[2][3]
    np.testing.assert_array_equal(got[2][0], np.stack(
        [p[0] for p in points.values()]))


def test_quaternions_match_jax():
    rng = np.random.default_rng(1)
    for q in rng.normal(size=(20, 4)):
        q /= np.linalg.norm(q)
        R = colmap.qvec2rotmat(q)
        np.testing.assert_array_equal(R, jcolmap.qvec2rotmat(q))
        np.testing.assert_array_equal(colmap.rotmat2qvec(R),
                                      jcolmap.rotmat2qvec(R))
        np.testing.assert_allclose(colmap.rotmat2qvec(R),
                                   q * np.sign(q[0]), atol=1e-12)


# ---------------------------------------------------------------- umeyama

@pytest.mark.parametrize("allow_scale", [True, False])
def test_umeyama_matches_jax(allow_scale):
    rng = np.random.default_rng(0)
    src = rng.normal(size=(40, 3))
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.linalg.det(q))
    tgt = 2.5 * src @ q.T + np.array([1.0, -2.0, 3.0]) \
        + rng.normal(scale=0.01, size=src.shape)
    got = umeyama.umeyama(tgt, src, allow_scale)
    want = jumeyama.umeyama(tgt, src, allow_scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)
    np.testing.assert_allclose(umeyama.apply_similarity(src, *got[1:]),
                               jumeyama.apply_similarity(src, *want[1:]),
                               rtol=0, atol=1e-10)


# ------------------------------------------------------------ colorization

def _yaw_w2c(yaw, center):
    c, s = np.cos(yaw), np.sin(yaw)
    c2w = np.eye(4)
    c2w[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    c2w[:3, 3] = center
    return np.linalg.inv(c2w)


def colorize_frames(seed=0, n_frames=5, w=96, h=64):
    """Frames with yawed cameras stepped along z, random images, label
    maps of blocks of classes (one frame without a label map)."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n_frames):
        sem = np.repeat(np.repeat(rng.integers(0, 6, (h // 16, w // 16)),
                                  16, 0), 16, 1).astype(np.int32)
        frames.append(dict(
            w2c=_yaw_w2c(rng.uniform(-0.8, 0.8), [0.0, 0.0, 1.5 * i]),
            K=np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]],
                       np.float32),
            image=rng.random((h, w, 3)).astype(np.float32),
            semantic=None if i == 2 else sem))
    return frames


def test_colorize_matches_jax():
    rng = np.random.default_rng(2)
    pts = np.stack([rng.uniform(-8, 8, 5000), rng.uniform(-3, 3, 5000),
                    rng.uniform(-4, 16, 5000)], 1).astype(np.float32)
    frames = colorize_frames()
    got = projection.colorize_points_from_frames(pts, frames, device="cpu")
    want = jproj.colorize_points_from_frames(pts, frames)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    seen = got[2]
    assert 0 < seen.sum() < len(seen) and (got[1][seen] >= 0).all()
    fr = frames[0]
    mask, pix, depth = projection.cull_mask_in_frame(
        pts, fr["w2c"], fr["K"], 96, 64)
    jm, jpix, jdepth = jproj.cull_mask_in_frame(pts, fr["w2c"], fr["K"], 96,
                                                64)
    np.testing.assert_array_equal(mask.numpy(), jm)
    np.testing.assert_allclose(pix.numpy(), jpix, rtol=1e-10)
    np.testing.assert_allclose(depth.numpy(), jdepth, rtol=1e-10)
    lab = torch.as_tensor(fr["semantic"])[pix[mask, 1].long(),
                                          pix[mask, 0].long()]
    np.testing.assert_array_equal(
        projection.certain_semantic_mask(pix[mask], lab,
                                         torch.as_tensor(fr["semantic"]))
        .numpy(), jproj.certain_semantic_mask(jpix[jm], lab.numpy(),
                                              fr["semantic"]))


# --------------------------------------------------------- voxel downsample

def _cloud(seed, n=6000, spread=(12.0, 3.0, 20.0), classes=6):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * spread).astype(np.float32)
    pts[: n // 10] = pts[n // 10: n // 5]          # repeated points
    cols = (rng.integers(0, 256, (n, 3)) / 255.0).astype(np.float32)
    sem = rng.integers(0, classes, n).astype(np.int32)
    return pts, cols, sem


@pytest.mark.parametrize("voxel,agreement", [(0.15, 0.8), (1.0, 0.4),
                                             (0.5, 0.0), (2.0, 0.8)])
def test_voxel_down_sample_matches_native_in_order(voxel, agreement):
    assert jnative.available()
    pts, cols, sem = _cloud(int(voxel * 10))
    got = pcd.voxel_down_sample(pcd.SemanticPointCloud(pts, cols, sem),
                                voxel, agreement, device="cpu")
    want = jpcd.voxel_down_sample(jpcd.SemanticPointCloud(pts, cols, sem),
                                  voxel, agreement)
    assert len(got.points) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    again = pcd.voxel_down_sample(pcd.SemanticPointCloud(pts, cols, sem),
                                  voxel, agreement, device="cpu")
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g, a)


def test_voxel_down_sample_majority_ties_and_sum_order():
    """The first class wins a tie, a voxel below the agreement goes, and
    coordinates 2^53 apart share a voxel."""
    tiny = 2.0 ** -53
    pts = np.array([[tiny, 0.1, 0.1], [1.0, 0.2, 0.2], [tiny, 0.3, 0.3],
                    [5.1, 5.1, 5.1], [5.2, 5.2, 5.2], [9.5, 9.5, 9.5],
                    [9.6, 9.6, 9.6], [9.7, 9.7, 9.7]], np.float32)
    cols = np.full((8, 3), 0.5, np.float32)
    sem = np.array([2, 2, 2, 3, 1, 4, 4, 0], np.int32)
    for agreement in (0.8, 0.5, 0.0):
        got = pcd.voxel_down_sample(pcd.SemanticPointCloud(pts, cols, sem),
                                    2.0, agreement, device="cpu")
        want = jpcd.voxel_down_sample(
            jpcd.SemanticPointCloud(pts, cols, sem), 2.0, agreement)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert got.semantics.tolist() == [2, 1, 4]


def test_voxel_down_sample_against_numpy_fallback(monkeypatch):
    """As voxel-keyed sets against the JAX package's numpy fallback (float64
    keys, sorted order), on points away from voxel edges."""
    rng = np.random.default_rng(4)
    base = rng.integers(0, 20, (4000, 3)).astype(np.float32)
    pts = base + rng.uniform(0.2, 0.8, (4000, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (4000, 3)).astype(np.float32)
    sem = rng.integers(0, 6, 4000).astype(np.int32)
    got = pcd.voxel_down_sample(pcd.SemanticPointCloud(pts, cols, sem), 1.0,
                                0.6, device="cpu")
    monkeypatch.setattr(jnative, "voxel_downsample", lambda *a, **k: None)
    want = jpcd.voxel_down_sample(jpcd.SemanticPointCloud(pts, cols, sem),
                                  1.0, 0.6)

    def keyed(x):
        k = np.floor(x.points).astype(np.int64)
        order = np.lexsort((k[:, 2], k[:, 1], k[:, 0]))
        return x.points[order], x.colors[order], x.semantics[order]

    assert got.points.shape == want.points.shape
    for g, w in zip(keyed(got), keyed(want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_voxel_down_sample_empty_cloud():
    empty = pcd.SemanticPointCloud(np.zeros((0, 3), np.float32),
                                   np.zeros((0, 3), np.float32),
                                   np.zeros(0, np.int32))
    assert pcd.voxel_down_sample(empty, 0.15, device="cpu") is empty


# ------------------------------------------------------------- preprocess

def test_convert_label_pngs_matches_jax(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(0)
    png = tmp_path / "png"
    png.mkdir()
    for i in range(3):
        arr = rng.integers(0, 19, (24, 32)).astype(np.uint8)
        if i == 1:
            arr = np.stack([arr, arr * 0, arr * 0], -1)
        Image.fromarray(arr).save(png / f"{i:04d}.png")
    (png / "notes.txt").write_text("not a label map")
    n = preprocess.convert_label_pngs(str(png), str(tmp_path / "t"))
    assert n == jpre.convert_label_pngs(str(png), str(tmp_path / "j")) == 3
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))
    for name in os.listdir(tmp_path / "j"):
        with np.load(tmp_path / "t" / name) as g, \
                np.load(tmp_path / "j" / name) as w:
            assert g["arr_0"].dtype == w["arr_0"].dtype
            np.testing.assert_array_equal(g["arr_0"], w["arr_0"])


def test_colmap_commands_and_main(tmp_path, capsys):
    for model in ("OPENCV", "PINHOLE"):
        assert preprocess.colmap_commands("/data/s", model) == \
            jpre.colmap_commands("/data/s", model)
    preprocess.main(["--source_path", str(tmp_path), "--dry_run"])
    got = capsys.readouterr().out
    jpre.main(["--source_path", str(tmp_path), "--dry_run"])
    assert got == capsys.readouterr().out
    assert got.count("$ colmap ") == 4
