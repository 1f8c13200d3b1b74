"""Port vs JAX: the seven dataset readers (``streetunveiler_torch/scene/
readers/``), ``scene.load_scene``, and the training and render CLIs on a
Waymo layout, on the on-disk layouts of ``tests/test_data_layer.py`` and
``tests/test_driving_readers.py`` (their helpers imported, the inline
ones copied with seeded data) and on a Waymo segment with three cameras,
label maps of several classes, invalid LiDAR returns and a COLMAP model
to align.

Tolerances: every ``SceneInfo`` field exactly — the cameras in float64,
the images and semantic maps, the point cloud in order (the driving
readers colour and voxel-downsample it on the device: the port's
``voxel_down_sample`` holds the JAX package's host-library semantics,
which is the path that package runs when its library loads).
"""

import gzip
import inspect
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_data_layer import _fake_image
from test_driving_readers import _fake_kitti, _fake_waymo, _write_png
from test_torch_data_layer import colmap_model, write_colmap_binary

import streetunveiler_tpu.native as jnative
from streetunveiler_tpu.config import load_config as jload_config
from streetunveiler_tpu.scene import readers as jreaders
from streetunveiler_tpu.scene.colmap import rotmat2qvec
from streetunveiler_torch.scene import readers
from streetunveiler_torch.scene.scene import load_scene

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_infos_equal(got, want):
    assert got._fields == want._fields
    for split in ("train_cameras", "test_cameras"):
        gs, ws = getattr(got, split), getattr(want, split)
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            assert g._fields == w._fields
            for name in g._fields:
                a, b = getattr(g, name), getattr(w, name)
                if isinstance(b, np.ndarray):
                    assert a.dtype == b.dtype, name
                    np.testing.assert_array_equal(a, b)
                else:
                    assert a == b, name
    for cloud in ("point_cloud", "reference_cloud"):
        for a, b in zip(getattr(got, cloud), getattr(want, cloud)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    gn, wn = got.nerf_normalization, want.nerf_normalization
    np.testing.assert_array_equal(gn["translate"], wn["translate"])
    assert gn["radius"] == wn["radius"]
    for name in ("ply_path", "reference_ply_path", "camera_frame_dict",
                 "background"):
        assert getattr(got, name) == getattr(want, name), name


# ------------------------------------------------------------ the layouts

def waymo_segment(tmp_path, n_frames=3, w=64, h=48, f=50.0):
    """A Waymo segment: cameras FRONT and FRONT_LEFT/RIGHT (yawed ±45°)
    stepped 1.5 m along z and 0.8 m sideways in turn, random images, label
    maps of four cityscapes classes in regions, 400 LiDAR rays a frame to
    points ahead (5% of ranges 0), and a COLMAP model of the front
    camera's poses under a similarity, with sparse points."""
    rng = np.random.default_rng(7)
    root, colmap = tmp_path / "seg", tmp_path / "segcolmap"
    (root / "lidars" / "lidar_TOP").mkdir(parents=True)
    (colmap / "input_masks").mkdir(parents=True)
    observers = {}
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    for rank, (cam, yaw) in enumerate([("camera_FRONT", 0.0),
                                       ("camera_FRONT_LEFT", -np.pi / 4),
                                       ("camera_FRONT_RIGHT", np.pi / 4)]):
        c, s = np.cos(yaw), np.sin(yaw)
        c2ws = []
        for i in range(n_frames):
            c2w = np.eye(4)
            c2w[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
            c2w[0, 3], c2w[2, 3] = 0.8 * (i % 2), 1.5 * i
            c2ws.append(c2w)
            _write_png(str(root / "images" / cam / f"{i:08d}.jpg"),
                       rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
            ids = np.full((h, w), 2, np.uint8)      # building
            ids[h // 2:] = 0                        # road
            ids[h // 4:3 * h // 4, w // 3:2 * w // 3] = 13    # car
            ids[:, :w // 8] = 8                     # vegetation
            np.savez(colmap / "input_masks" / f"{i + rank * n_frames:05d}"
                     ".npz", ids)
        observers[cam] = {"data": {"c2w": np.asarray(c2ws),
                                   "intr": np.repeat(K[None], n_frames, 0),
                                   "hw": np.tile([h, w], (n_frames, 1))}}
    torch.save({"observers": observers}, root / "scenario.pt")
    for i in range(n_frames):
        pts = np.stack([rng.uniform(-6, 6, 400), rng.uniform(-2, 2, 400),
                        rng.uniform(4, 14, 400) + 1.5 * i], 1)
        o = np.array([0.0, -0.5, 1.5 * i])
        dist = np.linalg.norm(pts - o, axis=1)
        ranges = np.where(rng.random(400) < 0.05, 0.0, dist)
        np.savez(root / "lidars" / "lidar_TOP" / f"{i:08d}.npz",
                 rays_o=np.tile(o, (400, 1)).astype(np.float32),
                 rays_d=((pts - o) / dist[:, None]).astype(np.float32),
                 ranges=ranges.astype(np.float32))
    # COLMAP frame = (dataset frame − t) / c, rotated: the front camera's
    # centres as COLMAP images named like the dataset's cameras, and
    # points ahead of the rig
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.linalg.det(q))
    c, t = 0.5, np.array([1.0, 0.0, -2.0])
    cams, _, _ = colmap_model(seed=1)
    ahead = np.stack([rng.uniform(-4, 4, 60), rng.uniform(-1.5, 1.5, 60),
                      rng.uniform(4, 12, 60)], 1)
    points = {k + 1: (q @ (p - t) / c, rng.integers(0, 256, 3), 0.5,
                      np.zeros((0, 2), int)) for k, p in enumerate(ahead)}
    images = {}
    for i in range(n_frames):
        c2w = observers["camera_FRONT"]["data"]["c2w"][i]
        R_col = q @ c2w[:3, :3]                 # camera to COLMAP world
        centre = q @ (c2w[:3, 3] - t) / c
        images[i + 1] = (rotmat2qvec(R_col.T), -R_col.T @ centre, 1,
                         f"camera_FRONT_{i:08d}", np.zeros((1, 2)),
                         np.array([-1]))
    write_colmap_binary(str(colmap / "sparse" / "0"), cams, images, points)
    return str(root), str(colmap)


def pandaset_layout(tmp_path):
    """``tests/test_data_layer.py``'s Pandaset layout, the LiDAR seeded."""
    rng = np.random.default_rng(0)
    seq = tmp_path / "001"
    cam = seq / "camera" / "front_camera"
    os.makedirs(cam)
    poses = [dict(heading=dict(w=1, x=0, y=0, z=0),
                  position=dict(x=0, y=0, z=float(i))) for i in range(3)]
    json.dump(poses, open(cam / "poses.json", "w"))
    json.dump(dict(fx=40, fy=40, cx=32, cy=24),
              open(cam / "intrinsics.json", "w"))
    for i in range(3):
        _fake_image(str(cam / f"{i:02d}.jpg"))
    ldir = seq / "lidar"
    os.makedirs(ldir)
    pts = dict(x=rng.random(50) * 4 - 2, y=rng.random(50) * 2 - 1,
               z=rng.random(50) * 5 + 2)
    with gzip.open(ldir / "00.pkl.gz", "wb") as f:
        pickle.dump(pts, f)
    return str(tmp_path)


def nuscenes_layout(tmp_path):
    """``tests/test_data_layer.py``'s nuScenes layout, the LiDAR seeded."""
    rng = np.random.default_rng(1)
    meta = tmp_path / "v1.0-mini"
    os.makedirs(meta)

    def dump(name, rows):
        json.dump(rows, open(meta / f"{name}.json", "w"))

    dump("scene", [dict(token="sc", name="scene-0001",
                        first_sample_token="s0")])
    dump("sample", [dict(token="s0", next="s1"),
                    dict(token="s1", next="")])
    dump("sensor", [dict(token="senc", channel="CAM_FRONT"),
                    dict(token="senl", channel="LIDAR_TOP")])
    dump("calibrated_sensor", [
        dict(token="csc", sensor_token="senc", rotation=[1, 0, 0, 0],
             translation=[0, 0, 0],
             camera_intrinsic=[[40, 0, 32], [0, 40, 24], [0, 0, 1]]),
        dict(token="csl", sensor_token="senl", rotation=[1, 0, 0, 0],
             translation=[0, 0, 0], camera_intrinsic=[])])
    dump("ego_pose", [dict(token=f"e{i}", rotation=[1, 0, 0, 0],
                           translation=[0, 0, float(i)])
                      for i in range(2)])
    sds = []
    for i in range(2):
        sds.append(dict(token=f"sdc{i}", sample_token=f"s{i}",
                        calibrated_sensor_token="csc",
                        ego_pose_token=f"e{i}", is_key_frame=True,
                        filename=f"samples/CAM_FRONT/{i}.jpg",
                        width=64, height=48))
        sds.append(dict(token=f"sdl{i}", sample_token=f"s{i}",
                        calibrated_sensor_token="csl",
                        ego_pose_token=f"e{i}", is_key_frame=True,
                        filename=f"samples/LIDAR_TOP/{i}.pcd.bin",
                        width=0, height=0))
    dump("sample_data", sds)
    for i in range(2):
        _fake_image(str(tmp_path / "samples" / "CAM_FRONT" / f"{i}.jpg"))
        os.makedirs(tmp_path / "samples" / "LIDAR_TOP", exist_ok=True)
        scan = rng.random((30, 5)).astype(np.float32)
        scan[:, 2] += 1.0
        scan.tofile(tmp_path / "samples" / "LIDAR_TOP" / f"{i}.pcd.bin")
    return str(tmp_path)


def blender_layout(tmp_path):
    """``tests/test_data_layer.py``'s Blender layout, with RGBA images."""
    rng = np.random.default_rng(2)
    from PIL import Image
    frames = []
    for split in ("train", "test"):
        for i in range(2):
            c2w = np.eye(4)
            c2w[:3, 3] = [0.3 * i, 0.0, 4.0]
            frames.append(dict(file_path=f"./{split}/r_{i}",
                               transform_matrix=c2w.tolist()))
            os.makedirs(tmp_path / split, exist_ok=True)
            Image.fromarray(rng.integers(0, 256, (40, 50, 4)).astype(
                np.uint8)).save(tmp_path / split / f"r_{i}.png")
        json.dump(dict(camera_angle_x=0.8, frames=frames[-2:]),
                  open(tmp_path / f"transforms_{split}.json", "w"))
    return str(tmp_path)


def colmap_layout(tmp_path):
    """A COLMAP scene: the binary model of ``test_torch_data_layer``, its
    images, and a semantic map for every other image."""
    rng = np.random.default_rng(3)
    cams, images, points = colmap_model(seed=2, n_images=9)
    write_colmap_binary(str(tmp_path / "sparse" / "0"), cams, images,
                        points)
    for iid, (_, _, cid, name, _, _) in images.items():
        _, w, h, _ = cams[cid]
        _write_png(str(tmp_path / "images" / name),
                   rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
        if iid % 2:
            os.makedirs(tmp_path / "semantic", exist_ok=True)
            np.savez(tmp_path / "semantic" / (os.path.splitext(name)[0]
                                              + ".npz"),
                     rng.integers(0, 19, (h, w)).astype(np.uint8))
    return str(tmp_path)


# ------------------------------------------------------------- the readers

def test_waymo_reader_matches_jax(tmp_path):
    assert jnative.available()
    root, colmap = waymo_segment(tmp_path)
    for kw in ({}, dict(start_frame=1, end_frame=3),
               dict(cameras=["camera_FRONT"], voxel_size=0.3)):
        got = readers.read_waymo_info(root, colmap, device="cpu", **kw)
        want = jreaders.read_waymo_info(root, colmap, **kw)
        assert_infos_equal(got, want)
    # the COLMAP model's points join the LiDAR's
    sparse = os.path.join(colmap, "sparse")
    os.rename(sparse, sparse + "_off")
    lidar_only = readers.read_waymo_info(root, colmap, device="cpu")
    os.rename(sparse + "_off", sparse)
    got = readers.read_waymo_info(root, colmap, device="cpu")
    assert 10 < len(lidar_only.point_cloud.points) \
        < len(got.point_cloud.points)
    # without the COLMAP directory: no masks, no alignment
    assert_infos_equal(readers.read_waymo_info(root, device="cpu"),
                       jreaders.read_waymo_info(root))


def test_waymo_reader_on_the_driving_test_layout(tmp_path):
    root, colmap = _fake_waymo(tmp_path)
    assert_infos_equal(
        readers.read_waymo_info(root, colmap, voxel_size=0.05, device="cpu"),
        jreaders.read_waymo_info(root, colmap, voxel_size=0.05))


def test_waymo_reader_on_a_written_street_segment(tmp_path):
    """The street scene written by ``tools/waymo_segment.py`` (renders as
    images, the semantic render's argmax as masks, LiDAR rays to surfel
    centres with invalid returns), at a toy size."""
    from streetunveiler_torch.tools import street, waymo_segment
    state = street.street_state(600, device="cpu", scale=street.W / 96)
    root, colmap = str(tmp_path / "seg"), str(tmp_path / "segcolmap")
    counts = waymo_segment.write_segment(
        state, root, colmap, frames=2, rays=400, width=96, height=64,
        focal=street.FOCAL * 96 / street.W, device="cpu")
    assert counts["cameras"] == 6 and 0 < counts["lidar_valid"] < 800
    got = readers.read_waymo_info(root, colmap, device="cpu")
    assert_infos_equal(got, jreaders.read_waymo_info(root, colmap))
    assert len(got.train_cameras) == 6 and len(got.point_cloud.points) > 0


def test_kitti_reader_matches_jax(tmp_path):
    base, date, drive, colmap = _fake_kitti(tmp_path)
    for kw in (dict(voxel_size=0.05), dict(end_frame=1)):
        assert_infos_equal(
            readers.read_kitti_info(base, date, drive, colmap, device="cpu",
                                    **kw),
            jreaders.read_kitti_info(base, date, drive, colmap, **kw))


def test_pandaset_reader_matches_jax(tmp_path):
    path = pandaset_layout(tmp_path)
    got = readers.read_pandaset_info(path, "001", cameras=["front_camera"],
                                     device="cpu")
    assert_infos_equal(got, jreaders.read_pandaset_info(
        path, "001", cameras=["front_camera"]))
    assert got.camera_frame_dict["front_end"] == 3


def test_nuscenes_reader_matches_jax(tmp_path):
    path = nuscenes_layout(tmp_path)
    got = readers.read_nuscenes_info(path, "scene-0001",
                                     cameras=["CAM_FRONT"], device="cpu")
    assert_infos_equal(got, jreaders.read_nuscenes_info(
        path, "scene-0001", cameras=["CAM_FRONT"]))
    assert len(got.train_cameras) == 2


def test_blender_and_colmap_readers_match_jax(tmp_path):
    path = blender_layout(tmp_path / "blender")
    for white in (False, True):
        got = readers.read_blender_info(path, white_background=white,
                                        n_init_points=500)
        assert_infos_equal(got, jreaders.read_blender_info(
            path, white_background=white, n_init_points=500))
    assert len(got.train_cameras) == len(got.test_cameras) == 2
    path = colmap_layout(tmp_path / "colmap")
    for kw in ({}, dict(eval_split=True, llffhold=4),
               dict(load_images=False)):
        got = readers.read_colmap_scene(path, **kw)
        assert_infos_equal(got, jreaders.read_colmap_scene(path, **kw))
    assert sum(c.semantics is not None for c in got.train_cameras) == 5


def test_scene_readers_and_load_scene(tmp_path):
    assert sorted(readers.SCENE_READERS) == sorted(jreaders.SCENE_READERS)
    # load_scene passes ``device`` to every reader
    for kind, fn in readers.SCENE_READERS.items():
        assert "device" in inspect.signature(fn).parameters, kind
    root, colmap = _fake_waymo(tmp_path)
    scene = load_scene("waymo", path=root, colmap_path=colmap,
                       voxel_size=0.05, resolution=1, device="cpu")
    info = jreaders.read_waymo_info(root, colmap, voxel_size=0.05)
    assert len(scene.train_cameras) == 2 and scene.device.type == "cpu"
    np.testing.assert_array_equal(scene.info.point_cloud.points,
                                  info.point_cloud.points)
    np.testing.assert_array_equal(scene.train_images[1],
                                  info.train_cameras[1].image)


# ------------------------------------------------------------------ the CLIs

def test_train_cli_on_a_waymo_layout_and_render_reloads_it(tmp_path):
    """``cli.train --scene waymo --device cpu`` on the driving tests'
    layout: the selectors persist in ``cfg_args.json`` (readable by the
    JAX package), the loss stays finite, and the render CLI reloads the
    same scene from it."""
    from streetunveiler_torch.cli import render as cli_render
    from streetunveiler_torch.cli import train as cli_train
    root, colmap = _fake_waymo(tmp_path)
    out = str(tmp_path / "model")
    state, reports = cli_train.main([
        "--scene", "waymo", "--source_path", root, "--colmap_path", colmap,
        "--model_path", out, "--start_frame", "0", "--end_frame", "2",
        "--iterations", "4", "--log_every", "2", "--eval_every", "0",
        "--semantics", "--device", "cpu"])
    assert [r.iteration for r in reports] == [2, 4]
    assert all(np.isfinite(r.loss) for r in reports)
    info = readers.read_waymo_info(root, colmap, device="cpu")
    assert int(state.num_alive) == len(info.point_cloud.points)
    model = jload_config(out)["model"]
    assert (model.scene, model.source_path, model.colmap_path,
            model.start_frame, model.end_frame) == ("waymo", root, colmap,
                                                    0, 2)
    s = cli_render.main(["--model_path", out, "--skip_mesh", "--device",
                         "cpu"])
    assert s["iteration"] == 4 and s["train_views"] == 2
    assert np.isfinite(s["train_psnr"])


def test_readers_never_load_the_jax_native_library(tmp_path):
    """In a fresh interpreter, the port's readers and voxel downsample,
    imported and run through the port alone, leave no module of the JAX
    package (its host library's loader included) in ``sys.modules``, and
    the library's file untouched."""
    root, colmap = _fake_waymo(tmp_path)
    lib = os.path.join(ROOT, "streetunveiler_tpu", "native",
                       "libsu_native.so")
    before = os.stat(lib).st_mtime_ns
    code = f"""
import sys
import numpy as np
from streetunveiler_torch.scene import readers
from streetunveiler_torch.utils.pcd import SemanticPointCloud, voxel_down_sample
info = readers.read_waymo_info({root!r}, {colmap!r}, device="cpu")
assert len(info.point_cloud.points) > 0
rng = np.random.default_rng(0)
pc = SemanticPointCloud(rng.random((500, 3), dtype=np.float32),
                        rng.random((500, 3), dtype=np.float32),
                        rng.integers(0, 6, 500).astype(np.int32))
assert len(voxel_down_sample(pc, 0.2, device="cpu").points) > 0
bad = sorted(m for m in sys.modules
             if m.startswith("streetunveiler_tpu") or m == "jax"
             or m.startswith("jax."))
assert not bad, bad
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert os.stat(lib).st_mtime_ns == before
