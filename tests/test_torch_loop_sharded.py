"""The port's sharded training loop, its CLI, its dryrun and the chained
CLIs on the CPU (port only; the sharded step itself is held against JAX in
``tests/test_torch_shard.py``).

The loop runs on spawned gloo ranks (``parallel/dryrun.run_loop_bundles``),
in the cases of ``tests/test_loop_sharded.py``:
* ``train_scene_sharded`` on a 2×2 mesh runs and lowers the loss;
* mixed camera sizes train in buckets;
* an absurd per-slab capacity is bumped at the first log point and no
  later window overflows;
* with densification on, every rank ends with the same replica, and the
  surfel-sharded (ZeRO) loop ends with the replicated loop's state;
* the late phase with semantics and the sky trains the sky;
plus the training CLI with ``--device cpu --tile_devices 2`` (it starts
its own ranks), ``dryrun_multichip`` on 2 ranks, and the four CLIs
chained at a toy size by the end-to-end tool (``tools/e2e_config2.py``;
its 24.0 dB gate belongs to config 2 and is asserted there only).
"""

import json
import os

import numpy as np
import pytest
import torch

from streetunveiler_torch.parallel import dryrun
from streetunveiler_torch.parallel.multihost import launch_local

torch.set_num_threads(1)

NO_DENSIFY = dict(densify_from_iter=10_000)


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    root = tmp_path_factory.mktemp("loops")
    world = {
        4: {
            "improves": dict(
                scenes=[dict(n_points=500, n_cameras=4, width=64, height=64,
                             focal=50.0, seed=1)],
                capacity=1024, opt=NO_DENSIFY,
                loop=dict(n_tile=2, n_data=2, iterations=12, log_every=4)),
            "buckets": dict(
                scenes=[dict(n_points=300, n_cameras=2, width=64, height=32,
                             focal=40.0, seed=4),
                        dict(n_points=300, n_cameras=2, width=48, height=64,
                             focal=40.0, seed=5)],
                capacity=512, opt=NO_DENSIFY,
                loop=dict(n_tile=2, n_data=2, iterations=8, log_every=4)),
        },
        2: {
            "bump": dict(
                scenes=[dict(n_points=400, n_cameras=2, width=64, height=64,
                             focal=45.0, seed=4)],
                capacity=512,
                opt=dict(densify_from_iter=10**9, prune_from_iter=10**9),
                loop=dict(n_tile=2, n_data=1, iterations=4, log_every=1,
                          duplicate_capacity=128)),
            "densify": dict(
                scenes=[dict(n_points=300, n_cameras=4, width=48, height=32,
                             focal=40.0, seed=6)],
                capacity=512,
                opt=dict(densify_from_iter=2, densify_grad_threshold=1e-7),
                loop=dict(n_tile=1, n_data=2, iterations=10, log_every=5)),
            "densify_zero": dict(
                scenes=[dict(n_points=300, n_cameras=4, width=48, height=32,
                             focal=40.0, seed=6)],
                capacity=512,
                opt=dict(densify_from_iter=2, densify_grad_threshold=1e-7),
                loop=dict(n_tile=1, n_data=2, iterations=10, log_every=5,
                          shard_surfels=True)),
            "late_sky": dict(
                scenes=[dict(n_points=400, n_cameras=4, width=64, height=32,
                             focal=40.0, seed=2)],
                capacity=512, sky=True,
                opt=dict(densify_from_iter=10_000,
                         semantic_dist_from_iter=2),
                loop=dict(n_tile=2, n_data=1, iterations=6, log_every=3,
                          use_semantics=True)),
        },
    }
    dirs = {}
    for ws, cases in world.items():
        spec = []
        for name, sp in cases.items():
            out = root / name
            out.mkdir()
            dirs[name] = (str(out), ws)
            spec.append((sp, str(out)))
        launch_local(dryrun.run_loop_bundles, ws, "cpu", (spec,))

    def load(name):
        d, ws = dirs[name]
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False) for r in range(ws)]
    return load


def test_train_scene_sharded_runs_and_improves(loops):
    out = loops("improves")[0]
    reps = out["reports"]
    assert len(reps) == 3
    losses = [r["loss"] for r in reps]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert not torch.allclose(out["state"].params.xyz, out["xyz0"])


def test_buckets_of_mixed_camera_sizes(loops):
    reps = loops("buckets")[0]["reports"]
    assert len(reps) == 2
    assert np.isfinite([r["loss"] for r in reps]).all()
    assert np.isfinite([r["psnr"] for r in reps]).all()


def test_capacity_auto_bump(loops):
    reps = loops("bump")[0]["reports"]
    assert reps[0]["overflow_frac"] == 1.0, "the first window must overflow"
    assert reps[-1]["dup_capacity"] > 128, "the loop must bump the capacity"
    assert reps[-1]["overflow_frac"] == 0.0


def test_replicas_stay_equal_after_densify(loops):
    ranks = loops("densify")
    s0 = ranks[0]["state"]
    # densification ran: the alive set is no longer the initial 300
    assert int(s0.num_alive) != 300
    for r in ranks[1:]:
        s = r["state"]
        for k in ("xyz", "scaling", "rotation", "opacity", "features_dc"):
            assert torch.equal(getattr(s.params, k),
                               getattr(s0.params, k)), k
        assert torch.equal(s.alive, s0.alive)
        assert torch.equal(s.semantics, s0.semantics)


def test_zero_loop_matches_replicated(loops):
    rep, zero = loops("densify")[0]["state"], loops("densify_zero")
    for z in zero:
        s = z["state"]
        assert torch.equal(s.alive, rep.alive)
        for k in ("xyz", "scaling", "rotation", "opacity", "features_dc"):
            np.testing.assert_allclose(getattr(s.params, k).numpy(),
                                       getattr(rep.params, k).numpy(),
                                       atol=1e-6, err_msg=k)


def test_late_phase_with_sky(loops):
    out = loops("late_sky")[0]
    assert np.isfinite([r["loss"] for r in out["reports"]]).all()
    assert out["sky_moved"] is True


def test_train_cli_tile_devices_on_cpu(tmp_path):
    from streetunveiler_torch.cli.train import main
    mp = str(tmp_path / "m")
    out = main(["--model_path", mp, "--device", "cpu", "--tile_devices", "2",
                "--iterations", "6", "--log_every", "3", "--save_every",
                "6", "--synthetic_points", "300", "--synthetic_cameras", "3",
                "--synthetic_width", "48", "--synthetic_height", "32",
                "--synthetic_focal", "40"])
    assert out is None          # the ranks ran in their own processes
    assert os.path.exists(os.path.join(
        mp, "checkpoint", "iteration_6", "splatting.npz"))
    assert os.path.exists(os.path.join(mp, "point_cloud", "iteration_6",
                                       "point_cloud.ply"))
    cfg = json.load(open(os.path.join(mp, "cfg_args.json")))
    assert cfg["pipeline"]["tile_devices"] == 2


def test_train_cli_refuses_multihost_without_launcher(tmp_path):
    from streetunveiler_torch.cli.train import main
    with pytest.raises(SystemExit, match="torchrun"):
        main(["--model_path", str(tmp_path / "m"), "--device", "cpu",
              "--multihost"])


def test_local_camera_indices_split_evenly():
    """The contiguous split of ``parallel/multihost.py:38-46``."""
    from streetunveiler_torch.parallel.multihost import local_camera_indices
    parts = [local_camera_indices(10, rank=r, world_size=4)
             for r in range(4)]
    assert parts == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9]]
    assert local_camera_indices(3, rank=0, world_size=1) == [0, 1, 2]


def test_launch_refuses_more_ranks_than_cards(monkeypatch):
    """A mesh that needs more GPUs than the host has raises before any
    rank starts; NCCL never puts two ranks on one card."""
    from streetunveiler_torch.parallel import multihost
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 GPUs"):
        multihost.launch_local(dryrun.dryrun_rank, 2, "cuda", (2, "cuda"))


def test_dryrun_multichip_two_ranks():
    dryrun.dryrun_multichip(2, "cpu")


def test_e2e_toy_chain(tmp_path):
    """train → render → unveil → evaluate through the port's CLIs at a toy
    size, as the end-to-end tool chains them."""
    from streetunveiler_torch.tools import e2e_config2
    out = str(tmp_path / "record.json")
    rec = e2e_config2.main([
        "--model_path", str(tmp_path / "m"), "--device", "cpu",
        "--points", "600", "--cameras", "5", "--width", "48",
        "--height", "32", "--iterations", "16", "--reopt_iterations", "3",
        "--psnr_gate", "0",
        "--unveil_args", "--cluster_threshold 1.5 --min_cluster_size 10 "
                         "--trainable_dist 0.8 --editable_dist 0.4",
        "--mesh_args", "--mesh_res 32", "--out", out])
    assert json.load(open(out)) == json.loads(json.dumps(rec))
    for k in ("train_s", "render_mesh_s", "unveil_s", "evaluate_s",
              "init_test_psnr", "test_psnr", "n_surfels_trained",
              "mesh_bytes", "vehicles_before", "vehicles_after",
              "unveil_eval", "launches_by_stage", "device"):
        assert k in rec, k
    assert rec["device"] == "cpu"
    assert rec["vehicles_after"] < rec["vehicles_before"]
    ev = rec["unveil_eval"]
    assert ev["n"] > 0 and np.isfinite([ev["lpips"], ev["fid"]]).all()
    # on the CPU every wrapper takes its plain version: no kernel launched
    assert all(v == 0 for s in rec["launches_by_stage"].values()
               for v in s.values())
