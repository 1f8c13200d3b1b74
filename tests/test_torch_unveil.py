"""Port vs JAX: the unveil path — the scene's projection queries, ``pipeline/select.py``, ``ops/knn.
mean_dist_to_reference``, ``pipeline/masks.py``, ``models/deltas.py``,
``pipeline/inpaint.py``, ``pipeline/reoptimize.py`` and the unveil CLI,
on the JAX unveil tests' scene (600 points, 4 cameras at 64x48).

Tolerances: frustum masks, clusterings (as partitions
with their sizes), neighbourhood masks, ``apply_deltas`` and the diffuse
fill exact; pixel coordinates to 1e-4 px; the removal mask on all but
0.5% of pixels (the α difference's threshold is a knife edge) and the
background-only render within the render tolerance on all but 0.1%; the
re-optimization loss to 1e-4 relative, its gradients as the training
step's (atol 2e-4·max|g|, rtol 1e-3), and after three Adam steps the
deltas within 0.06·lr where the gradient is not tiny and 6·lr anywhere
(Adam's first steps move each entry by about ±lr·sign(g)). The JAX side
renders through its Pallas kernels in interpret mode.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streetunveiler_tpu.config import ModelParams as JModelParams
from streetunveiler_tpu.config import ReOptimizationParams as JReOpt
from streetunveiler_tpu.config import save_config as jsave_config
from streetunveiler_tpu.models import deltas as jdeltas
from streetunveiler_tpu.models.gaussians import prune_mask as jprune_mask
from streetunveiler_tpu.pipeline import inpaint as jinpaint
from streetunveiler_tpu.pipeline import masks as jmasks
from streetunveiler_tpu.pipeline import reoptimize as jreopt
from streetunveiler_tpu.pipeline import select as jselect
from streetunveiler_tpu.renderer import render as jrender
from streetunveiler_tpu.scene.readers import \
    make_synthetic_street as jmake_street
from streetunveiler_tpu.scene.scene import Scene as JScene
from streetunveiler_tpu.train.checkpoint import _flatten
from streetunveiler_tpu.train.losses import l1_loss as jl1
from streetunveiler_tpu.utils.semantics import CONCERNED_IND, VEHICLE_BIT
from streetunveiler_torch import convert
from streetunveiler_torch.config import ReOptimizationParams
from streetunveiler_torch.models import deltas as tdeltas
from streetunveiler_torch.models.gaussians import SurfelParams
from streetunveiler_torch.models.gaussians import prune_mask as tprune_mask
from streetunveiler_torch.pipeline import inpaint as tinpaint
from streetunveiler_torch.pipeline import masks as tmasks
from streetunveiler_torch.pipeline import reoptimize as treopt
from streetunveiler_torch.pipeline import select as tselect
from streetunveiler_torch.scene.readers import make_synthetic_street
from streetunveiler_torch.scene.scene import Scene
from streetunveiler_torch.train.optim import adam_init
from streetunveiler_torch.train.step import make_lrs

torch.set_num_threads(1)

SIZES = dict(n_points=600, n_cameras=4, width=64, height=48, focal=45.0,
             seed=3)
PARAMS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


def np_(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


@pytest.fixture(scope="module")
def scenes():
    """The JAX unveil tests' scene in both packages: (JAX scene, JAX
    state, port scene, port state)."""
    jscene = JScene(jmake_street(**SIZES))
    jstate = jscene.create_state(capacity=1024)
    tscene = Scene(make_synthetic_street(**SIZES, device="cpu"),
                   device="cpu")
    tstate = convert.state_from_arrays(_flatten(jstate, "state"),
                                       device="cpu")
    return jscene, jstate, tscene, tstate


@pytest.fixture(scope="module")
def removal(scenes):
    """The vehicle clustering (τ 1.5, solid from 5) of both packages, and
    the removal masks of every solid cluster."""
    _, jstate, _, tstate = scenes
    jcl = jselect.cluster_semantic_instance(jstate, VEHICLE_BIT,
                                            threshold=1.5)
    tcl = tselect.cluster_semantic_instance(tstate, VEHICLE_BIT,
                                            threshold=1.5)
    jrem = jselect.removal_mask_for_instances(jcl, [], all_solid=True,
                                              min_size=5)
    trem = tselect.removal_mask_for_instances(tcl, [], all_solid=True,
                                              min_size=5)
    return jcl, tcl, jrem, trem


def test_projection_queries_match_jax(scenes):
    jscene, jstate, tscene, _ = scenes
    xyz = np.asarray(jstate.params.xyz)[:600]
    for f in range(len(jscene.train_cameras)):
        np.testing.assert_array_equal(
            tscene.pcd_in_frame_mask(xyz, f).numpy(),
            np.asarray(jscene.pcd_in_frame_mask(jnp.asarray(xyz), f)))
        tc, td = tscene.pcd_pixel_coords(xyz, f)
        jc, jd = jscene.pcd_pixel_coords(jnp.asarray(xyz), f)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4,
                                   rtol=1e-6)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5,
                                   rtol=1e-6)
    for bits in (VEHICLE_BIT, 1 << CONCERNED_IND["building"]):
        np.testing.assert_array_equal(
            tscene.semantic_mask_of_splatting(xyz, bits),
            jscene.semantic_mask_of_splatting(xyz, bits))
    tcams, timgs, _ = tscene.at_scale(2.0)
    jcams, jimgs, _ = jscene.at_scale(2.0)
    assert tscene.at_scale(2.0)[0] is tcams
    assert tscene.at_scale(1.0)[0] is tscene.train_cameras
    for tc, jc, ti in zip(tcams, jcams, timgs):
        np.testing.assert_array_equal(tc.K.numpy(), np.asarray(jc.K))
        assert (tc.width, tc.height) == (jc.width, jc.height) == (32, 24)
        assert ti.shape == (24, 32, 3)


def _partition(labels):
    """Each surfel's group as the frozenset of its members."""
    groups = {}
    for i, lab in enumerate(labels):
        if lab >= 0:
            groups.setdefault(int(lab), set()).add(i)
    return {frozenset(g) for g in groups.values()}


def test_clustering_matches_jax(scenes, removal):
    jcl, tcl, jrem, trem = removal
    assert _partition(tcl.labels) == _partition(jcl.labels)
    np.testing.assert_array_equal(tcl.cluster_sizes, jcl.cluster_sizes)
    assert len(tcl.cluster_sizes) >= 1 and trem.sum() > 0
    np.testing.assert_array_equal(trem, jrem)
    np.testing.assert_array_equal(tselect.solid_cluster_mask(tcl, 10),
                                  jselect.solid_cluster_mask(jcl, 10))
    # the chosen-ids path, by the largest cluster's id in each numbering
    big_t = tcl.labels == tcl.cluster_ids[0]
    big_j = jcl.labels == jcl.cluster_ids[0]
    np.testing.assert_array_equal(big_t, big_j)
    np.testing.assert_array_equal(
        tselect.removal_mask_for_instances(tcl, [tcl.cluster_ids[0]]),
        jselect.removal_mask_for_instances(jcl, [jcl.cluster_ids[0]]))
    _, jstate, _, tstate = scenes
    xyz = np.asarray(jstate.params.xyz)[np.asarray(jstate.alive)]
    assert tselect.auto_cluster_threshold(xyz) == \
        jselect.auto_cluster_threshold(xyz)
    # the auto threshold end to end
    jauto = jselect.cluster_semantic_instance(jstate, VEHICLE_BIT, None)
    tauto = tselect.cluster_semantic_instance(tstate, VEHICLE_BIT, None)
    assert _partition(tauto.labels) == _partition(jauto.labels)


def test_instance_previews(scenes, removal, tmp_path):
    """The previews, the solid mask file and the solid cloud; the frame
    statistics against a per-frame loop over ``pcd_in_frame_mask``."""
    _, _, tscene, tstate = scenes
    _, tcl, _, _ = removal
    solid = tselect.render_instance_previews(
        tscene, tstate, tcl, str(tmp_path), min_size=5, device="cpu")
    np.testing.assert_array_equal(solid,
                                  tselect.solid_cluster_mask(tcl, 5))
    pngs = os.listdir(tmp_path / "instance_render")
    assert pngs and all(p.endswith(".png") for p in pngs)
    np.testing.assert_array_equal(np.load(tmp_path / "solid_cluster_mask.npy"),
                                  solid)
    with open(tmp_path / "solid_cluster.ply") as f:
        assert sum(1 for _ in f) == 10 + int(solid.sum())
    cams = tscene.train_cameras
    weights = torch.as_tensor(solid, dtype=torch.float32)
    inside, depth = tselect.frame_visibility(tscene, tstate.params.xyz)
    frac, _ = tselect.frame_stats(inside, depth, weights)
    for f in range(len(cams)):
        inside = tscene.pcd_in_frame_mask(tstate.params.xyz, f)
        assert float(frac[f]) == pytest.approx(
            float((weights * inside).sum() / weights.sum()), rel=1e-6)


def test_neighbourhoods_and_frame_mask_match_jax(scenes, removal):
    jscene, jstate, tscene, tstate = scenes
    _, _, jrem, trem = removal
    jm = jmasks.include_neighbor_pcd(jstate, jrem)
    tm = tmasks.include_neighbor_pcd(tstate, trem)
    for f in ("removed", "editable", "trainable"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f),
                                      err_msg=f)
    # wider radii, so that the neighbourhoods hold more than the removed
    tw = tmasks.include_neighbor_pcd(tstate, trem, editable_dist=1.0,
                                     trainable_dist=2.0)
    assert tw.removed.sum() < tw.editable.sum() < tw.trainable.sum()
    xyz = np.asarray(jstate.params.xyz)
    ref = xyz[np.asarray(jrem) & np.asarray(jstate.alive)]
    from streetunveiler_tpu.ops.knn import mean_dist_to_reference as jmd
    from streetunveiler_torch.ops.knn import mean_dist_to_reference as tmd
    np.testing.assert_allclose(tmd(xyz, ref), jmd(xyz, ref), rtol=1e-6,
                               atol=1e-6)

    bg = np.zeros(3, np.float32)
    jc = jmasks.removal_mask_for_frame(jscene.train_cameras[1], jstate,
                                       jm.removed, jnp.asarray(bg))
    tc = tmasks.removal_mask_for_frame(tscene.train_cameras[1], tstate,
                                       tm.removed, bg, device="cpu")
    jmask, tmask = np.asarray(jc["mask"]), tc["mask"].numpy()
    assert tmask.dtype == bool and tmask.shape == (48, 64)
    assert tmask.sum() > 0
    assert (tmask != jmask).mean() <= 5e-3
    for k in ("rgb_without", "alpha_without", "alpha_full", "rgb_full"):
        bad = np.abs(np_(tc[k]) - np.asarray(jc[k])) > 5e-5
        assert bad.mean() <= 1e-3, k
    d = torch.zeros(48, 64, dtype=torch.bool)
    d[10, 20] = True
    np.testing.assert_array_equal(
        tmasks.dilate(d, 2).numpy(),
        np.asarray(jmasks.dilate(jnp.asarray(d.numpy()), 2)))


def test_write_inpaint_conditions(scenes, removal, tmp_path):
    _, _, tscene, tstate = scenes
    _, _, _, trem = removal
    sky = [np.full((48, 64, 3), 0.5, np.float32)] * 4
    out = tmasks.write_inpaint_conditions(tscene, tstate, trem,
                                          str(tmp_path), np.zeros(3),
                                          sky_images=sky, frames=[0, 2],
                                          device="cpu")
    assert sorted(out) == [0, 2]
    for sub in ("mask_inpaint", "inpainted_rgb", "inpainted_depth",
                "inpainted_normal", "original_rgb", "empty_opacity"):
        names = sorted(os.listdir(tmp_path / sub))
        assert [n for n in names if n.endswith(".png")] == \
            ["00000.png", "00002.png"], sub
    np.testing.assert_array_equal(
        np.load(tmp_path / "mask_inpaint" / "00002.npy"), out[2])
    np.testing.assert_array_equal(np.load(tmp_path /
                                          "valid_inpaint_frame.npy"), [0, 2])


def test_apply_deltas_matches_jax(scenes):
    _, jstate, _, tstate = scenes
    rng = np.random.default_rng(1)
    mask = rng.random(jstate.capacity) < 0.5
    d = {k: rng.normal(size=getattr(jstate.params, k).shape
                       ).astype(np.float32) for k in PARAMS}
    for cfg in (dict(), dict(xyz=False, opacity=False)):
        jeff = jdeltas.apply_deltas(
            jstate, dataclasses.replace(jdeltas.zero_deltas(jstate.params),
                                        **{k: jnp.asarray(v)
                                           for k, v in d.items()}),
            jnp.asarray(mask), jdeltas.DeltaConfig(**cfg))
        teff = tdeltas.apply_deltas(
            tstate, SurfelParams(**{k: torch.as_tensor(v)
                                    for k, v in d.items()}),
            torch.as_tensor(mask), tdeltas.DeltaConfig(**cfg))
        for k in PARAMS:
            got, want = np_(getattr(teff.params, k)), np.asarray(
                getattr(jeff.params, k))
            np.testing.assert_array_equal(got, want, err_msg=k)
            base = np_(getattr(tstate.params, k))
            np.testing.assert_array_equal(got[~mask], base[~mask])
    z = tdeltas.zero_deltas(tstate.params)
    assert all(float(getattr(z, k).abs().sum()) == 0 for k in PARAMS)


def test_diffuse_fill_and_adapters_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.random((48, 64, 3)).astype(np.float32)
    m = np.zeros((48, 64), bool)
    m[10:30, 0:20] = True
    m[40:, 50:] = True
    ref = rng.random((48, 64, 3)).astype(np.float32)
    for r in (None, ref):
        np.testing.assert_array_equal(
            tinpaint.DiffuseFillInpainter(iterations=50, device="cpu"
                                          ).inpaint(img, m, r),
            jinpaint.DiffuseFillInpainter(iterations=50).inpaint(img, m, r))
    empty = np.zeros_like(m)
    np.testing.assert_array_equal(
        tinpaint.DiffuseFillInpainter(device="cpu").inpaint(img, empty), img)
    fn = lambda i, mk, rf: torch.as_tensor(i * 2.0)
    np.testing.assert_array_equal(
        tinpaint.TorchScriptInpainter(fn).inpaint(img, m),
        jinpaint.TorchScriptInpainter(lambda i, mk, rf: i * 2.0).inpaint(
            img, m))
    # no worker attached: the fallback answers after the timeout
    d = tinpaint.DirectoryInpainter(str(tmp_path / "x"), poll_interval=0.01,
                                    timeout=0.05,
                                    fallback=tinpaint.DiffuseFillInpainter(
                                        iterations=10, device="cpu"))
    out = d.inpaint(img, m, reference=ref)
    np.testing.assert_array_equal(
        out, jinpaint.DiffuseFillInpainter(iterations=10).inpaint(img, m,
                                                                  ref))
    req = sorted(os.listdir(tmp_path / "x" / "requests"))
    assert req == ["000000.json", "000000_image.png", "000000_mask.png",
                   "000000_reference.png"]
    with pytest.raises(TimeoutError):
        tinpaint.DirectoryInpainter(str(tmp_path / "y"), poll_interval=0.01,
                                    timeout=0.02).inpaint(img, m)


def test_reoptimize_steps_match_jax(scenes, removal):
    """The re-optimization loss and its delta gradients from zero deltas,
    then three ``reoptimize_step``s on frames 0, 1, 2, in both packages.
    The train mask: the alive surfels within 3.0 of the removed cloud
    (the reference's radii select no neighbour at this scene's scale)."""
    jscene, jstate, tscene, tstate = scenes
    _, _, jrem, trem = removal
    xyz = np.asarray(jstate.params.xyz)
    alive = np.asarray(jstate.alive)
    ref = xyz[jrem & alive]
    near = np.linalg.norm(xyz[:, None] - ref[None], axis=-1).min(1) < 3.0
    train = near & alive & ~jrem
    assert 0 < train.sum() < alive.sum() - jrem.sum()
    jbase = jprune_mask(jstate, jnp.asarray(jrem))
    tbase = tprune_mask(tstate, torch.as_tensor(trem))
    bg = np.zeros(3, np.float32)
    rng = np.random.default_rng(2)
    targets = []
    for f in range(3):
        t = np.array(tscene.train_images[f], np.float32)
        t[10:30, 20:44] = rng.random(3)
        targets.append(t)
    jopt, opt = JReOpt(), ReOptimizationParams()

    def jloss(d, f):
        st = jdeltas.apply_deltas(jbase, d, jnp.asarray(train))
        res = jrender(jscene.train_cameras[f], st, jnp.asarray(bg))
        loss = jl1(res.render, jnp.asarray(targets[f]))
        loss = loss + jopt.lambda_dist * jnp.mean(res.rend_dist)
        n_err = 1.0 - jnp.sum(res.rend_normal * res.surf_normal, -1)
        return loss + jopt.lambda_normal * jnp.mean(n_err)
    jd0 = jdeltas.zero_deltas(jbase.params)
    jl0, jg = jax.value_and_grad(jloss)(jd0, 0)
    leaves = {k: torch.zeros_like(getattr(tbase.params, k),
                                  requires_grad=True) for k in PARAMS}
    tl0, _ = treopt.reoptimize_loss(tbase, SurfelParams(**leaves),
                                    torch.as_tensor(train),
                                    tscene.train_cameras[0],
                                    torch.as_tensor(targets[0]),
                                    torch.as_tensor(bg), opt)
    tg = torch.autograd.grad(tl0, [leaves[k] for k in PARAMS])
    np.testing.assert_allclose(float(tl0.detach()), float(jl0), rtol=1e-4)
    for k, g in zip(PARAMS, tg):
        want = np.asarray(getattr(jg, k))
        np.testing.assert_allclose(np_(g), want,
                                   atol=2e-4 * np.abs(want).max() + 1e-12,
                                   rtol=1e-3, err_msg=k)
        assert not np_(g)[~train].any(), k

    jd, jst = jd0, jreopt.adam_init(jd0)
    td = tdeltas.zero_deltas(tbase.params)
    tst = adam_init(td)
    for it in range(1, 4):
        f = it - 1
        jd, jst, jl = jreopt.reoptimize_step(
            jbase, jd, jst, jnp.asarray(train), jscene.train_cameras[f],
            jnp.asarray(targets[f]), jnp.asarray(bg), jnp.asarray(it), jopt)
        td, tst, tl = treopt.reoptimize_step(
            tbase, td, tst, torch.as_tensor(train), tscene.train_cameras[f],
            torch.as_tensor(targets[f]), torch.as_tensor(bg), it, opt)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    lrs = make_lrs(opt, 3, float(tbase.spatial_scale))
    for k in PARAMS:
        got, want = np_(getattr(td, k)), np.asarray(getattr(jd, k))
        g = np.abs(np.asarray(getattr(jg, k)))
        big = g > 1e-3 * g.max()
        lr = float(getattr(lrs, k))
        np.testing.assert_allclose(got[big], want[big], rtol=0,
                                   atol=1e-6 + 0.06 * lr, err_msg=k)
        assert np.abs(got - want).max() <= 6 * lr + 1e-6, k
        assert not got[~train].any() and not want[~train].any(), k
        assert got[train].any(), k


def test_unveil_matches_jax_structure(scenes, removal):
    """``unveil`` end to end (the JAX tests' scenario): the removed
    surfels gone, the key pairs' frames inpainted, the frame order of the
    seed's permutations, finite renders."""
    _, _, tscene, tstate = scenes
    _, _, _, trem = removal
    masks = tmasks.include_neighbor_pcd(tstate, trem, editable_dist=1.0,
                                        trainable_dist=2.0)
    seen = []
    final, deltas, targets = treopt.unveil(
        tscene, tstate, masks, key_frames=[0, 1, 3],
        inpainter=tinpaint.DiffuseFillInpainter(iterations=40,
                                                device="cpu"),
        opt=ReOptimizationParams(iterations=3),
        callback=lambda f, loss, t: seen.append((f, loss)), device="cpu")
    assert int(final.num_alive) == int(tstate.num_alive) - int(trem.sum())
    assert set(targets) == {0, 1, 2}
    assert [f for f, _ in seen] == [1, 0]
    assert all(np.isfinite(loss) for _, loss in seen)
    train = masks.trainable & ~masks.removed
    assert not np_(deltas.xyz)[~train].any() and np_(deltas.xyz)[train].any()
    np.testing.assert_array_equal(np_(final.params.xyz)[~train],
                                  np_(tstate.params.xyz)[~train])


def _class_count(state, name):
    bit = 1 << CONCERNED_IND[name]
    return int((state.semantic_mask(bit) & state.alive).sum())


def test_unveil_cli_rounds_chain(tmp_path, monkeypatch):
    """``tests/test_round_chaining.py``'s scenario through the port's
    CLIs: round 1 removes vehicles, round 2 buildings from round 1's
    unveiled state, the render CLI follows the newest round, a
    checkpoint-less workspace is skipped; round 1's removal mask is the
    JAX package's on the same state; ``zits:`` without the external
    checkout raises."""
    from streetunveiler_torch.cli import common as cli_common
    from streetunveiler_torch.cli import render as cli_render
    from streetunveiler_torch.cli import unveil as cli_unveil
    from streetunveiler_torch.train.checkpoint import \
        latest_unveiled_checkpoint
    from streetunveiler_torch.utils.ply import state_from_ply
    mp = str(tmp_path / "model")
    info = make_synthetic_street(**SIZES, device="cpu")
    scene = Scene(info, model_path=mp, device="cpu")
    state = scene.create_state(capacity=1024)
    scene.save(state, 30)
    jsave_config(mp, model=JModelParams(model_path=mp, scene="synthetic"))
    n_veh, n_bld = _class_count(state, "vehicle"), _class_count(state,
                                                                "building")
    assert n_veh > 0 and n_bld > 0
    monkeypatch.setattr(cli_common, "load_scene_info",
                        lambda model, seed=0, device="cpu": info)
    base = ["--model_path", mp, "--all", "--cluster_threshold", "1.5",
            "--min_cluster_size", "10", "--key_stride", "2",
            "--reopt_iterations", "5", "--device", "cpu"]

    s1 = cli_unveil.main(base + ["--semantic_class", "vehicle"])
    ply1 = os.path.join(mp, "instance_workspace_1", "checkpoint",
                        "point_cloud.ply")
    st1 = state_from_ply(ply1, spatial_scale=scene.cameras_extent,
                         device="cpu")
    assert _class_count(st1, "vehicle") < n_veh
    assert _class_count(st1, "building") == n_bld
    assert s1["round"] == 1 and sum(s1["mask_pixels"].values()) > 0
    assert np.isfinite(s1["losses"]).all()
    from streetunveiler_tpu.utils.ply import state_from_ply as jfrom_ply
    js = jfrom_ply(os.path.join(mp, "point_cloud", "iteration_30",
                                "point_cloud.ply"),
                   spatial_scale=scene.cameras_extent)
    jcl = jselect.cluster_semantic_instance(js, VEHICLE_BIT, 1.5)
    jrem = jselect.removal_mask_for_instances(jcl, [], all_solid=True,
                                              min_size=10)
    ws1 = os.path.join(mp, "instance_workspace_1")
    np.testing.assert_array_equal(
        np.load(os.path.join(ws1, "removed_pcd_mask.npy")), jrem)
    assert sorted(os.listdir(os.path.join(ws1, "final_renders"))) == \
        [f"{i:05d}.png" for i in range(4)]

    cli_unveil.main(base + ["--semantic_class", "building"])
    ply2 = os.path.join(mp, "instance_workspace_2", "checkpoint",
                        "point_cloud.ply")
    st2 = state_from_ply(ply2, spatial_scale=scene.cameras_extent,
                         device="cpu")
    assert _class_count(st2, "vehicle") == _class_count(st1, "vehicle")
    assert _class_count(st2, "building") < n_bld
    assert latest_unveiled_checkpoint(mp) == ply2
    os.makedirs(os.path.join(mp, "instance_workspace_7"))
    assert latest_unveiled_checkpoint(mp) == ply2
    r = cli_render.main(["--model_path", mp, "--skip_mesh", "--device",
                         "cpu"])
    assert r["unveiled"] == ply2 and np.isfinite(r["train_psnr"])
    with pytest.raises(RuntimeError, match="ZITS-PlusPlus repo not found"):
        cli_unveil.main(base + ["--inpainter", "zits:/x:/y"])


def test_unveil_cli_neighbourhood_radii(tmp_path, monkeypatch):
    """The unveil CLI's neighbourhoods: at its default radii the saved
    masks are the JAX package's ``include_neighbor_pcd`` on the same
    state (at this scale no surfel but the removed ones, so nothing
    trains, as in the JAX CLI); with ``--trainable_dist 2
    --editable_dist 1`` they are the port's function at those radii,
    surfels beside the removed ones train, and some of their deltas
    move."""
    from streetunveiler_torch.cli import common as cli_common
    from streetunveiler_torch.cli import unveil as cli_unveil
    from streetunveiler_tpu.utils.ply import state_from_ply as jfrom_ply
    from streetunveiler_torch.utils.ply import state_from_ply
    info = make_synthetic_street(**SIZES, device="cpu")
    monkeypatch.setattr(cli_common, "load_scene_info",
                        lambda model, seed=0, device="cpu": info)

    def run(name, flags):
        mp = str(tmp_path / name)
        scene = Scene(info, model_path=mp, device="cpu")
        scene.save(scene.create_state(capacity=1024), 30)
        jsave_config(mp, model=JModelParams(model_path=mp,
                                            scene="synthetic"))
        s = cli_unveil.main([
            "--model_path", mp, "--all", "--cluster_threshold", "1.5",
            "--min_cluster_size", "10", "--key_stride", "2",
            "--reopt_iterations", "3", "--semantic_class", "vehicle",
            "--device", "cpu"] + flags)
        ws = os.path.join(mp, "instance_workspace_1")
        saved = {f: np.load(os.path.join(ws, f"{f}_pcd_mask.npy"))
                 for f in ("removed", "trainable", "editable")}
        ply = os.path.join(mp, "point_cloud", "iteration_30",
                           "point_cloud.ply")
        return s, saved, ply, scene.cameras_extent

    s1, m1, ply, extent = run("default", [])
    jm = jmasks.include_neighbor_pcd(
        jfrom_ply(ply, spatial_scale=extent), m1["removed"])
    for f in ("trainable", "editable"):
        np.testing.assert_array_equal(m1[f], getattr(jm, f), err_msg=f)
    assert s1["removed"] > 0 and s1["trained"] == 0 and s1["moved"] == 0

    s2, m2, ply, extent = run("radii", ["--trainable_dist", "2",
                                        "--editable_dist", "1"])
    tm = tmasks.include_neighbor_pcd(
        state_from_ply(ply, spatial_scale=extent, device="cpu"),
        m2["removed"], editable_dist=1.0, trainable_dist=2.0)
    for f in ("trainable", "editable"):
        np.testing.assert_array_equal(m2[f], getattr(tm, f), err_msg=f)
    np.testing.assert_array_equal(m2["removed"], m1["removed"])
    assert s2["trained"] == int((tm.trainable & ~tm.removed).sum()) > 0
    assert 0 < s2["moved"] <= s2["trained"]
