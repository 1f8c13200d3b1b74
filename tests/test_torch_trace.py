"""The port's spans and counters (``streetunveiler_torch/trace.py``) on the
CPU: nothing happens without a profiler; under ``torch.profiler`` a late
step opens each of its ranges once (``raster.finalize`` twice), nested as
the module's docstring draws them, the backward ranges hold what they
name and leave no hook behind, the counters read the binning's own
numbers and restart with each profiler session, and tracing leaves every
result's bits as they were.
"""

from __future__ import annotations

import dataclasses
import gc
import types
import weakref

import pytest
import torch
from torch.profiler import profile

from streetunveiler_torch import trace
from streetunveiler_torch.config import OptimizationParams
from streetunveiler_torch.models.sky import init_sky, render_sky
from streetunveiler_torch.tools import street
from streetunveiler_torch.train.optim import adam_init
from streetunveiler_torch.train.step import bin_step, init_optimizer, \
    train_step

torch.set_num_threads(1)

M = street.MINI
OPT = OptimizationParams()
LATE_IT = max(OPT.semantic_dist_from_iter, OPT.normal_consist_from_iter,
              OPT.shrinking_from_iter) + 1

# parent → children of one bin_step + train_step
STEP_TREE = {
    "train.bin": ("bin.preprocess", "bin.cull", "bin.depth_sort",
                  "bin.expand", "bin.tile_sort"),
    "train.forward": ("raster.sh", "raster.preprocess", "raster.gather",
                      "raster.blend_fwd", "raster.finalize", "sky.forward",
                      "loss"),
    "train.backward": ("raster.blend_bwd", "raster.record_scatter",
                       "sky.backward"),
    "train.update": (),
}
VIEW_TREE = {"view": ("view.render", "view.sky", "view.normals",
                      "view.semantic")}


def scene_inputs(seed=0):
    """A fresh late-phase setup on the CPU: the street miniature's state
    and camera, targets, labels and the sky with fresh moments."""
    st = street.street_state(n=M["n"], seed=seed, device="cpu",
                             scale=M["scale"])
    cam = street.street_camera(device="cpu", width=M["width"],
                               height=M["height"], focal=M["focal"])
    g = torch.Generator().manual_seed(seed)
    gt = torch.rand(M["height"], M["width"], 3, generator=g)
    sem = torch.randint(0, 6, (M["height"], M["width"]), generator=g)
    sky = init_sky(torch.Generator().manual_seed(seed), device="cpu")
    return st, cam, gt, sem, sky


def late_step(st, cam, gt, sem, sky):
    b = bin_step(st, cam, device="cpu")
    out = train_step(st, init_optimizer(st), cam, gt, torch.zeros(3),
                     LATE_IT, OPT, sky_params=sky,
                     sky_opt_state=adam_init(sky), gt_semantic=sem,
                     class_dist=True, binning=b, device="cpu")
    return b, out


def collect(prof):
    """(spans by name → [(start, end)], host ops [(name, start, end)])."""
    spans, ops = {}, []
    for e in prof.profiler.kineto_results.events():
        iv = (e.start_ns(), e.start_ns() + e.duration_ns())
        if e.is_user_annotation():
            spans.setdefault(e.name(), []).append(iv)
        else:
            ops.append((e.name(), *iv))
    return spans, ops


def inside(child, parent):
    return parent[0] <= child[0] and child[1] <= parent[1]


@pytest.fixture(scope="module")
def traced_step():
    trace.reset_counters()
    inputs = scene_inputs()
    with profile() as prof:
        b, out = late_step(*inputs)
    spans, ops = collect(prof)
    return dict(binning=b, out=out, spans=spans, ops=ops,
                counters=trace.counters())


def test_nothing_happens_without_a_profiler():
    assert not trace.enabled()
    assert trace.span("train.forward") is trace.span("view")
    trace.reset_counters()
    trace.count("raster.slots", 1)
    trace.count("raster.duplicates", torch.tensor(5))
    assert trace.counters() == {}
    packT = torch.randn(4, 6, requires_grad=True) * 2.0
    rec = packT.index_select(1, torch.tensor([0, 2, 2, 5]))
    trace.backward_span("raster.record_scatter", rec)
    leaves, tensors = sky_leaves()
    img = sky_image(leaves)
    # were a hook there, the backward under a profiler would open a range
    with profile() as prof:
        (rec.sum() + img.sum()).backward()
    assert not {"raster.record_scatter", "sky.backward"} & set(
        collect(prof)[0])


def sky_leaves():
    sky = init_sky(torch.Generator().manual_seed(0), device="cpu")
    leaves = sky.map(lambda t: t.detach().requires_grad_(True))
    return leaves, list(leaves.named_tensors().values())


def sky_image(leaves):
    cam = street.street_camera(device="cpu", width=8, height=8, focal=8.0)
    return render_sky(leaves, 8, 8, cam.K, torch.linalg.inv(cam.w2c))


def marker():
    """A range after the backward: no range may still be open there."""
    with trace.span("marker"):
        pass


def test_sky_backward_that_leaves_out_a_leaf_closes_its_range():
    leaves, tensors = sky_leaves()
    with profile() as prof:
        img = sky_image(leaves)
        # the hash tables left out: their branch of the graph never runs
        torch.autograd.grad(img.sum(), tensors[1:])
        marker()
        img = sky_image(leaves)
        torch.autograd.grad(img.sum(), tensors)
        marker()
    assert not any(t._backward_hooks for t in tensors)
    spans, ops = collect(prof)
    marks = [s for s, _ in spans["marker"]]
    assert len(spans["sky.backward"]) == len(marks) == 2
    for iv, mark in zip(spans["sky.backward"], marks):
        assert iv[1] <= mark
        assert any("MmBackward0" in n and inside((s, e), iv)
                   for n, s, e in ops)
    held = [{n for n, s, e in ops if inside((s, e), iv)}
            for iv in spans["sky.backward"]]
    assert not any("Embedding" in n or "Index" in n for n in held[0] - held[1])


class _Raise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("backward raised")


@pytest.mark.parametrize("graph", [False, True])
def test_a_graph_leaves_nothing_behind(graph):
    """Freed without a backward, or after a backward that raised, a graph
    takes its hooks with it, and the range the raise left open ends."""
    x = torch.randn(5, requires_grad=True)
    with profile() as prof:
        for fail in (False, True):
            m = x * 2.0
            gone = weakref.ref(m)
            y = (_Raise.apply(m) if fail else m).sin()
            trace.backward_span("probe", y, graph=graph)
            del m
            if fail:
                with pytest.raises(RuntimeError, match="backward raised"):
                    y.sum().backward()
            del y
            gc.collect()
            assert gone() is None, fail
        marker()
    spans = collect(prof)[0]
    # only the failed backward reached the range's node
    assert len(spans["probe"]) == 1
    assert spans["probe"][0][1] <= spans["marker"][0][0]


def test_counters_restart_with_each_profiler_session():
    trace.reset_counters()
    with profile():
        trace.count("raster.slots", 7)
    assert trace.counters() == {"raster.slots": 7}
    with profile():
        trace.count("raster.slots", 5)
        trace.count("raster.slots", torch.tensor(3))
    assert trace.counters() == {"raster.slots": 8}
    assert trace.counters() == {"raster.slots": 8}


def test_a_late_step_opens_each_span_once_nested(traced_step):
    spans = traced_step["spans"]
    for parent, children in STEP_TREE.items():
        for name in (parent, *children):
            # raster.finalize: the assembly's range and finalize_render's
            want = 2 if name == "raster.finalize" else 1
            assert len(spans.get(name, [])) == want, (name, spans.get(name))
        for child in children:
            assert all(inside(iv, spans[parent][0]) for iv in spans[child]), \
                (child, parent)
    order = [spans[p][0] for p in STEP_TREE]
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))


def test_backward_spans_hold_what_they_name(traced_step):
    spans, ops = traced_step["spans"], traced_step["ops"]

    def held(name):
        iv = spans[name][0]
        return {n for n, s, e in ops if inside((s, e), iv)}

    assert "aten::index_add_" in held("raster.record_scatter")
    sky = held("sky.backward")
    assert "aten::index_add_" not in sky
    assert not any("Blend" in n or "IndexSelect" in n for n in sky), sky
    assert "autograd::engine::evaluate_function: MmBackward0" in sky
    for other in ("raster.blend_bwd", "raster.record_scatter"):
        a, b = spans[other][0], spans["sky.backward"][0]
        assert a[1] <= b[0] or b[1] <= a[0], other


def test_counters_read_the_binning(traced_step):
    b = traced_step["binning"]
    cap = b.sorted_surfel.shape[0]
    assert traced_step["counters"] == {
        "raster.slots": cap, "raster.duplicates": min(int(b.demand), cap)}


def test_counters_on_an_overflowing_stream():
    from streetunveiler_torch.ops.rasterizer.api import \
        default_duplicate_capacity
    from streetunveiler_torch.renderer import render
    st, cam, *_ = scene_inputs()
    full = default_duplicate_capacity(M["n"], M["width"], M["height"])
    trace.reset_counters()
    with torch.no_grad(), profile():
        for cap in (None, 1024):
            res = render(cam, st, torch.zeros(3), duplicate_capacity=cap,
                         device="cpu")
    demand = int(res.demand)
    assert 1024 < demand <= full and bool(res.overflow)
    assert trace.counters() == {
        "raster.slots": full + 1024, "raster.duplicates": demand + 1024}
    trace.reset_counters()
    assert trace.counters() == {}


def test_tracing_leaves_the_bits(traced_step):
    b, out = late_step(*scene_inputs())
    want = traced_step["out"]
    assert torch.equal(b.sorted_surfel, traced_step["binning"].sorted_surfel)

    def tensors(x):
        if torch.is_tensor(x):
            return [x]
        if isinstance(x, dict):
            return [t for k in sorted(x) for t in tensors(x[k])]
        if isinstance(x, (tuple, list)):
            return [t for v in x for t in tensors(v)]
        if dataclasses.is_dataclass(x):
            return [t for f in dataclasses.fields(x)
                    for t in tensors(getattr(x, f.name))]
        return []

    got_t, want_t = tensors(out), tensors(want)
    assert len(got_t) == len(want_t) > 20
    for g, w in zip(got_t, want_t):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_train_scene_opens_start_and_iteration():
    st, cam, gt, sem, sky = scene_inputs()
    scene = types.SimpleNamespace(
        train_cameras=[cam], train_images=[gt.numpy()],
        train_semantics=[sem.numpy()], test_cameras=[], test_images=[],
        model_path="")
    from streetunveiler_torch.train.loop import train_scene
    with profile() as prof:
        train_scene(scene, st, OPT, sky_params=sky,
                    start_iteration=LATE_IT - 1, iterations=LATE_IT,
                    log_every=10 ** 9, use_semantics=True, device="cpu")
    spans = collect(prof)[0]
    assert len(spans["train.start"]) == len(spans["train.iteration"]) == 1
    start, it = spans["train.start"][0], spans["train.iteration"][0]
    assert start[1] <= it[0]
    # the capacity probe bins in the start-up, the step in the iteration
    assert sorted(sum(inside(s, p) for s in spans["train.bin"])
                  for p in (start, it)) == [1, 1]
    for name in ("train.forward", "train.backward", "train.update"):
        assert len(spans[name]) == 1 and inside(spans[name][0], it)


def test_render_view_opens_view_and_its_stages():
    from streetunveiler_torch.cli.render import render_view
    st, cam, _, _, sky = scene_inputs()
    with profile() as prof:
        render_view(cam, st, torch.zeros(3), sky, None, True, "cpu")
    spans = collect(prof)[0]
    for parent, children in VIEW_TREE.items():
        assert len(spans[parent]) == 1
        for child in children:
            assert len(spans[child]) == 1, child
            assert inside(spans[child][0], spans[parent][0]), child
    # the render and the semantic render each bin and blend once
    assert len(spans["raster.blend_fwd"]) == len(spans["bin.expand"]) == 2
