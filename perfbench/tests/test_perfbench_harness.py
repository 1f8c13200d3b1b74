"""The harness on the CPU: the last line's keys, the guard on imports, a
cell and a metric added as files alone, and faults planted in the program
that ``correct`` has to catch."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import harness

from .cells import CELLS, ROOT, SEED, mini

CPU = torch.device("cpu")


def run_mini(name, seconds=0.3, trace=False, root=ROOT, spec=None):
    spec = spec or mini(name, root)
    return harness.run_cell(root, spec, SEED, seconds, trace, CPU)


def test_last_line_keys(capsys):
    result = run_mini(CELLS[0])
    harness.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(line["device"])
    assert set(line["metrics"]) == {"train_rays_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    last = err.strip().splitlines()[-len(line["compared"]):]
    assert [s.split()[1] for s in last] == list(line["compared"])
    assert all(" limit " in s for s in last)


def test_no_result_without_a_card(capsys, monkeypatch):
    from perfbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(ROOT)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


GUARD = """
import json, sys, torch
sys.path.insert(0, {root!r})
from perfbench import harness
from perfbench.tests.cells import mini, SEED
for name in {cells!r}:
    harness.run_cell({root!r}, mini(name), SEED, 0.3, True,
                     torch.device("cpu"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_import_guard():
    """Every module a traced run of each cell imports (the traced run
    imports all an untraced one does, and the profiler and the readers): no
    top-level name is jax, jaxlib, flax or streetunveiler_tpu."""
    out = subprocess.run([sys.executable, "-c",
                          GUARD.format(root=ROOT, cells=list(CELLS))],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=900, env=dict(os.environ,
                                               JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "streetunveiler_torch" in top and "perfbench" in top
    assert not top & set(harness.FORBIDDEN), top & set(harness.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(ROOT, "perfbench", "reference")
    for fname in os.listdir(ref_dir):
        if not fname.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref_dir, fname)).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in (
                    "streetunveiler_torch",) + harness.FORBIDDEN, (fname, n)
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, json; import perfbench.reference.model; "
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"streetunveiler_torch", *harness.FORBIDDEN}


def test_a_cell_and_a_metric_are_files(tmp_path):
    """A new cell and a new per-layer metric, each a copied file and an
    entry in BENCHMARK.json, and a metric of a new kind read by an existing
    stem's reader, are found and run with no other file edited."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    wl = os.path.join(root, "perfbench", "workloads")
    shutil.copy(os.path.join(wl, "street-1920x1280.train-late.json"),
                os.path.join(wl, "street-1920x1280.train-copy.json"))
    mt = os.path.join(root, "perfbench", "metrics")
    shutil.copy(os.path.join(mt, "k1_roofline.train.py"),
                os.path.join(mt, "k1_roofline_copy.train.py"))
    bench["workloads"].append({"name": "street-1920x1280.train-copy",
                               "config": "street-1920x1280",
                               "traffic": "train-copy", "chips": 1,
                               "why": "a copy"})
    for name, new in (("k1_roofline.train", "k1_roofline_copy.train"),
                      ("idle_share.train", "idle_share.copy")):
        bench["per_layer"].append(dict(
            next(m for m in bench["per_layer"] if m["name"] == name),
            name=new, workloads=["street-1920x1280.train-copy"]))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    before = {p: open(os.path.join(ROOT, p), "rb").read()
              for p in _files(ROOT)}
    spec = harness.load_spec(root, "street-1920x1280.train-copy")
    assert [m["name"] for m in spec.per_layer] == ["k1_roofline_copy.train",
                                                   "idle_share.copy"]
    assert harness.load_reader(root, "k1_roofline_copy.train").__file__ \
        .endswith("k1_roofline_copy.train.py")
    # a metric with no file of its own is read by its stem's reader
    assert harness.load_reader(root, "idle_share.copy").__file__ \
        .endswith(os.path.join("metrics", "idle_share.py"))
    result = run_mini("street-1920x1280.train-copy", trace=True, root=root,
                      spec=mini("street-1920x1280.train-copy", root))
    assert result["correct"] is True
    # on the CPU no device metric is read
    assert result["metrics"] == {}
    after = {p: open(os.path.join(root, p), "rb").read()
             for p in _files(root)}
    changed = {p for p in after if before.get(p) != after[p]}
    assert changed == {"BENCHMARK.json",
                       "perfbench/workloads/street-1920x1280.train-copy.json",
                       "perfbench/metrics/k1_roofline_copy.train.py"}


def _files(root):
    out = ["BENCHMARK.json"]
    for d, _, fs in os.walk(os.path.join(root, "perfbench")):
        if "__pycache__" in d:
            continue
        out += [os.path.relpath(os.path.join(d, f), root) for f in fs
                if not f.endswith(".pyc")]
    return out


# ------------------------------------------------------- planted faults


def _unchanged_step(monkeypatch):
    """The program's step returns the state it was given."""
    from streetunveiler_torch.train import loop
    orig = loop.train_step

    def step(state, opt_state, camera, gt, bg, it, opt, **kw):
        import copy
        out = orig(copy.deepcopy(state), copy.deepcopy(opt_state), camera,
                   gt, bg, it, opt, **dict(
                       kw, sky_params=copy.deepcopy(kw.get("sky_params")),
                       sky_opt_state=copy.deepcopy(kw.get("sky_opt_state"))))
        return (state, opt_state, kw.get("sky_params"),
                kw.get("sky_opt_state"), out[4])
    monkeypatch.setattr(loop, "train_step", step)


def _half_batch(monkeypatch):
    """The program's photometric losses over the image's upper half."""
    from streetunveiler_torch.train import step
    l1, ssim = step.l1_loss, step.ssim
    half = lambda f: (lambda a, b: f(a[:a.shape[0] // 2],
                                     b[:b.shape[0] // 2]))
    monkeypatch.setattr(step, "l1_loss", half(l1))
    monkeypatch.setattr(step, "ssim", half(ssim))


def _unchanged_late_in_a_call(monkeypatch):
    """From the fourth step of each ``train_scene`` call on, the program's
    step returns the state it was given: the set-up's three steps are
    sound, the window's chunks are not."""
    from streetunveiler_torch.train import loop
    orig_scene, orig_step = loop.train_scene, loop.train_step
    count = [0]

    def scene(*a, **k):
        count[0] = 0
        return orig_scene(*a, **k)

    def step(state, opt_state, camera, gt, bg, it, opt, **kw):
        count[0] += 1
        if count[0] <= 3:
            return orig_step(state, opt_state, camera, gt, bg, it, opt, **kw)
        out = orig_step(*_copies(state, opt_state), camera, gt, bg, it, opt,
                        **dict(kw, sky_params=_copies(kw.get("sky_params")),
                               sky_opt_state=_copies(
                                   kw.get("sky_opt_state"))))
        return (state, opt_state, kw.get("sky_params"),
                kw.get("sky_opt_state"), out[4])
    monkeypatch.setattr(loop, "train_scene", scene)
    monkeypatch.setattr(loop, "train_step", step)


def _copies(*objs):
    import copy
    out = tuple(copy.deepcopy(o) for o in objs)
    return out if len(out) > 1 else out[0]


def _moments_restarted(monkeypatch):
    """Each ``train_scene`` call restarts Adam's step count, as a resume
    that lost the counter would."""
    from streetunveiler_torch.train import loop
    orig = loop.train_scene

    def scene(*a, opt_state=None, sky_opt_state=None, **k):
        restart = lambda s: None if s is None else s._replace(step=0)
        return orig(*a, opt_state=restart(opt_state),
                    sky_opt_state=restart(sky_opt_state), **k)
    monkeypatch.setattr(loop, "train_scene", scene)


def _altered_answer(monkeypatch):
    """The render CLI's view returns its image 1% darker."""
    from streetunveiler_torch.cli import render
    orig = render.render_view

    def view(*a, **k):
        img, depth, nrm, sem = orig(*a, **k)
        return img * 0.99, depth, nrm, sem
    monkeypatch.setattr(render, "render_view", view)


TRAIN = [c for c in CELLS if "train" in c]


@pytest.mark.parametrize("fault,cell", [
    *[(f, c) for f in ("unchanged", "half_batch", "unchanged_late",
                       "moments_restarted") for c in TRAIN],
    ("altered", "street-1920x1280.render-view")])
def test_planted_fault_is_not_correct(monkeypatch, fault, cell):
    {"unchanged": _unchanged_step, "half_batch": _half_batch,
     "unchanged_late": _unchanged_late_in_a_call,
     "moments_restarted": _moments_restarted,
     "altered": _altered_answer}[fault](monkeypatch)
    result = run_mini(cell, seconds=0.0)
    assert result["correct"] is False, result["compared"]
