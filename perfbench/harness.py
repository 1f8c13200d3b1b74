"""The benchmark's driver: finds a cell by its name, runs it and prints its
result.

Everything that belongs to one cell, configuration or per-layer metric is
a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``perfbench/workloads/<cell>.json``: the cell's configuration, its entry
  driver, its traffic parameters and the limits of its comparison;
* ``perfbench/configs/<config>.json``: the configuration's sizes, its
  source and what was cut;
* ``perfbench/entries/<entry>.py``: a ``Cell`` class that makes the inputs,
  sets the program up, runs the measured window and compares what the
  window produced with the plain reference (``perfbench/reference/``);
* ``perfbench/metrics/<metric>.py``: a ``read(reading)`` function that
  takes one per-layer metric from a traced window, or returns None when
  the cell gives it nothing to read. Where no file has the metric's whole
  name, the reader of its stem (the name up to its first dot) serves it:
  ``idle_share.py`` reads ``idle_share.train`` and ``idle_share.render``.

A cell's ``Cell`` offers ``setup(seed)``, ``window(seconds, tracer)``,
``end_to_end(stats)``, ``reading(stats, tracer, untraced)``, ``release()``
and ``check()``; ``run_cell`` calls them in that order. A traced run
measures two windows of ``--seconds``: an untraced one, whose time per
step or frame the ``mfu`` readers divide by (the profiler slows a step on
the host), then the traced one that the other readers read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

_T_IMPORT = time.perf_counter()

# the top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "streetunveiler_tpu")
# build and kernel caches, inside the checkout at fixed paths
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}
CACHE_ROOT = ".bench_cache"


@dataclasses.dataclass
class Check:
    """One number that decides ``correct``, with its limit (the number
    passes at or below it)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Spec:
    """A cell as the harness hands it to its entry driver."""
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def process_age_s() -> float:
    """Seconds since this process started (``/proc``); the time since this
    module was imported where ``/proc`` has no answer."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def start_time() -> float:
    """The process's start on the ``time.perf_counter`` clock."""
    return time.perf_counter() - process_age_s()


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_spec(root: str, name: str, bench: dict | None = None) -> Spec:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its workload and
    configuration files."""
    bench = bench or read_json(os.path.join(root, "BENCHMARK.json"))
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    w = entries[0]
    traffic = read_json(os.path.join(root, "perfbench", "workloads",
                                     f"{name}.json"))
    config = read_json(os.path.join(root, "perfbench", "configs",
                                    f"{w['config']}.json"))
    return Spec(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic=traffic,
                limits=traffic.get("limits", {}),
                end_to_end=[m for m in bench["end_to_end"]
                            if applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if applies(m, name)])


def _load_file(path: str, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_entry(root: str, name: str):
    return _load_file(os.path.join(root, "perfbench", "entries",
                                   f"{name}.py"),
                      f"perfbench_entry_{name}")


def load_reader(root: str, metric: str):
    """The reader module of a per-layer metric: the file of the metric's
    name, or else that of its stem."""
    name = metric
    if not os.path.exists(os.path.join(root, "perfbench", "metrics",
                                       f"{name}.py")):
        name = metric.split(".")[0]
    return _load_file(os.path.join(root, "perfbench", "metrics",
                                   f"{name}.py"),
                      "perfbench_metric_" + name.replace(".", "_")
                      .replace("-", "_"))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one no run may hold."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def prepare_process(root: str) -> None:
    """Before torch is imported: point the build and kernel caches at fixed
    directories inside the checkout (the program's own library builds into
    its ``_build``), and keep the host side to one compute thread, so that
    idle OpenMP workers spinning on a shared host do not take the launching
    thread's core."""
    for var, sub in CACHE_DIRS.items():
        path = os.path.join(root, CACHE_ROOT, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def power_limit() -> str:
    """The card's power limit as nvidia-smi reads it ('' when it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def run_cell(root: str, spec: Spec, seed: int, seconds: float, trace: bool,
             device, t_start: float | None = None) -> dict:
    """One run of ``spec``: set-up, window, per-layer readings (traced
    runs), the comparison. Returns the result as a dict, ``compared``
    last."""
    import torch

    from .trace import Tracer
    t_start = start_time() if t_start is None else t_start
    entry = load_entry(root, spec.traffic["entry"])
    cell = entry.Cell(spec, device)
    cell.setup(seed)
    untraced = None
    if trace:
        untraced = cell.window(seconds, Tracer(enabled=False, device=device))
    tracer = Tracer(enabled=trace, device=device)
    stats = cell.window(seconds, tracer)
    # set-up is the program's: the seconds the benchmark's reference spent
    # making inputs (the training targets) are not in it
    t_window_start = (untraced or stats)["t_window_start"]
    setup_s = t_window_start - t_start - cell.reference_s
    t_closed = time.perf_counter()
    values = dict(cell.end_to_end(stats), setup_s=setup_s)
    units = {m["name"]: m["unit"] for m in spec.end_to_end + spec.per_layer}
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": spec.chips,
           "memory_peak_bytes": int(max(
               w.get("memory_peak_bytes", 0)
               for w in (stats, untraced or {})))}
    if on_card:
        dev["power_limit"] = power_limit()
    result = {"correct": False, "attempted": int(stats["attempted"]),
              "failed": int(stats["failed"])}
    breakdown = None
    if trace:
        reading = cell.reading(stats, tracer, untraced)
        metrics = {}
        for m in spec.per_layer:
            value = load_reader(root, m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        dev["busy_s"] = tracer.busy_s
        dev["window_s"] = tracer.window_s
        breakdown = tracer.breakdown()
        rate = cell.end_to_end(stats)
        print("trace: the profiler's cost: " + ", ".join(
            f"{k} {v!r} traced against {cell.end_to_end(untraced)[k]!r}"
            for k, v in rate.items()), file=sys.stderr)
        print(f"trace: {len(tracer.device_ops)} device operations, "
              f"{sum(op[3] is None for op in tracer.device_ops)} without "
              f"a launch, {len(tracer.host_ops)} host operations, spans "
              f"{ {k: len(v) for k, v in tracer.spans.items()} }, reduced "
              f"in {tracer.reduce_s:.1f} s", file=sys.stderr, flush=True)
    else:
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": units[m["name"]]}
                   for m in spec.end_to_end if m["name"] in values}
    t_read = time.perf_counter()
    cell.release()
    checks = cell.check()
    print(f"phases: set-up {setup_s:.1f} s (and the reference's inputs "
          f"{cell.reference_s:.1f} s), window {stats['seconds']:.1f} "
          f"s, reading {t_read - t_closed:.1f} s, check "
          f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr)
    result["correct"] = bool(checks) and all(c.ok for c in checks) \
        and result["failed"] == 0
    result["metrics"] = metrics
    result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {c.name: {"value": c.value, "limit": c.limit}
                          for c in checks}
    return result


def main(args) -> int:
    t_start = start_time()
    root = os.getcwd()
    try:
        bench = read_json(os.path.join(root, "BENCHMARK.json"))
        spec = load_spec(root, args.workload, bench)
    except (OSError, KeyError, ValueError) as exc:
        print(f"perfbench: cannot load cell {args.workload!r}: {exc}",
              file=sys.stderr)
        return 2
    prepare_process(root)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < spec.chips:
        print(f"perfbench: cell {spec.name} needs {spec.chips} CUDA "
              f"card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = run_cell(root, spec, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_start)
    found = forbidden_modules()
    if found:
        print("perfbench: the run loaded modules it must not: "
              + ", ".join(found), file=sys.stderr)
        return 4
    emit(result)
    return 0


def emit(result: dict) -> None:
    """The run's closing lines: each compared number beside its limit on
    standard error, then the result as the last line of standard
    output."""
    print(f"correct {result['correct']} attempted {result['attempted']} "
          f"failed {result['failed']}", file=sys.stderr)
    for name, c in result["compared"].items():
        ok = c["value"] == c["value"] and c["value"] <= c["limit"]
        print(f"compared {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
