"""The port's own spans and counters, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` collects (the profiler's
own state, ``torch.autograd.profiler._is_profiler_enabled``): the training
CLI's ``--profile`` (``utils/logging.profile_trace``), a benchmark's traced
window, or any profiler a caller opens. There is no switch of its own.

* ``span(name)``: a ``record_function`` range while tracing, else one
  shared no-op context. A range is a user annotation on Kineto's clock,
  the clock of the CUDA activity, and every device operation launched
  inside it is tied to it by its correlation id.
* ``backward_span(name, output)``: a range over the backward of a graph
  of autograd nodes that are not the port's own code. It opens in a
  pre-hook on ``output``'s node, where the gradient arrives, and closes
  in the post-hook of the last node of ``output``'s graph that the
  backward runs. Hooks are registered only while tracing, on those nodes
  alone, so none outlives its graph.
* ``count(name, value)``: adds a host int or a 0-d device tensor to the
  counter ``name`` while tracing, without reading anything on the host
  (host ints add on the host, tensors into a 0-d int64 accumulator on
  their device). ``counters()`` returns the totals as host ints with one
  sync; ``reset_counters()`` clears them. The counters start again from
  zero in a profiler session that follows a look at the profiler
  (``enabled``, ``count``, ``counters``) that found none collecting, so
  a window's totals hold only its own session.
* ``launch_counts``: the hand-written kernels' launches, bumped by each
  wrapper where it launches its kernel and nowhere else, whether or not
  tracing is on, so a caller can show that a run went through the
  kernels; ``reset_launch_counts()`` zeroes them.

Span names (indentation is nesting; the training loop's, the step's, the
binning's, the rasterizer's, the sky's, the render CLI's view and the
unveil stage's):

    train.start             train_scene's start-up: targets, capacity probe
    train.iteration         one loop iteration: bin, step, schedule, capacity
      train.bin             train/step.bin_step
        bin.preprocess      api.bin_for_camera's preprocess
        bin.cull            the per-surfel table: the conic cull kernel
                            (tiles.cull_rects_cuda) on the card, its plain
                            version tiles.cull_rects_plain on the CPU
        bin.depth_sort      tiles.depth_order + tiles.rank_table
        bin.expand          K3, the duplicate expansion
        bin.tile_sort       tiles.sort_by_tile + csr_offsets + tile_order
      train.forward         train/step.stage1_loss
        raster.sh           renderer.surfel_colors
        raster.preprocess   api.rasterize's preprocess
        raster.gather       the record pack + api._gather_records
        raster.blend_fwd    K1
        raster.finalize     the image assembly + renderer.finalize_render
        sky.forward         models/sky.render_sky
        loss                the losses
      train.backward        torch.autograd.grad
        raster.blend_bwd    K2
        raster.record_scatter  _gather_records' backward: the sort and the
                            scatter kernel (ops/rasterizer/scatter.py)
        sky.backward        the sky's subgraph
      train.update          Adam (surfels, sky), densification statistics
    unveil.step             pipeline/reoptimize.reoptimize_step: one delta step
      unveil.deltas         models/deltas.apply_deltas
      unveil.loss           the stage-C loss after the render
      unveil.deltas_bwd     apply_deltas' backward (hooks, as sky.backward)
      unveil.adam           the deltas' Adam
    unveil.condition        unveil(): a frame's removal mask and the
                            inpaint-input renders
    unveil.inpaint          unveil(): the inpainter
    view                    cli/render.render_view
      view.render           renderer.render (raster.* and bin.* inside)
      view.sky              render_sky + the composite
      view.normals          world-space normals
      view.semantic         renderer.render_semantic

Counters, in ``api.rasterize`` on the stream K1, K2, the gather and the
scatter process: ``raster.slots`` (the stream's capacity) and
``raster.duplicates`` (min(demand, capacity)); the pad slots are
slots − duplicates. In ``pipeline/reoptimize.reoptimize_step``, once a step:
``unveil.trainable`` (the rows the train mask trains) and ``unveil.surfels``
(the base's alive rows), both 0-d device tensors.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()
_counts: dict = {}      # name -> [host total, device accumulator or None]
_seen_on = False        # what the last look at the profiler found

launch_counts = {"blend_fwd": 0, "blend_bwd": 0, "expand": 0,
                 "blend_fwd_gated": 0, "blend_bwd_gated": 0,
                 "record_scatter": 0, "cull": 0,
                 # the measurement tools (streetunveiler_torch/tools/)
                 "bisect_fwd": 0, "bisect_bwd": 0, "micro_reduce": 0,
                 "micro_prefix": 0, "micro_floor_visit": 0,
                 "micro_floor_linear": 0, "identity": 0,
                 "identity_stack": 0, "mmt3": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def enabled() -> bool:
    """Whether a profiler is collecting. The first look that finds one
    after a look that found none clears the counters."""
    global _seen_on
    on = _profiler._is_profiler_enabled
    if on and not _seen_on:
        _counts.clear()
    _seen_on = on
    return on


def span(name: str):
    """A ``record_function`` range named ``name`` while tracing; the
    shared no-op context otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return torch.profiler.record_function(name)


def backward_span(name: str, output) -> None:
    """While tracing, open the range ``name`` when the backward reaches
    ``output``'s node, and close it once every node of ``output``'s graph
    down to its leaves that this backward runs has (a part that leads only
    to leaves the backward leaves out is not waited for). ``output`` may
    be a list of tensors: the range then opens at the first of their nodes
    the backward reaches and closes after the last node of their graphs.
    The hooks sit on those nodes alone and go with the graph; a range a
    backward left open (it raised) ends with them. Nothing when tracing is
    off or no output has a node."""
    outputs = output if isinstance(output, (list, tuple)) else [output]
    roots = list(dict.fromkeys(
        r for r in (getattr(o, "grad_fn", None) for o in outputs)
        if r is not None))
    if not _profiler._is_profiler_enabled or not roots:
        return
    below, seen, stack = [], set(roots), list(roots)
    while stack:
        for node, _ in stack.pop().next_functions:
            # a leaf's AccumulateGrad is not a node of the range
            if node is None or node in seen or hasattr(node, "variable"):
                continue
            seen.add(node)
            below.append(node)
            stack.append(node)
    state = {"range": None, "left": 0}

    def enter(root):
        def hook(grad_outputs):
            if state["range"] is None:
                state["left"] = 1 + sum(map(
                    torch._C._will_engine_execute_node,
                    [r for r in roots if r is not root] + below))
                state["range"] = torch.profiler.record_function(
                    name).__enter__()
        return hook

    def leave(grad_inputs, grad_outputs):
        state["left"] -= 1
        if state["left"] == 0 and state["range"] is not None:
            state["range"].__exit__(None, None, None)
            state["range"] = None

    for root in roots:
        root.register_prehook(enter(root))
    for node in (*roots, *below):
        node.register_hook(leave)


def count(name: str, value) -> None:
    """Add ``value`` (a host int or a 0-d tensor) to the counter ``name``
    while tracing; never waits for the device."""
    if not enabled():
        return
    c = _counts.setdefault(name, [0, None])
    if isinstance(value, torch.Tensor):
        if c[1] is None:
            c[1] = torch.zeros((), dtype=torch.int64, device=value.device)
        c[1].add_(value)
    else:
        c[0] += int(value)


def counters() -> dict:
    """The counters' totals as host ints (one sync)."""
    enabled()
    dev = [c[1] for c in _counts.values() if c[1] is not None]
    vals = iter(torch.stack([t.to(dev[0].device) for t in dev]).tolist()
                if dev else [])
    return {name: c[0] + (next(vals) if c[1] is not None else 0)
            for name, c in _counts.items()}


def reset_counters() -> None:
    _counts.clear()
