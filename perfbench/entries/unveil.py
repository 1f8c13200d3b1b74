"""Entry driver of the unveil cells: the delta re-optimization of the
unveil stage (stage C), ``streetunveiler_torch.pipeline.reoptimize
.reoptimize_frames``, in the last pass of ``unveil()``'s walk over the key
frames, on the cell's street with a semantic class removed, closed loop.

Set-up makes the street, its cameras and its sky from the seed, as the
training cells do, and prepares the stage through the program, as the
unveil CLI with ``--all`` does: the class's instances clustered and every
solid one removed (``pipeline/select``), the trainable and editable
neighbourhoods (``pipeline/masks.include_neighbor_pcd``), the base with
the removed rows pruned (``models/gaussians.prune_mask``), the stream's
capacity measured on the whole street (``renderer
.measure_duplicate_capacity``), each frame's removal mask
(``pipeline/masks.removal_mask_for_frame``) and sky image
(``models/sky.render_sky``). The targets are what an ideal inpainter would
give: outside a frame's removal mask the ground truth (the street with its
opacity logits raised by ``gt_opacity_boost``, the reference's sky behind
it), inside it the street without the removed rows under the same boost,
both rendered by the reference; their seconds are the benchmark's, not
the program's set-up. The set-up steps are the pass's first
``setup_steps`` iterations from zero deltas and fresh moments.

The pass is key frame 0's: its candidate set is every frame the walk
inpaints (all but the last, which only bounds the propagation), its
frames drawn from permutations of a generator seeded from ``--seed``. The
window calls ``reoptimize_frames`` in chunks of ``chunk`` iterations,
carrying the deltas, the moments, the frame order and the generator from
chunk to chunk, inside the pass's ``iterations``; a chunk that would pass
the pass's last iteration starts it again from zero deltas and fresh
moments (the same work a step). A step whose stream overflowed its
capacity is failed work.

The reference (``perfbench/reference/unveil.py``) follows two segments
after the window: the set-up steps from zero deltas, and the last
``checked_window_steps`` steps of the window's newest chunk from the
program's deltas and moments just before them (copied on the card inside
the window; nothing waits); its Adam step count is the one the pass's
iteration implies. Of each it compares the first step's loss, the first
gradient, the deltas' change (``perfbench/compare.py``'s rules over the
six delta leaves) and ``frozen_gap``: the largest |delta| and the largest
|effective − base| on any row outside the train mask, after the set-up
steps and after the window (exact: base + 0·delta is the base).

The harness wraps the names ``reoptimize_step`` and ``render`` that
``pipeline/reoptimize`` calls: to record the steps the reference follows
and each render's overflow flag (a device tensor; nothing waits for it).
No program file is edited. A program without ``reoptimize_frames`` cannot
run the cell: set-up raises before it makes anything.
"""

from __future__ import annotations

import sys
import time
import types

import numpy as np
import torch

from perfbench import compare, counts, scenes, states
from perfbench.entries.train import first_gradient
from perfbench.harness import Check
from perfbench.reference import model as ref
from perfbench.reference import raster
from perfbench.reference import unveil as ref_unveil

SAMPLED_STEPS = 3    # steps near the window's end whose pairs mfu counts
# L1's float32 operations an image element: the difference, its absolute
# value and the sum forward; the sign and the scale backward
L1_OPS = 5
CHECKED = ("loss_gap", "grad_gap", "change_gap", "frozen_gap")


class Reading(types.SimpleNamespace):
    """What a traced unveil window offers the per-layer readers."""


def last_pass_frames(n_views: int, stride: int) -> list:
    """The candidate set of ``unveil()``'s last pass (key frame 0) in the
    order the walk adds its frames: the CLI's key frames (every
    ``stride``-th, then the last frame, which only bounds the propagation)
    walked back to front, each key with the frames up to the key after
    it."""
    keys = list(range(0, n_views, stride))
    if keys[-1] != n_views - 1:
        keys.append(n_views - 1)
    out = []
    for frame, nxt in zip(reversed(keys[:-1]), reversed(keys[1:])):
        out += list(range(frame, nxt))
    return out


def _leaves(params) -> dict:
    return {k: getattr(params, k) for k in states.PARAMS}


class Cell:
    def __init__(self, spec, device):
        self.spec = spec
        self.cfg = spec.config
        self.t = spec.traffic
        self.dev = torch.device(device)
        self.w, self.h = int(self.cfg["width"]), int(self.cfg["height"])
        self.reference_s = 0.0

    # ----------------------------------------------------------- set-up

    def setup(self, seed):
        from streetunveiler_torch.pipeline import reoptimize as rp
        if not hasattr(rp, "reoptimize_frames"):
            raise RuntimeError(
                "streetunveiler_torch.pipeline.reoptimize has no "
                "reoptimize_frames: this program cannot run the cell")
        from streetunveiler_torch.config import ReOptimizationParams
        from streetunveiler_torch.device import strict_fp32
        from streetunveiler_torch.models.gaussians import prune_mask
        from streetunveiler_torch.models.sky import render_sky
        from streetunveiler_torch.pipeline import masks as pmasks
        from streetunveiler_torch.pipeline.select import (
            cluster_semantic_instance, removal_mask_for_instances)
        from streetunveiler_torch.renderer import measure_duplicate_capacity
        from streetunveiler_torch.utils.semantics import CONCERNED_IND
        strict_fp32()
        cfg, dev = self.cfg, self.dev
        if cfg["scene"] != "street":
            raise ValueError(f"unknown scene {cfg['scene']!r}")
        self.rp, self.seed = rp, seed
        raw = scenes.street_raw_state(scenes.street_arrays(cfg, seed, dev),
                                      cfg)
        self.cams = scenes.street_cameras(cfg, dev)
        self.pcams = [states.program_camera(w2c, K, self.w, self.h)
                      for w2c, K in self.cams]
        self.candidates = last_pass_frames(len(self.cams),
                                           int(cfg["key_stride"]))
        self.bg = torch.zeros(3, device=dev)
        state = states.program_state(raw, dev)

        # stage A and B's selection, on the host as in the CLI
        cl = cluster_semantic_instance(
            state, 1 << CONCERNED_IND[cfg["removed_class"]], threshold=None)
        removal = removal_mask_for_instances(cl, [], all_solid=True)
        masks = pmasks.include_neighbor_pcd(
            state, removal, editable_dist=float(cfg["editable_dist"]),
            trainable_dist=float(cfg["trainable_dist"]))
        removed = torch.as_tensor(masks.removed, device=dev)
        self.train_mask = torch.as_tensor(masks.trainable,
                                          device=dev) & ~removed
        self.base = prune_mask(state, removed)
        self.cap = measure_duplicate_capacity(self.pcams, state, device=dev)
        self.sky0 = scenes.sky_arrays(seed, dev)
        psky = states.program_sky(self.sky0, dev)
        frame_masks, self.sky_images = {}, {}
        with torch.no_grad():
            for f in self.candidates:
                frame_masks[f] = pmasks.removal_mask_for_frame(
                    self.pcams[f], state, removed, self.bg,
                    duplicate_capacity=self.cap, device=dev)["mask"]
                w2c, K = self.cams[f]
                self.sky_images[f] = render_sky(psky, self.h, self.w, K,
                                                torch.linalg.inv(w2c))
        self.counts = dict(
            removed=int(masks.removed.sum()),
            trainable=int(masks.trainable.sum()),
            train_mask=int(self.train_mask.sum()),
            alive=int(self.base.alive.sum()),
            clusters=[int(s) for s in cl.cluster_sizes[:8]],
            duplicate_capacity=self.cap)
        print(f"unveil set-up: removed {self.counts['removed']} "
              f"({cfg['removed_class']}), trainable "
              f"{self.counts['trainable']} (train mask "
              f"{self.counts['train_mask']}), alive "
              f"{self.counts['alive']}, clusters "
              f"{self.counts['clusters']}, capacity {self.cap}",
              file=sys.stderr)
        del state, psky

        self.targets = self._targets(raw, removed, frame_masks)
        self.view_of = {self.targets[f].data_ptr(): f
                        for f in self.candidates}
        self.rbase = ref_unveil.prune(states.reference_state(raw, dev),
                                      removed)
        del raw
        if dev.type == "cuda":
            # the run's peak is the program's, not that of the reference's
            # target renders
            torch.cuda.reset_peak_memory_stats(dev)

        rcfg = cfg["reoptimization"]
        self.opt = ReOptimizationParams(**rcfg)
        self.ref_opt = ref.StepOptions(**{
            k: v for k, v in rcfg.items()
            if k in ref.StepOptions.__dataclass_fields__})
        lo, hi = self.t["iterations"]
        self.range = (int(lo), int(hi))
        self.rng = np.random.default_rng(seed)
        self._restart()
        n0 = int(self.t["setup_steps"])
        start = self._snapshot(on_host=True)
        seg = Segment(start)
        self.frames = []
        self._chunk(self.range[0] - 1, n0, lambda i: True, seg)
        self.next_it = self.range[0] - 1 + n0
        self.segments = {"setup": seg.on_host()}
        self.frozen = {"setup": self._frozen()}
        self.window_segment = None

    def _targets(self, raw, removed, frame_masks):
        """Each candidate frame's target on the device, by the reference:
        the boosted street outside the frame's removal mask, the boosted
        street without the removed rows inside it, the reference's sky
        behind both, clamped to [0, 1]."""
        t0 = time.perf_counter()
        boost = float(self.cfg["gt_opacity_boost"])
        full = scenes.activated(raw, boost)
        without = scenes.activated(dict(raw, alive=raw["alive"] & ~removed),
                                   boost)
        colors = scenes.sh_colors(raw)
        sky = states.reference_sky(self.sky0, self.dev)
        settings = raster.RasterizeSettings(width=self.w, height=self.h)
        cams = [self.cams[f] for f in self.candidates]
        cap = scenes.stream_capacity(full, cams, self.w, self.h, 1.2)
        out = {}
        with torch.no_grad():
            for f in self.candidates:
                w2c, K = self.cams[f]
                sky_img = ref.render_sky(sky, self.h, self.w, K,
                                         torch.linalg.inv(w2c))
                img = []
                for arrays in (full, without):
                    r = raster.rasterize(arrays["xyz"], arrays["scales"],
                                         arrays["quats"], arrays["opacity"],
                                         colors(w2c), w2c, K, settings,
                                         bg=self.bg, duplicate_capacity=cap)
                    if bool(r.overflow):
                        raise RuntimeError("a target render overflowed")
                    img.append(r.color + sky_img * (1.0 - r.alpha)[..., None])
                out[f] = torch.where(frame_masks[f][..., None], img[1],
                                     img[0]).clamp(0.0, 1.0).contiguous()
        self.reference_s += time.perf_counter() - t0
        return out

    def _restart(self):
        """The pass from its start: zero deltas, fresh moments."""
        from streetunveiler_torch.models.deltas import zero_deltas
        from streetunveiler_torch.train.optim import adam_init
        self.deltas = zero_deltas(self.base.params)
        self.opt_state = adam_init(self.deltas)
        self.order = []

    def _snapshot(self, deltas=None, opt_state=None, on_host=False):
        """Copies of the deltas and their Adam moments: on the card inside
        the window (nothing waits for them), on the host otherwise."""
        put = ((lambda t: t.detach().cpu().clone()) if on_host
               else (lambda t: t.detach().clone()))
        deltas = self.deltas if deltas is None else deltas
        opt_state = self.opt_state if opt_state is None else opt_state
        return dict(deltas={k: put(v) for k, v in _leaves(deltas).items()},
                    mu={k: put(v) for k, v in _leaves(opt_state.mu).items()},
                    nu={k: put(v) for k, v in _leaves(opt_state.nu).items()})

    def _chunk(self, last_done: int, n: int, checked=None, seg=None):
        """``reoptimize_frames`` over iterations last_done+1 ..
        last_done+n, carrying the deltas, moments, frame order and
        generator. The steps ``checked(i)`` names (i counted from 0 in the
        chunk) are recorded in ``seg``."""
        rp = self.rp
        inner = rp.reoptimize_step

        def step(*args, **kw):
            it = int(args[7])
            check = seg is not None and checked(it - last_done - 1)
            if check and seg.start is None:
                seg.start = self._snapshot(args[1], args[2])
            out = inner(*args, **kw)
            frame = self.view_of[args[5].data_ptr()]
            self.frames.append(frame)
            if check:
                seg.record(frame, it, out)
            return out

        rp.reoptimize_step = step
        try:
            self.deltas, self.opt_state, _, self.order = \
                rp.reoptimize_frames(
                    self.base, self.deltas, self.opt_state, self.train_mask,
                    self.pcams, self.targets, self.bg, self.candidates,
                    last_done + 1, n, self.opt, self.rng, order=self.order,
                    sky_images=self.sky_images, duplicate_capacity=self.cap)
        finally:
            rp.reoptimize_step = inner

    def _frozen(self) -> float:
        from streetunveiler_torch.models.deltas import apply_deltas
        return frozen_gap(self.base, self.deltas, self.train_mask,
                          apply_deltas)

    # ----------------------------------------------------------- window

    def window(self, seconds, tracer):
        rp = self.rp
        orig_render = rp.render
        self.flags = []

        def render(*args, **kw):
            res = orig_render(*args, **kw)
            self.flags.append(res.overflow)
            return res

        on_card = self.dev.type == "cuda"
        setup_peak = torch.cuda.max_memory_allocated(self.dev) if on_card \
            else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats(self.dev)
        chunk = int(self.t["chunk"])
        late = chunk - int(self.t["checked_window_steps"])
        done, steps = self.next_it, 0
        self.frames = []
        rp.render = render
        try:
            with tracer.window():
                t0 = time.perf_counter()
                while True:
                    if done + chunk > self.range[1]:
                        self._restart()
                        done = self.range[0] - 1
                    # the last steps of each chunk are recorded for the
                    # reference; the newest chunk's are kept
                    self.window_segment = None
                    seg = Segment()
                    self._chunk(done, chunk, lambda i: i >= late, seg)
                    self.window_segment = seg
                    done, steps = done + chunk, steps + chunk
                    if time.perf_counter() - t0 >= seconds:
                        break
        finally:
            rp.render = orig_render
        self.next_it = done
        window_peak = torch.cuda.max_memory_allocated(self.dev) if on_card \
            else 0
        overflowed = int(torch.stack(self.flags).sum()) if self.flags else 0
        self.flags = []
        self.frozen["window"] = self._frozen()
        return dict(t_window_start=tracer.t_begin,
                    seconds=tracer.t_end - tracer.t_begin, steps=steps,
                    attempted=steps, failed=overflowed,
                    memory_peak_bytes=max(setup_peak, window_peak),
                    window_peak_bytes=window_peak)

    def end_to_end(self, stats):
        """The cell's rate: rays (pixels of a view) × steps completed ÷
        the window, under the name its workload file gives it."""
        return {self.t["rate_metric"]: self.w * self.h * stats["steps"]
                / stats["seconds"]}

    # -------------------------------------------------- per-layer reading

    def reading(self, stats, tracer, untraced):
        """The traced window's reading: the trace, the step count, the
        window's peak memory, the untraced window's time per step, and the
        counted operations of the window's last SAMPLED_STEPS steps (the
        reference's pairs of each step's frame on the effective state at
        the window's close)."""
        sample = [self._step_ops(f) for f in self.frames[-SAMPLED_STEPS:]]
        return Reading(kind="unveil", tracer=tracer, steps=stats["steps"],
                       peak_bytes=stats["window_peak_bytes"], sample=sample,
                       window_s=tracer.window_s,
                       step_s=(untraced["seconds"] / untraced["steps"]
                               if untraced and untraced["steps"] else None))

    @torch.no_grad()
    def _step_ops(self, frame):
        if not hasattr(self, "_counted"):
            self._counted = {}
        if frame not in self._counted:
            deltas = ref.SurfelParams(**{
                k: v.detach().clone() for k, v in _leaves(
                    self.deltas).items()})
            st = ref_unveil.apply_deltas(self.rbase, deltas,
                                         self.train_mask)
            w2c, K = self.cams[frame]
            cam = states.reference_camera(w2c, K, self.w, self.h)
            c = ref.pair_counts(cam, st, active_sh_degree=st.sh_degree,
                                duplicate_capacity=self.cap)
            self._counted[frame] = dict(
                ops=counts.k1_ops(c["k1"]) + counts.k2_ops(c["k2"], c["nq"])
                + L1_OPS * 3 * self.w * self.h)
        return self._counted[frame]

    # ------------------------------------------------------------ check

    def release(self):
        """Free the program's state before the reference runs."""
        self.base = self.deltas = self.opt_state = None
        self.sky_images = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _segments(self) -> dict:
        out = dict(self.segments)
        if self.window_segment is not None and self.window_segment.steps:
            out["window"] = self.window_segment.on_host()
            self.window_segment = None
        self.segments = out
        return out

    def replay_segment(self, seg: dict, **mode) -> dict:
        """The reference's run of a segment's steps from its start
        (``mode``: ``model.mode``'s switches and ``unveil.fault``'s):
        losses, first gradient, change, frozen rows' gap, on the host."""
        faults = {k: mode.pop(k) for k in ("mask_ignored", "unchanged")
                  if k in mode}
        start = seg["start"]
        put = lambda d: ref.SurfelParams(**{k: d[k].to(self.dev).clone()
                                            for k in states.PARAMS})
        deltas = put(start["deltas"])
        it0 = seg["steps"][0]["iteration"]
        opt_state = ref.AdamState(step=it0 - self.range[0],
                                  mu=put(start["mu"]), nu=put(start["nu"]))
        sky = states.reference_sky(self.sky0, self.dev)
        losses, g1 = [], {}
        with ref.mode(**mode), ref_unveil.fault(**faults):
            for r in seg["steps"]:
                w2c, K = self.cams[r["frame"]]
                cam = states.reference_camera(w2c, K, self.w, self.h)
                with torch.no_grad():
                    sky_img = ref.render_sky(sky, self.h, self.w, K,
                                             torch.linalg.inv(w2c))
                deltas, opt_state, loss, overflow = \
                    ref_unveil.reoptimize_step(
                        self.rbase, deltas, opt_state, self.train_mask, cam,
                        self.targets[r["frame"]], self.bg, r["iteration"],
                        self.ref_opt, sky_image=sky_img,
                        duplicate_capacity=self.cap)
                if overflow:
                    raise RuntimeError("a reference step overflowed")
                losses.append(float(loss))
                if not g1:
                    g1 = first_gradient(_leaves(opt_state.mu), start["mu"])
        frozen = frozen_gap(self.rbase, deltas, self.train_mask,
                            ref_unveil.apply_deltas)
        after = {k: v.detach().cpu() for k, v in _leaves(deltas).items()}
        return dict(losses=losses, g1=g1,
                    change={k: after[k] - start["deltas"][k] for k in after},
                    frozen=frozen)

    def replay(self, **mode) -> dict:
        return {name: self.replay_segment(seg, **dict(mode))
                for name, seg in self._segments().items()}

    def program_result(self) -> dict:
        return {name: dict(
            losses=[r["loss"] for r in seg["steps"]], g1=seg["g1"],
            change={k: v - seg["start"]["deltas"][k]
                    for k, v in seg["after"].items()},
            frozen=self.frozen[name])
            for name, seg in self._segments().items()}

    def numbers(self, prog: dict, want: dict) -> dict:
        """Each number's worst over the segments, and each segment's."""
        per = {name: unveil_numbers(prog[name], want[name]) for name in want}
        out = {k: max(n[k] for n in per.values()) for k in CHECKED}
        out["segments"] = per
        out["counts"] = self.counts
        return out

    def check(self) -> list:
        n = self.numbers(self.program_result(), self.replay())
        return [Check(k, n[k], float(self.spec.limits[k])) for k in CHECKED]


def unveil_numbers(prog: dict, want: dict) -> dict:
    """``compare.training_numbers`` over the six delta leaves, its exact
    ``stats_gap`` reading the program's frozen rows against 0 as
    ``frozen_gap``."""
    n = compare.training_numbers(
        dict(prog, stats={"frozen": torch.tensor(prog["frozen"])}),
        dict(want, stats={"frozen": torch.tensor(0.0)}))
    n["frozen_gap"] = n.pop("stats_gap")
    return n


@torch.no_grad()
def frozen_gap(base, deltas, train_mask, apply_deltas) -> float:
    """The largest |delta| and |effective − base| on the rows outside the
    train mask, the effective state by ``apply_deltas`` (NaN where a delta
    there is not finite)."""
    out = (~train_mask).to(torch.float32)
    eff = apply_deltas(base, deltas, train_mask)
    worst = []
    for k in states.PARAMS:
        d = getattr(deltas, k)
        o = out.reshape((-1,) + (1,) * (d.dim() - 1))
        gap = getattr(eff.params, k) - getattr(base.params, k)
        worst += [(d.abs() * o).amax(), (gap.abs() * o).amax()]
    return float(torch.stack(worst).amax())


class Segment:
    """Delta steps that the reference follows: the deltas and moments
    they start from, and for each step its frame, iteration and loss; the
    first moments after the first step; the deltas after the last. Filled
    on the card inside the window; ``on_host`` copies it."""

    def __init__(self, start=None):
        self.start = start
        self.steps = []
        self.mu1 = self.after = None

    def record(self, frame, iteration, out):
        deltas, opt_state, loss = out
        self.steps.append(dict(frame=frame, iteration=iteration,
                               loss=loss.detach().clone()))
        if self.mu1 is None:
            self.mu1 = {k: v.detach().clone()
                        for k, v in _leaves(opt_state.mu).items()}
        self.after = {k: v.detach().clone()
                      for k, v in _leaves(deltas).items()}

    def on_host(self) -> dict:
        host = lambda d: {k: v.cpu() for k, v in d.items()}
        start = {k: host(v) for k, v in self.start.items()}
        return dict(start=start,
                    steps=[dict(r, loss=float(r["loss"]))
                           for r in self.steps],
                    g1=first_gradient(self.mu1, start["mu"]),
                    after=host(self.after))
