"""Entry driver of the training cells: the port's stage-1 loop,
``streetunveiler_torch.train.loop.train_scene``, run from a fixed
iteration on the cell's scene, closed loop.

Set-up makes the scene, its targets and the sky from the seed, builds the
program's state, optimizer and sky once, and drives them through
``train_scene`` for the cell's first ``setup_steps`` iterations (one call,
three views that all differ). The same objects then go into the window:
``train_scene`` called in chunks of ``chunk`` iterations, each chunk
inside the cell's iteration range (no densify, reset or prune event falls
in it), until ``--seconds`` have passed. Each call's own start-up
(uploading the targets, the capacity probe) is inside the window, as it is
in a user's run. The Adam states each chunk's last step returned go into
the next chunk. A chunk that would leave the range, or a training step
whose duplicate stream overflowed, is failed work.

The reference follows two segments after the window: the set-up steps
from the seed's state, and the last ``checked_window_steps`` steps of the
window's newest chunk from the program's state, moments and sky just
before them (copied on the card inside the window; nothing waits). Of
each it compares the first step's loss, the first gradient (from Adam's
first moment after one step), the parameters' change and the
densification statistics.

The harness wraps the name ``bin_step`` that ``train.loop`` calls: to
keep each call's overflow flag (a device tensor; nothing waits for it)
and, in a traced run, to open the ``bin_step`` range the binning's
per-layer metric reads. No program file is edited.
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from perfbench import compare, counts, scenes, states
from perfbench.harness import Check
from perfbench.reference import model as ref

SAMPLED_STEPS = 3    # training steps whose pairs the rooflines count


class Reading(types.SimpleNamespace):
    """What a traced training window offers the per-layer readers."""


class Cell:
    def __init__(self, spec, device):
        self.spec = spec
        self.cfg = spec.config
        self.t = spec.traffic
        self.dev = torch.device(device)
        self.w, self.h = int(self.cfg["width"]), int(self.cfg["height"])
        self.reference_s = 0.0

    # ----------------------------------------------------------- inputs

    def _inputs(self, seed):
        cfg, dev = self.cfg, self.dev
        if cfg["scene"] != "street":
            raise ValueError(f"unknown scene {cfg['scene']!r}")
        arrays = scenes.street_arrays(cfg, seed, dev)
        raw = scenes.street_raw_state(arrays, cfg)
        cams = scenes.street_cameras(cfg, dev)
        # the targets are the reference's renders; their seconds are the
        # benchmark's, not the program's set-up
        t0 = time.perf_counter()
        gt = scenes.activated(raw, float(cfg["gt_opacity_boost"]))
        gt_cap = scenes.stream_capacity(gt, cams, self.w, self.h, 1.2)
        images, labels = scenes.render_targets(
            gt, cams, self.w, self.h, [0.0, 0.0, 0.0], gt_cap,
            colors_fn=scenes.sh_colors(raw))
        self.reference_s += time.perf_counter() - t0
        return raw, cams, images, labels, [0.0, 0.0, 0.0]

    # ----------------------------------------------------------- set-up

    def setup(self, seed):
        from streetunveiler_torch.config import OptimizationParams
        from streetunveiler_torch.device import strict_fp32
        from streetunveiler_torch.train import loop
        from streetunveiler_torch.train.optim import adam_init
        from streetunveiler_torch.train.step import init_optimizer
        strict_fp32()
        self.seed = seed
        self.loop = loop
        raw, cams, images, labels, bg = self._inputs(seed)
        if self.dev.type == "cuda":
            # the run's peak is the program's, not that of the reference's
            # target renders
            torch.cuda.reset_peak_memory_stats(self.dev)
        self.cams, self.images, self.labels, self.bg = cams, images, labels, bg
        self.sky0 = (scenes.sky_arrays(seed, self.dev) if self.t.get("sky")
                     else None)
        self.semantics = bool(self.t.get("semantics"))
        self.opt = OptimizationParams(**self.cfg["optimization"])
        self.ref_opt = ref.StepOptions(**{
            k: v for k, v in self.cfg["optimization"].items()
            if k in ref.StepOptions.__dataclass_fields__})

        self.pcams = [states.program_camera(w2c, K, self.w, self.h)
                      for w2c, K in cams]
        self.view_of = {c.w2c.data_ptr(): i for i, c in enumerate(self.pcams)}
        self.scene = types.SimpleNamespace(
            train_cameras=self.pcams, train_images=images,
            train_semantics=labels if self.semantics else None,
            test_cameras=[], test_images=[], model_path="")
        self.state = states.program_state(raw, self.dev)
        self.opt_state = init_optimizer(self.state)
        self.sky = self.sky_opt = None
        if self.sky0 is not None:
            self.sky = states.program_sky(self.sky0, self.dev)
            self.sky_opt = adam_init(self.sky)
        del raw

        lo, hi = self.t["iterations"]
        self.range = (int(lo), int(hi))
        n0 = int(self.t["setup_steps"])
        # the set-up steps, from the seed's state and fresh moments
        start = self._snapshot(self.state, self.opt_state, self.sky,
                               self.sky_opt, on_host=True)
        seg = Segment(start)
        self._chunk(self.range[0] - 1, n0, 0, lambda i: True, seg)
        self.next_it = self.range[0] - 1 + n0
        self.segments = {"setup": seg.on_host()}
        self.window_segment = None

    def _snapshot(self, state, opt_state, sky, sky_opt, on_host=False):
        """Copies of a state, the sky, their Adam moments and the
        densification statistics: on the card inside the window (nothing
        waits for them), on the host otherwise."""
        put = ((lambda t: t.detach().cpu().clone()) if on_host
               else (lambda t: t.detach().clone()))
        sky_mu, sky_nu = ((None, None) if sky_opt is None
                          else (sky_opt.mu, sky_opt.nu))
        return dict(
            params={k: put(v) for k, v in states.leaves(state.params,
                                                        sky).items()},
            stats={k: put(getattr(state, k)) for k in states.STATS},
            sh_degree=state.sh_degree,
            mu={k: put(v) for k, v in states.leaves(opt_state.mu,
                                                    sky_mu).items()},
            nu={k: put(v) for k, v in states.leaves(opt_state.nu,
                                                    sky_nu).items()})

    def _chunk(self, last_done: int, n: int, k: int, checked=None,
               seg=None):
        """``train_scene`` over iterations last_done+1 .. last_done+n. The
        Adam states that the chunk's last step returned go into the next
        chunk, as a resumed run's would. The steps ``checked(i)`` names (i
        counted from 0 in the chunk) are recorded in ``seg``."""
        loop = self.loop
        inner = loop.train_step

        def step(*args, **kw):
            i = int(args[5]) - last_done - 1
            check = seg is not None and checked(i)
            if check and not seg.steps:
                seg.start = seg.start or self._snapshot(
                    args[0], args[1], kw.get("sky_params"),
                    kw.get("sky_opt_state"))
            out = inner(*args, **kw)
            self.opt_state, self.sky_opt = out[1], out[3]
            if check:
                seg.record(self, args, kw, out)
            return out

        loop.train_step = step
        try:
            self.state, self.sky, _ = loop.train_scene(
                self.scene, self.state, self.opt, sky_params=self.sky,
                bg=self.bg, start_iteration=last_done,
                iterations=last_done + n, log_every=10 ** 9,
                duplicate_capacity=None, use_semantics=self.semantics,
                seed=(self.seed * 1_000_003 + k) % (2 ** 62),
                opt_state=self.opt_state, sky_opt_state=self.sky_opt,
                device=self.dev)
        finally:
            loop.train_step = inner

    # ----------------------------------------------------------- window

    def window(self, seconds, tracer):
        loop = self.loop
        orig_bin, orig_step = loop.bin_step, loop.train_step
        # one entry per bin_step call: its view, its stream's capacity, its
        # overflow flag (a 0-d device tensor; nothing waits for it) and
        # whether a training step used it (the capacity probe's do not).
        # Only the newest binning is held, so the window's memory is the
        # program's.
        self.bin_calls = []
        newest = [None]

        def binning(state, camera, duplicate_capacity=None, device="cuda"):
            with tracer.span("bin_step"):
                b = orig_bin(state, camera,
                             duplicate_capacity=duplicate_capacity,
                             device=device)
            self.bin_calls.append(dict(
                view=self.view_of[camera.w2c.data_ptr()],
                capacity=b.sorted_surfel.shape[0], overflow=b.overflow,
                trained=False))
            newest[0] = b
            return b

        def step(*args, **kw):
            if kw.get("binning") is not None \
                    and kw["binning"] is newest[0]:
                self.bin_calls[-1]["trained"] = True
            return orig_step(*args, **kw)

        on_card = self.dev.type == "cuda"
        setup_peak = torch.cuda.max_memory_allocated(self.dev) if on_card \
            else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats(self.dev)
        chunk = int(self.t["chunk"])
        late = chunk - int(self.t["checked_window_steps"])
        done, steps, k = self.next_it, 0, 1
        self.range_exceeded = False
        loop.bin_step, loop.train_step = binning, step
        try:
            with tracer.window():
                t0 = time.perf_counter()
                while True:
                    if done + chunk > self.range[1]:
                        self.range_exceeded = True
                        break
                    # the last steps of each chunk are recorded for the
                    # reference; the newest chunk's are kept
                    self.window_segment = None
                    seg = Segment()
                    self._chunk(done, chunk, k, lambda i: i >= late, seg)
                    self.window_segment = seg
                    done, steps, k = done + chunk, steps + chunk, k + 1
                    if time.perf_counter() - t0 >= seconds:
                        break
        finally:
            loop.bin_step, loop.train_step = orig_bin, orig_step
            newest[0] = None
        self.next_it = done
        window_peak = torch.cuda.max_memory_allocated(self.dev) if on_card \
            else 0
        flags = [c["overflow"] for c in self.bin_calls if c["trained"]]
        overflowed = int(torch.stack(flags).sum()) if flags else 0
        failed = overflowed + (chunk if self.range_exceeded else 0)
        return dict(t_window_start=tracer.t_begin,
                    seconds=tracer.t_end - tracer.t_begin, steps=steps,
                    attempted=steps + (chunk if self.range_exceeded else 0),
                    failed=failed, overflowed=overflowed,
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
        window's peak memory, the untraced window's time per step, and
        SAMPLED_STEPS training steps near the window's end (each with its
        host span, up to the next step's binning, and the reference's pair
        counts of its view on the state at the window's close)."""
        spans = tracer.spans.get("bin_step", [])
        train = [(span, call) for span, call in zip(spans, self.bin_calls)
                 if call["trained"]] \
            if len(spans) == len(self.bin_calls) else []
        chunk = int(self.t["chunk"])
        sample = []
        if len(train) >= chunk and chunk > SAMPLED_STEPS + 1:
            last = train[-chunk:]               # the window's last chunk
            for i in range(chunk - SAMPLED_STEPS - 1, chunk - 1):
                call = last[i][1]
                sample.append(dict(
                    span=(last[i][0][0], last[i + 1][0][0]),
                    view=call["view"],
                    **self._step_counts(call["view"], call["capacity"])))
        return Reading(kind="train", tracer=tracer, steps=stats["steps"],
                       peak_bytes=stats["window_peak_bytes"], sample=sample,
                       window_s=tracer.window_s,
                       step_s=(untraced["seconds"] / untraced["steps"]
                               if untraced and untraced["steps"] else None))

    def _step_counts(self, view, capacity):
        """The reference's K1/K2 pair counts of ``view`` on the program's
        state as the window left it (its stream at the program's
        ``capacity``, which K2's bytes count), and the step's other
        counted operations."""
        if not hasattr(self, "_counted"):
            self._counted = {}
        if (view, capacity) in self._counted:
            return self._counted[view, capacity]
        st = states.reference_state(states.raw_of(self.state), self.dev)
        w2c, K = self.cams[view]
        cam = states.reference_camera(w2c, K, self.w, self.h)
        late = self.semantics and self.next_it + 1 \
            > self.ref_opt.semantic_dist_from_iter
        extra = (torch.nn.functional.one_hot(st.semantics.long(), 6).float()
                 if self.semantics else None)
        gates = (torch.stack([ref.semantic_class_mask(st, 1 << ci)
                              for ci in ref.DIST_CLASSES], dim=1)
                 if late else None)
        active = min(self.range[0] // 1000, st.sh_degree)
        c = ref.pair_counts(cam, st, active_sh_degree=active,
                            extra_payload=extra, class_gates=gates,
                            duplicate_capacity=capacity)
        pixels = self.w * self.h
        k1_ops = counts.k1_ops(c["k1"])
        k2_ops = counts.k2_ops(c["k2"], c["nq"])
        other = counts.ssim_ops(pixels) + (
            counts.sky_ops(pixels, backward=True) if self.sky is not None
            else 0.0)
        out = dict(
            k1_bound_s=counts.bound_s(counts.k1_bytes(
                c["rec_rows"], c["filled"], c["n_tiles"], c["pixels"],
                c["channels"]), k1_ops),
            k2_bound_s=counts.bound_s(counts.k2_bytes(
                c["rec_rows"], c["capacity"], c["filled"], c["n_tiles"],
                c["pixels"], c["nq"], c["n_gates"]), k2_ops),
            ops=k1_ops + k2_ops + other)
        self._counted[view, capacity] = out
        return out

    # ------------------------------------------------------------ check

    def release(self):
        """Free the program's state before the reference runs."""
        self.state = self.opt_state = self.sky = self.sky_opt = None
        self.scene = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _segments(self) -> dict:
        """The recorded steps by segment: the set-up's, from the seed's
        state, and the window's newest chunk's last steps, from the
        program's state there, on the host."""
        out = dict(self.segments)
        if self.window_segment is not None and self.window_segment.steps:
            out["window"] = self.window_segment.on_host()
            self.window_segment = None
        self.segments = out
        return out

    def _ref_capacity(self, name: str, seg: dict) -> int:
        """The reference's stream capacity for a segment: its own
        binning's demand over the segment's views, with room."""
        if not hasattr(self, "_caps"):
            self._caps = {}
        if name not in self._caps:
            raw = states.to_device(self._raw(seg["start"]), self.dev)
            views = sorted({r["view"] for r in seg["steps"]})
            self._caps[name] = scenes.stream_capacity(
                scenes.activated(raw), [self.cams[v] for v in views],
                self.w, self.h, 1.2)
        return self._caps[name]

    @staticmethod
    def _raw(snap: dict) -> dict:
        raw = {k: snap["params"][k] for k in states.PARAMS}
        raw.update(snap["stats"])
        raw["sh_degree"] = snap["sh_degree"]
        return raw

    def _sky(self, leaves: dict):
        if self.sky0 is None:
            return None
        return dict(self.sky0, hash_tables=leaves["sky.hash_tables"],
                    mlp_w=tuple(leaves[f"sky.mlp_w{i}"]
                                for i in range(len(self.sky0["mlp_w"]))),
                    mlp_b=tuple(leaves[f"sky.mlp_b{i}"]
                                for i in range(len(self.sky0["mlp_b"]))))

    def _adam(self, snap: dict, steps_taken: int, sky: bool):
        """The reference's Adam state from a snapshot's moments; its step
        count is the one the schedule implies (the steps since the cell's
        first iteration), not the program's counter."""
        def moments(leaves):
            if sky:
                return states.reference_sky(self._sky(leaves), self.dev)
            return ref.SurfelParams(**{k: leaves[k].to(self.dev).clone()
                                       for k in states.PARAMS})
        return ref.AdamState(step=steps_taken, mu=moments(snap["mu"]),
                             nu=moments(snap["nu"]))

    def replay_segment(self, name: str, seg: dict, **mode) -> dict:
        """The reference's run of a segment's steps from its start
        (``mode``: ``reference.model.mode``'s switches): losses, first
        gradient, change, statistics, on the host."""
        start = seg["start"]
        st = states.reference_state(self._raw(start), self.dev)
        it0 = seg["steps"][0]["iteration"]
        opt_state = self._adam(start, it0 - self.range[0], sky=False)
        sky = sky_opt = None
        if self.sky0 is not None:
            sky = states.reference_sky(self._sky(start["params"]), self.dev)
            sky_opt = self._adam(start, it0 - self.range[0], sky=True)
        cap = self._ref_capacity(name, seg)
        losses, g1 = [], {}
        bg = torch.tensor(self.bg, dtype=torch.float32, device=self.dev)
        with ref.mode(**mode):
            for r in seg["steps"]:
                w2c, K = self.cams[r["view"]]
                cam = states.reference_camera(w2c, K, self.w, self.h)
                gt = torch.as_tensor(np.asarray(self.images[r["view"]]),
                                     device=self.dev)
                sem = (torch.as_tensor(self.labels[r["view"]],
                                       device=self.dev)
                       if r["semantic"] else None)
                st, opt_state, sky, sky_opt, m = ref.train_step(
                    st, opt_state, cam, gt, bg, r["iteration"], self.ref_opt,
                    sky_params=sky, sky_opt_state=sky_opt, gt_semantic=sem,
                    class_dist=r["class_dist"], duplicate_capacity=cap,
                    device=self.dev)
                losses.append(float(m["loss"]))
                if not g1:
                    g1 = first_gradient(states.leaves(
                        opt_state.mu, sky_opt.mu if sky_opt is not None
                        else None), start["mu"])
        after = {k: v.detach().cpu()
                 for k, v in states.leaves(st.params, sky).items()}
        return dict(losses=losses, g1=g1,
                    change={k: after[k] - start["params"][k] for k in after},
                    stats={k: getattr(st, k).detach().cpu()
                           for k in STATS_COMPARED})

    def replay(self, **mode) -> dict:
        return {name: self.replay_segment(name, seg, **mode)
                for name, seg in self._segments().items()}

    def program_result(self) -> dict:
        return {name: dict(
            losses=[r["loss"] for r in seg["steps"]], g1=seg["g1"],
            change={k: v - seg["start"]["params"][k]
                    for k, v in seg["after"].items()},
            stats=seg["stats"]) for name, seg in self._segments().items()}

    def numbers(self, prog: dict, want: dict) -> dict:
        """Each number's worst over the segments, and each segment's."""
        per = {name: compare.training_numbers(prog[name], want[name])
               for name in want}
        out = {k: max(n[k] for n in per.values()) for k in CHECKED}
        out["segments"] = per
        return out

    def check(self) -> list:
        n = self.numbers(self.program_result(), self.replay())
        return [Check(k, n[k], float(self.spec.limits[k])) for k in CHECKED]


CHECKED = ("loss_gap", "grad_gap", "change_gap", "stats_gap")
STATS_COMPARED = ("grad_accum", "denom", "max_radii2d")


def first_gradient(mu1: dict, mu0: dict) -> dict:
    """The gradient the optimizer got in a step, on the host: its first
    moment after the step less β1 times before, over 1 − β1."""
    return {k: (v.detach().cpu().double() - compare.BETA1
                * mu0[k].cpu().double()) / (1.0 - compare.BETA1)
            for k, v in mu1.items()}


class Segment:
    """Training steps that the reference follows: the state they start
    from, and for each step its view, iteration and loss; the first
    moments after the first step; the parameters and statistics after the
    last. Filled on the card inside the window; ``on_host`` copies it."""

    def __init__(self, start=None):
        self.start = start
        self.steps = []
        self.mu1 = self.after = self.stats = None

    def record(self, cell, args, kw, out):
        state, opt_state, sky, sky_opt, metrics = out
        self.steps.append(dict(
            view=cell.view_of[args[2].w2c.data_ptr()],
            iteration=int(args[5]), loss=metrics["loss"].detach().clone(),
            class_dist=bool(kw.get("class_dist")),
            semantic=kw.get("gt_semantic") is not None))
        if self.mu1 is None:
            self.mu1 = {k: v.detach().clone() for k, v in states.leaves(
                opt_state.mu, sky_opt.mu if sky_opt is not None
                else None).items()}
        self.after = {k: v.detach().clone()
                      for k, v in states.leaves(state.params, sky).items()}
        self.stats = {k: getattr(state, k).detach().clone()
                      for k in STATS_COMPARED}

    def on_host(self) -> dict:
        host = lambda d: {k: (v.cpu() if torch.is_tensor(v) else v)
                          for k, v in d.items()}
        start = {k: (host(v) if isinstance(v, dict) else v)
                 for k, v in self.start.items()}
        return dict(start=start,
                    steps=[dict(r, loss=float(r["loss"]))
                           for r in self.steps],
                    g1=first_gradient(self.mu1, start["mu"]),
                    after=host(self.after), stats=host(self.stats))
