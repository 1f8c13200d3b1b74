"""Entry driver of the render cells: the render CLI's view,
``streetunveiler_torch.cli.render.render_view(..., semantics=True)`` with
the sky, over the cell's views in turn, closed loop.

Set-up makes the scene and the sky from the seed, builds the program's
state once, switches TF32 off as the render CLI does, and renders the
first two views to warm up. The window renders view after view until
``--seconds`` have passed; each frame ends when the outputs the CLI writes
(the clamped image, depth, world normals as written, the semantic argmax)
are on the host.
The last copy of each of ``check_views`` views, drawn from the seed, is
kept and compared with the reference's render of that view after the
window.
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from perfbench import compare, counts, scenes, states
from perfbench.harness import Check
from perfbench.reference import model as ref

SAMPLED_FRAMES = 3    # frames whose pairs the rooflines count
OUTPUTS = ("image", "depth", "normal", "semantics")


def written(img, depth, nrm, sem):
    """What the render CLI takes to the host to write a view: the image
    clamped to [0, 1], the depth, the normals mapped to [0, 1], the
    semantic argmax."""
    return [torch.clamp(img, 0, 1).cpu(), depth.cpu(),
            (nrm * 0.5 + 0.5).cpu(), sem.argmax(-1).cpu()]


class Reading(types.SimpleNamespace):
    """What a traced render window offers the per-layer readers."""


class Cell:
    def __init__(self, spec, device):
        self.spec = spec
        self.cfg = spec.config
        self.t = spec.traffic
        self.dev = torch.device(device)
        self.w, self.h = int(self.cfg["width"]), int(self.cfg["height"])
        self.reference_s = 0.0     # no input of this cell is the reference's

    def setup(self, seed):
        from streetunveiler_torch.cli.render import render_view
        from streetunveiler_torch.device import strict_fp32
        from streetunveiler_torch.renderer import measure_duplicate_capacity
        strict_fp32()
        self.render_view = render_view
        cfg = self.cfg
        arrays = scenes.street_arrays(cfg, seed, self.dev)
        raw = scenes.street_raw_state(arrays, cfg)
        self.cams = scenes.street_cameras(cfg, self.dev)
        self.raw0 = {k: (v.cpu().clone() if torch.is_tensor(v) else v)
                     for k, v in raw.items()}
        self.sky0 = scenes.sky_arrays(seed, self.dev)
        self.state = states.program_state(raw, self.dev)
        self.sky = states.program_sky(self.sky0, self.dev)
        self.pcams = [states.program_camera(w2c, K, self.w, self.h)
                      for w2c, K in self.cams]
        self.bg = torch.zeros(3, device=self.dev)
        # the render CLI's capacity: the state's measured demand
        self.cap = measure_duplicate_capacity(self.pcams, self.state,
                                              device=self.dev)
        rng = np.random.default_rng(int(seed) % (2 ** 63))
        n = len(self.cams)
        self.check_views = sorted(int(v) for v in rng.choice(
            n, size=min(int(self.t["check_views"]), n), replace=False))
        del raw
        for v in range(min(2, n)):
            self._frame(v)

    def _frame(self, v):
        """One view as the render CLI renders and copies it."""
        img, depth, nrm, sem = self.render_view(
            self.pcams[v], self.state, self.bg, self.sky, self.cap, True,
            self.dev)
        return written(img, depth, nrm, sem)

    def window(self, seconds, tracer):
        on_card = self.dev.type == "cuda"
        setup_peak = torch.cuda.max_memory_allocated(self.dev) if on_card \
            else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats(self.dev)
        n = len(self.cams)
        self.kept = {}
        self.frame_views = []
        frames, failed = 0, 0
        with tracer.window():
            t0 = time.perf_counter()
            while True:
                v = frames % n
                with tracer.span("frame"):
                    host = self._frame(v)
                if v in self.check_views:
                    self.kept[v] = host
                self.frame_views.append(v)
                frames += 1
                if time.perf_counter() - t0 >= seconds:
                    break
        window_peak = torch.cuda.max_memory_allocated(self.dev) if on_card \
            else 0
        self.frames = frames
        return dict(t_window_start=tracer.t_begin,
                    seconds=tracer.t_end - tracer.t_begin, frames=frames,
                    attempted=frames, failed=failed,
                    memory_peak_bytes=max(setup_peak, window_peak),
                    window_peak_bytes=window_peak)

    def end_to_end(self, stats):
        return {"render_frames_per_s": stats["frames"] / stats["seconds"]}

    def reading(self, stats, tracer, untraced):
        """The traced window's reading: the trace, the frame count, the
        window's peak memory, the untraced window's time per frame, and
        the last SAMPLED_FRAMES frames (each with its host span and the
        reference's pair counts of its view's two blends)."""
        spans = tracer.spans.get("frame", [])
        sample = []
        if len(spans) == len(self.frame_views):
            for span, v in list(zip(spans, self.frame_views))[
                    -SAMPLED_FRAMES:]:
                sample.append(dict(span=span, view=v,
                                   **self._frame_counts(v)))
        return Reading(kind="render", tracer=tracer, frames=stats["frames"],
                       peak_bytes=stats["window_peak_bytes"], sample=sample,
                       window_s=tracer.window_s,
                       frame_s=(untraced["seconds"] / untraced["frames"]
                                if untraced and untraced["frames"]
                                else None))

    def _frame_counts(self, view):
        """The reference's K1 pair counts of both blends of a frame (the
        render at nq 6, ``render_semantic`` at nq 9) and the frame's
        counted operations."""
        if not hasattr(self, "_counted"):
            self._counted = {}
        if view in self._counted:
            return self._counted[view]
        st = states.reference_state(self.raw0, self.dev)
        w2c, K = self.cams[view]
        cam = states.reference_camera(w2c, K, self.w, self.h)
        onehot = torch.nn.functional.one_hot(st.semantics.long(), 6).float()
        passes = [ref.pair_counts(cam, st, duplicate_capacity=self.cap,
                                  backward=False),
                  ref.pair_counts(cam, st, colors_override=onehot[:, :3],
                                  extra_payload=onehot[:, 3:],
                                  duplicate_capacity=self.cap,
                                  backward=False)]
        bound, ops = 0.0, 0.0
        for c in passes:
            o = counts.k1_ops(c["k1"])
            bound += counts.bound_s(counts.k1_bytes(
                c["rec_rows"], c["filled"], c["n_tiles"], c["pixels"],
                c["channels"]), o)
            ops += o
        out = dict(k1_bound_s=bound, k1_launches=len(passes),
                   ops=ops + counts.sky_ops(self.w * self.h, backward=False))
        self._counted[view] = out
        return out

    def release(self):
        self.state = self.sky = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def reference_frame(self, view, **mode) -> dict:
        """The reference's outputs of ``view``, as the render CLI's view
        makes them, on the host."""
        st = states.reference_state(self.raw0, self.dev)
        sky = states.reference_sky(self.sky0, self.dev)
        w2c, K = self.cams[view]
        cam = states.reference_camera(w2c, K, self.w, self.h)
        if not hasattr(self, "ref_cap"):
            # the reference's own binning's demand over the checked views
            self.ref_cap = scenes.stream_capacity(
                scenes.activated(states.to_device(self.raw0, self.dev)),
                [self.cams[v] for v in self.kept], self.w, self.h, 1.0)
        with ref.mode(**mode):
            res = ref.render(cam, st, self.bg,
                             duplicate_capacity=self.ref_cap,
                             device=self.dev)
            sky_img = ref.render_sky(sky, cam.height, cam.width, cam.K,
                                     torch.linalg.inv(cam.w2c))
            img = res.render + sky_img * (1.0 - res.rend_alpha)[..., None]
            sem = ref.render_semantic(cam, st,
                                      duplicate_capacity=self.ref_cap,
                                      device=self.dev)
        return dict(zip(OUTPUTS, written(img, res.surf_depth,
                                         res.rend_normal_world(cam), sem)))

    def program_frames(self) -> dict:
        return {v: dict(zip(OUTPUTS, out)) for v, out in self.kept.items()}

    def numbers(self, prog: dict, want: dict) -> dict:
        worst = (0.0, "", -1)
        for v in prog:
            share, output = compare.mismatch_share(prog[v], want[v])
            if share >= worst[0]:
                worst = (share, output, v)
        return dict(mismatch_share=worst[0], output=worst[1], view=worst[2])

    def replay(self, **mode) -> dict:
        return {v: self.reference_frame(v, **mode) for v in self.kept}

    def check(self) -> list:
        if not self.kept:
            return [Check("mismatch_share", float("nan"),
                          float(self.spec.limits["mismatch_share"]))]
        n = self.numbers(self.program_frames(),
                                             self.replay())
        return [Check("mismatch_share", n["mismatch_share"],
                      float(self.spec.limits["mismatch_share"]))]
