"""Training log (counterpart of ``streetunveiler_tpu/utils/logging.py``):
scalars as JSON lines in ``train_log.jsonl``, rendered panels as PNG files
under the log directory (the JAX package mirrors both to TensorBoard), and
``profile_trace``, a ``torch.profiler`` trace of a few steps written as a
Chrome trace."""

from __future__ import annotations

import json
import os
import time

import numpy as np


class TrainLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.jsonl = open(os.path.join(log_dir, "train_log.jsonl"), "a")
        self._t0 = time.time()

    def scalars(self, step: int, values: dict) -> None:
        rec = {"step": step, "t": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in values.items()})
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()

    def image(self, step: int, tag: str, img) -> str:
        """An [H, W, 3] panel in [0, 1] (numpy or a tensor) as
        ``<log_dir>/<tag>/<step:06d>.png``; returns its path."""
        from PIL import Image
        if hasattr(img, "detach"):
            img = img.detach().cpu().numpy()
        arr = (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)
        path = os.path.join(self.log_dir, tag, f"{step:06d}.png")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(arr).save(path)
        return path

    def close(self) -> None:
        self.jsonl.close()


class profile_trace:
    """A ``torch.profiler`` trace of the block, CPU and (on a card) CUDA
    activity, written as a Chrome trace to
    ``<log_dir>/profile/trace.json`` (open it in Perfetto or
    ``chrome://tracing``)::

        with profile_trace(os.path.join(model_path, "logs")):
            for _ in range(3):
                step(...)

    While it collects, the port's own ranges (``streetunveiler_torch.
    trace``) are in the trace: a step's ``train.forward``,
    ``train.backward`` and ``train.update``; inside them ``raster.sh``,
    ``raster.preprocess``, ``raster.gather``, ``raster.blend_fwd``,
    ``raster.finalize``, ``sky.forward``, ``loss``, ``raster.blend_bwd``,
    ``raster.record_scatter`` and ``sky.backward``; the binning's
    ``train.bin`` with ``bin.preprocess``, ``bin.cull``,
    ``bin.depth_sort``, ``bin.expand`` and ``bin.tile_sort``; the loop's
    ``train.start`` and ``train.iteration``; the render CLI's ``view``.

    Prints the path it wrote, or why there is no trace when the profiler
    cannot start.
    """

    def __init__(self, log_dir: str):
        self.dir = os.path.join(log_dir, "profile")
        self.path = os.path.join(self.dir, "trace.json")
        self.prof = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        try:
            os.makedirs(self.dir, exist_ok=True)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        except Exception as e:      # a backend without profiler support
            self.prof = None
            print(f"profiler trace unavailable ({e})")
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            import torch
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.__exit__(*exc)
            self.prof.export_chrome_trace(self.path)
            print(f"wrote profiler trace to {self.path}")
        return False
