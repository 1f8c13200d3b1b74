"""Inpainter interface (counterpart of ``streetunveiler_tpu/pipeline/
inpaint.py``): external 2D inpainting models as services on the host.

* ``Inpainter`` protocol: ``inpaint(image, mask, reference=None)``;
  image/reference [H, W, 3] float in [0, 1], mask [H, W] bool (True =
  fill), numpy in and out.
* ``DiffuseFillInpainter`` smoothly diffuses the border colours into the
  hole (Jacobi iterations of Laplace's equation), on ``device``. It keeps
  the whole unveil pipeline runnable and testable without model weights.
* ``TorchScriptInpainter`` adapts a callable or TorchScript module (how the
  real models plug in on a host that has their weights).
* ``DirectoryInpainter`` is the out-of-band file-exchange protocol: each
  request is written as image/mask(/reference) PNGs, and the result PNG
  is polled for, so the real models can run on another host that watches
  the directory.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Protocol

import numpy as np
import torch


class Inpainter(Protocol):
    def inpaint(self, image: np.ndarray, mask: np.ndarray,
                reference: Optional[np.ndarray] = None) -> np.ndarray:
        ...


class DiffuseFillInpainter:
    """Smooth diffusion fill: Jacobi relaxation of Laplace's equation with
    the known pixels as the boundary. With a ``reference`` the hole starts
    from a blend of it and the known pixels' mean (keeping successive
    frames consistent). The iterations run on ``device``; the known
    pixels' mean is taken with numpy, and each step's neighbour sum
    ``0.25·(((down + up) + right) + left)`` over an edge-clamped pad is
    added in numpy's order, so the result is bit for bit numpy's."""

    def __init__(self, iterations: int = 300, reference_weight: float = 0.5,
                 device="cuda"):
        from ..device import resolve_device
        self.iterations = iterations
        self.reference_weight = reference_weight
        self.device = resolve_device(device)

    @torch.no_grad()
    def inpaint(self, image, mask, reference=None):
        img = np.array(image, np.float32, copy=True)
        m = np.asarray(mask, bool)
        if not m.any():
            return img
        fill = img.copy()
        if reference is not None:
            fill[m] = (self.reference_weight * np.asarray(reference)[m]
                       + (1 - self.reference_weight)
                       * img[~m].mean(axis=0, keepdims=True))
        else:
            fill[m] = img[~m].mean(axis=0, keepdims=True)
        x = torch.as_tensor(fill, device=self.device)
        mt = torch.as_tensor(m, device=self.device)[..., None]
        for _ in range(self.iterations):
            # edge-clamped neighbours (a roll would wrap colours from the
            # opposite border into holes that touch an edge)
            p = torch.nn.functional.pad(x.permute(2, 0, 1)[None],
                                        (1, 1, 1, 1), mode="replicate"
                                        )[0].permute(1, 2, 0)
            avg = 0.25 * (p[2:, 1:-1] + p[:-2, 1:-1]
                          + p[1:-1, 2:] + p[1:-1, :-2])
            x = torch.where(mt, avg, x)
        return np.clip(x.cpu().numpy(), 0.0, 1.0)


class DirectoryInpainter:
    """File-exchange inpainter: requests under ``<root>/requests/``,
    results under ``<root>/results/``.

    Request k is the file set ``{k:06d}_image.png``, ``{k:06d}_mask.png``,
    optionally ``{k:06d}_reference.png``, plus ``{k:06d}.json`` metadata
    written LAST (the worker's ready signal). The worker answers with
    ``results/{k:06d}.png``. On timeout the ``fallback`` inpainter answers
    (TimeoutError without one), so the pipeline completes when no worker
    is attached.
    """

    def __init__(self, root: str, poll_interval: float = 0.5,
                 timeout: float = 600.0, fallback: Optional[Inpainter] = None):
        self.root = root
        self.requests = os.path.join(root, "requests")
        self.results = os.path.join(root, "results")
        os.makedirs(self.requests, exist_ok=True)
        os.makedirs(self.results, exist_ok=True)
        self.poll_interval = poll_interval
        self.timeout = timeout
        self.fallback = fallback
        self.seq = 0

    @staticmethod
    def _write_png(path, arr):
        from PIL import Image
        a = np.asarray(arr)
        if a.dtype != np.uint8:
            a = (np.clip(a.astype(np.float32), 0, 1) * 255).astype(np.uint8)
        Image.fromarray(a).save(path)

    @staticmethod
    def _read_png(path):
        from PIL import Image
        return np.asarray(Image.open(path).convert("RGB"),
                          np.float32) / 255.0

    def inpaint(self, image, mask, reference=None):
        k = self.seq
        self.seq += 1
        stem = os.path.join(self.requests, f"{k:06d}")
        self._write_png(stem + "_image.png", image)
        self._write_png(stem + "_mask.png",
                        np.asarray(mask, bool).astype(np.uint8) * 255)
        meta = {"id": k, "mode": "inpaint"}
        if reference is not None:
            self._write_png(stem + "_reference.png", reference)
            meta["mode"] = "reference_guided"
        tmp = stem + ".json.tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, stem + ".json")   # atomic ready signal

        result = os.path.join(self.results, f"{k:06d}.png")
        deadline = time.monotonic() + self.timeout
        while time.monotonic() < deadline:
            if os.path.exists(result):
                # the worker may still be writing; retry a partial file
                try:
                    return np.clip(self._read_png(result), 0.0, 1.0)
                except OSError:
                    pass
            time.sleep(self.poll_interval)
        if self.fallback is not None:
            return self.fallback.inpaint(image, mask, reference=reference)
        raise TimeoutError(
            f"no inpaint worker answered request {k} under {self.root} "
            f"within {self.timeout}s (attach a worker that reads "
            f"requests/ and writes results/, or pass a fallback)")


class TorchScriptInpainter:
    """Adapter for an external model callable(image, mask, reference),
    e.g. a TorchScript module. The callable owns device placement; this
    class only normalizes dtypes and layout."""

    def __init__(self, fn):
        self.fn = fn

    def inpaint(self, image, mask, reference=None):
        out = self.fn(np.asarray(image, np.float32),
                      np.asarray(mask, bool),
                      None if reference is None
                      else np.asarray(reference, np.float32))
        if torch.is_tensor(out):
            out = out.detach().cpu().numpy()
        return np.clip(np.asarray(out, np.float32), 0.0, 1.0)
