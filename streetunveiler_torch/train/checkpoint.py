"""Resumable training checkpoints (counterpart of ``streetunveiler_tpu/
train/checkpoint.py``): ``<dir>/splatting.npz`` in the JAX package's
layout — ``iteration``, the ``SurfelState`` leaves under ``state.``
(``state.params.xyz``, ``state.alive``, …) and the Adam state under
``opt.`` (``opt.step``, ``opt.mu.xyz``, ``opt.nu.xyz``, …) — so a
checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..convert import state_from_arrays
from ..device import resolve_device
from ..models.gaussians import SurfelParams, SurfelState
from .optim import AdamState

_STATE_LEAVES = ("semantics", "alive", "max_radii2d", "grad_accum", "denom",
                 "spatial_scale")
_PARAMS = tuple(f.name for f in dataclasses.fields(SurfelParams))


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_checkpoint(path: str, state: SurfelState, opt_state: AdamState,
                    iteration: int, sky_params=None,
                    sky_opt_state=None) -> None:
    """Write ``<path>/splatting.npz`` for an exact resume."""
    if sky_params is not None or sky_opt_state is not None:
        raise NotImplementedError(
            "the sky model is not ported to the PyTorch build yet: it "
            "comes with the sky slice, item 10 (ROADMAP.md)")
    os.makedirs(path, exist_ok=True)
    blob = {"iteration": np.asarray(iteration)}
    for name in _PARAMS:
        blob[f"state.params.{name}"] = _host(getattr(state.params, name))
        blob[f"opt.mu.{name}"] = _host(getattr(opt_state.mu, name))
        blob[f"opt.nu.{name}"] = _host(getattr(opt_state.nu, name))
    for name in _STATE_LEAVES:
        blob[f"state.{name}"] = _host(getattr(state, name))
    blob["opt.step"] = np.asarray(opt_state.step, np.int32)
    np.savez(os.path.join(path, "splatting.npz"), **blob)


def load_checkpoint(path: str, device="cuda"):
    """Read ``<path>/splatting.npz`` (either package's) onto ``device``.
    Returns (state, opt_state, iteration)."""
    dev = resolve_device(device)
    with np.load(os.path.join(path, "splatting.npz")) as blob:
        arrays = {k: blob[k] for k in blob.files}
    state = state_from_arrays({k: v for k, v in arrays.items()
                               if k.startswith("state.")}, device=dev)

    def moments(prefix):
        missing = [n for n in _PARAMS if f"{prefix}.{n}" not in arrays]
        if missing:
            raise KeyError(f"checkpoint missing {prefix} leaves {missing}")
        return SurfelParams(**{n: torch.as_tensor(
            np.array(arrays[f"{prefix}.{n}"]), dtype=torch.float32,
            device=dev) for n in _PARAMS})

    opt_state = AdamState(step=int(arrays["opt.step"]),
                          mu=moments("opt.mu"), nu=moments("opt.nu"))
    return state, opt_state, int(arrays["iteration"])
