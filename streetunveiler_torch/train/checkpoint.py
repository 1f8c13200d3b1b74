"""Resumable training checkpoints (counterpart of ``streetunveiler_tpu/
train/checkpoint.py``): ``<dir>/splatting.npz`` in the JAX package's
layout — ``iteration``, the ``SurfelState`` leaves under ``state.``
(``state.params.xyz``, ``state.alive``, …), the Adam state under ``opt.``
(``opt.step``, ``opt.mu.xyz``, ``opt.nu.xyz``, …) and, when a sky is
trained, its parameters under ``sky`` (``sky.hash_tables``,
``sky.mlp_w[0]``, …, ``sky.mlp_b[0]``, …) and its Adam state under
``skyopt`` (``skyopt.step``, ``skyopt.mu.hash_tables``, …) — so a
checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..convert import sky_from_arrays, state_from_arrays
from ..device import resolve_device
from ..models.gaussians import SurfelParams, SurfelState
from ..models.sky import SkyParams
from .optim import AdamState

_STATE_LEAVES = ("semantics", "alive", "max_radii2d", "grad_accum", "denom",
                 "spatial_scale")
_PARAMS = tuple(f.name for f in dataclasses.fields(SurfelParams))


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_checkpoint(path: str, state: SurfelState, opt_state: AdamState,
                    iteration: int, sky_params: SkyParams | None = None,
                    sky_opt_state: AdamState | None = None) -> None:
    """Write ``<path>/splatting.npz`` for an exact resume."""
    os.makedirs(path, exist_ok=True)
    blob = {"iteration": np.asarray(iteration)}
    for name in _PARAMS:
        blob[f"state.params.{name}"] = _host(getattr(state.params, name))
        blob[f"opt.mu.{name}"] = _host(getattr(opt_state.mu, name))
        blob[f"opt.nu.{name}"] = _host(getattr(opt_state.nu, name))
    for name in _STATE_LEAVES:
        blob[f"state.{name}"] = _host(getattr(state, name))
    blob["opt.step"] = np.asarray(opt_state.step, np.int32)
    if sky_params is not None:
        for key, t in sky_params.named_tensors().items():
            blob["sky" + key] = _host(t)
    if sky_opt_state is not None:
        blob["skyopt.step"] = np.asarray(sky_opt_state.step, np.int32)
        for part in ("mu", "nu"):
            for key, t in getattr(sky_opt_state, part).named_tensors().items():
                blob[f"skyopt.{part}{key}"] = _host(t)
    np.savez(os.path.join(path, "splatting.npz"), **blob)


def _read(path: str) -> dict:
    with np.load(os.path.join(path, "splatting.npz")) as blob:
        return {k: blob[k] for k in blob.files}


def _sky(arrays: dict, dev):
    """(sky_params, sky_opt_state) of a checkpoint's arrays, each None
    where the checkpoint has none."""
    if not any(k.startswith("sky.") for k in arrays):
        return None, None
    sky = sky_from_arrays(arrays, device=dev)
    if "skyopt.step" not in arrays:
        return sky, None
    moments = [sky_from_arrays(arrays, device=dev, prefix=f"skyopt.{part}")
               for part in ("mu", "nu")]
    return sky, AdamState(step=int(arrays["skyopt.step"]), mu=moments[0],
                          nu=moments[1])


def load_checkpoint(path: str, device="cuda"):
    """Read ``<path>/splatting.npz`` (either package's) onto ``device``.
    Returns (state, opt_state, iteration, sky_params, sky_opt_state), the
    last two None where the checkpoint has no sky or no sky optimizer
    state."""
    dev = resolve_device(device)
    arrays = _read(path)
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
    return (state, opt_state, int(arrays["iteration"])) + _sky(arrays, dev)


def load_sky_for_iteration(model_path: str, iteration: int,
                           device="cuda") -> SkyParams | None:
    """The sky of ``<model_path>/checkpoint/iteration_N``, or None when
    that checkpoint does not exist or holds no sky (for compositing at
    render time)."""
    ckpt = os.path.join(model_path, "checkpoint", f"iteration_{iteration}")
    if not os.path.exists(os.path.join(ckpt, "splatting.npz")):
        return None
    return _sky(_read(ckpt), resolve_device(device))[0]
