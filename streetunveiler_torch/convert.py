"""Carry surfel weights from the JAX package into the port.

``state_from_arrays`` turns the leaves of a JAX ``SurfelState`` — given
as numpy arrays — into the port's ``SurfelState`` on a device. It accepts
plain field names (``xyz``, ``semantics``, …), pytree paths
(``.params.xyz``) and the keys the JAX training checkpoint writes into
``splatting.npz``: the prefix ``state`` followed by the leaf path
(``state.params.xyz``, ``state.alive``, …).
``load_checkpoint_state`` reads such a checkpoint directly.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Mapping

import numpy as np
import torch

from .device import resolve_device
from .models.gaussians import SurfelParams, SurfelState

_PARAM_FIELDS = tuple(f.name for f in dataclasses.fields(SurfelParams))
_STATE_FIELDS = ("semantics", "alive", "max_radii2d", "grad_accum", "denom",
                 "spatial_scale")
_DTYPES = {"semantics": torch.int32, "alive": torch.bool}


def _leaf_name(key: str, prefix: str) -> str:
    if key.startswith(prefix):
        key = key[len(prefix):]
    key = key.lstrip(".")
    if key.startswith("params."):
        key = key[len("params."):]
    return key


def state_from_arrays(arrays: Mapping[str, np.ndarray], device="cuda",
                      prefix: str = "state") -> SurfelState:
    """Port ``SurfelState`` from JAX ``SurfelState`` leaves.

    ``sh_degree`` (static in the JAX pytree, so never a leaf) follows from
    the number of SH bases in ``features_dc`` + ``features_rest``."""
    dev = resolve_device(device)
    leaves = {}
    for key, val in arrays.items():
        name = _leaf_name(key, prefix)
        if name in _PARAM_FIELDS or name in _STATE_FIELDS:
            leaves[name] = val
    missing = [f for f in _PARAM_FIELDS + _STATE_FIELDS if f not in leaves]
    if missing:
        raise KeyError(f"SurfelState leaves missing: {missing}")

    def tensor(name):
        val = np.array(leaves[name])          # a writable copy
        return torch.as_tensor(val, dtype=_DTYPES.get(name, torch.float32),
                               device=dev)

    n_bases = 1 + leaves["features_rest"].shape[1]
    sh_degree = math.isqrt(n_bases) - 1
    if (sh_degree + 1) ** 2 != n_bases:
        raise ValueError(f"{n_bases} SH bases is not a square")
    params = SurfelParams(**{f: tensor(f) for f in _PARAM_FIELDS})
    return SurfelState(params=params,
                       **{f: tensor(f) for f in _STATE_FIELDS},
                       sh_degree=sh_degree)


def load_checkpoint_state(path: str, device="cuda") -> SurfelState:
    """The surfel state of a JAX training checkpoint: ``path`` is the
    checkpoint directory (holding ``splatting.npz``) or the file itself."""
    if os.path.isdir(path):
        path = os.path.join(path, "splatting.npz")
    with np.load(path) as blob:
        return state_from_arrays({k: blob[k] for k in blob.files
                                  if k.startswith("state")}, device=device)
