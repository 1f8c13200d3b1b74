"""Carry surfel weights from the JAX package into the port.

``state_from_arrays`` turns the leaves of a JAX ``SurfelState`` — given
as numpy arrays — into the port's ``SurfelState`` on a device. It accepts
plain field names (``xyz``, ``semantics``, …), pytree paths
(``.params.xyz``) and the keys the JAX training checkpoint writes into
``splatting.npz``: the prefix ``state`` followed by the leaf path
(``state.params.xyz``, ``state.alive``, …).
``load_checkpoint_state`` reads such a checkpoint directly.

``sky_from_arrays`` does the same for the JAX ``SkyParams`` leaves: bare
(``hash_tables``, ``mlp_w[0]``, …), as pytree paths (``.mlp_w[0]``) or
under the checkpoint's ``sky`` prefix (``sky.hash_tables``, …); the
weights keep their ``[in, out]`` layout. ``train.checkpoint`` reads the
sky of a JAX ``splatting.npz`` through it.
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
from .models.sky import SkyParams

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


def sky_from_arrays(arrays: Mapping[str, np.ndarray], device="cuda",
                    prefix: str = "sky") -> SkyParams:
    """Port ``SkyParams`` from JAX ``SkyParams`` leaves (``prefix=""`` for
    bare leaf names). ``num_levels`` and ``sh_bands`` (static in the JAX
    pytree) follow from the shapes; ``base_res`` and ``growth`` are not
    in the leaves and keep the ``SkyParams`` defaults, the JAX package's."""
    dev = resolve_device(device)
    leaves = {}
    for key, val in arrays.items():
        if prefix:
            if not key.startswith(prefix + "."):
                continue
            key = key[len(prefix):]
        leaves[key.lstrip(".")] = val
    if "hash_tables" not in leaves or "mlp_w[0]" not in leaves:
        raise KeyError(f"SkyParams leaves missing under {prefix!r}: "
                       f"{sorted(leaves)}")
    tensor = lambda a: torch.as_tensor(np.array(a), dtype=torch.float32,
                                       device=dev)
    n_layers = sum(1 for k in leaves if k.startswith("mlp_w["))
    tables = tensor(leaves["hash_tables"])
    ws = tuple(tensor(leaves[f"mlp_w[{i}]"]) for i in range(n_layers))
    bs = tuple(tensor(leaves[f"mlp_b[{i}]"]) for i in range(n_layers))
    n_dir = ws[0].shape[0] - tables.shape[0] * tables.shape[2] - 63
    sh_bands = math.isqrt(n_dir) - 1
    if (sh_bands + 1) ** 2 != n_dir:
        raise ValueError(f"{n_dir} direction features is not a square")
    return SkyParams(hash_tables=tables, mlp_w=ws, mlp_b=bs,
                     num_levels=tables.shape[0], sh_bands=sh_bands)
