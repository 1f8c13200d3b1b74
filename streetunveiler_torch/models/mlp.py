"""Small MLP library (counterpart of ``streetunveiler_tpu/models/mlp.py``):
``init_mlp``/``apply_mlp`` with depth, width, skip connections, hidden and
output activations and a SIREN-style sine initialisation. Weights keep the
JAX package's ``[in, out]`` layout (``h @ w + b``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from ..device import resolve_device

_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softplus": F.softplus,
    "sine": torch.sin,
    "none": lambda x: x,
}


@dataclasses.dataclass(frozen=True)
class MLPParams:
    weights: tuple               # [in, out] each
    biases: tuple                # [out] each
    skips: tuple = ()
    activation: str = "relu"
    output_activation: str = "none"


def init_mlp(generator: torch.Generator | None, in_dim: int, out_dim: int,
             depth: int = 3, width: int = 64, skips: Sequence[int] = (),
             activation: str = "relu", output_activation: str = "none",
             device="cuda") -> MLPParams:
    """``depth`` hidden layers of ``width`` and an output layer, drawn on
    the CPU from ``generator`` and moved to ``device``; ``skips``: hidden
    layer indices whose input is concat(input, h)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dims = [in_dim] + [width] * depth + [out_dim]
    ws, bs = [], []
    for i in range(len(dims) - 1):
        d_in = dims[i] + (in_dim if i in skips and i > 0 else 0)
        shape = (d_in, dims[i + 1])
        if activation == "sine":
            bound = 1.0 / d_in if i == 0 else math.sqrt(6.0 / d_in) / 30.0
            w = (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound
        else:
            w = torch.randn(shape, generator=generator) * math.sqrt(
                2.0 / d_in)
        ws.append(w.to(dev))
        bs.append(torch.zeros(dims[i + 1], device=dev))
    return MLPParams(weights=tuple(ws), biases=tuple(bs), skips=tuple(skips),
                     activation=activation,
                     output_activation=output_activation)


def apply_mlp(params: MLPParams, x):
    act = _ACTS[params.activation]
    out_act = _ACTS[params.output_activation]
    h = x
    n = len(params.weights)
    for i, (w, b) in enumerate(zip(params.weights, params.biases)):
        if i in params.skips and i > 0:
            h = torch.cat([x, h], dim=-1)
        pre = h @ w + b
        if params.activation == "sine" and i < n - 1:
            pre = pre * 30.0
        h = out_act(pre) if i == n - 1 else act(pre)
    return h
