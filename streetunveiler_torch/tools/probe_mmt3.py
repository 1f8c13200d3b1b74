"""Split-precision contraction probe (T9): is a [512, 128] × [7, 128]ᵀ
contraction from three bf16 tensor-core passes on hi/lo splits faithful
to an f32 lane reduction? Checked and timed on the card.

Counterpart of ``tools/probe_mmt3.py``, whose Pallas kernel ``kern``
(:30, launched at :56) becomes ``csrc/mmt3.cu``. The same function: w
[512, 128] and b [8, 128] (row 7 zero) uniform in [0, 1) from
``default_rng(0)``, four outputs [512, 7]:

* ``t``, the truth: Σ_s w[p, s]·b[k, s] in f32;
* ``a`` = ``mmT3(w, b[:7])``, ``b`` = ``mmT3(w, b)[:, :7]``, ``c`` the
  same on bᵀ [128, 8] in the standard form, where ``mmT3`` (the JAX
  package's ``_mmT3``, ``kernel.py:155-168``) is hi·hi + (hi·lo + lo·hi):
  hi = ``hi8(x)``, the top 16 bits by mask (exactly bf16), lo = x − hi,
  each product one DEFAULT pass, whose operands are rounded to bf16 to
  nearest even and whose sums are f32. The lo·lo term is dropped (≤ 2⁻¹⁴
  relative).

On the card the three ways are ``mma.sync`` m16n8k16 bf16 products with
f32 accumulation that differ only in where b comes from: (a) 7 rows with
the 8th fragment column a zero in registers, (b) the 8 rows from memory,
(c) bᵀ staged in shared memory and read in the col-major fragment layout.

The kernel has two designs with the same outputs bit for bit:
``redesign`` (the default, ``csrc/mmt3_sm90.cuh``: seven warps a block of
16 rows, a way a warp and one truth sum a thread of the other four, every
operand from shared memory) and ``first`` (``csrc/mmt3.cu``: one warp a
block).

``mmt3`` runs the plain PyTorch version on CPU tensors and the kernel on
CUDA tensors. Run on the card: ``python -m
streetunveiler_torch.tools.probe_mmt3 [--device cuda] [--design first]``
prints each way's largest error relative to the truth's largest value, as
the tool does.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from streetunveiler_torch import trace
from streetunveiler_torch.ops.rasterizer import cuda_lib

P, S, Q = 512, 128, 7
WAYS = ("a_mmT3_q7", "b_mmT3_pad8", "c_transpose_mm")
DESIGNS = ("redesign", "first")


def make_inputs(device="cuda"):
    """The tool's w [512, 128] and b [8, 128] (row 7 zero), f32."""
    rng = np.random.default_rng(0)
    w = rng.uniform(0, 1, (P, S))
    b = np.concatenate([rng.uniform(0, 1, (Q, S)), np.zeros((1, S))])
    return (torch.as_tensor(w.astype(np.float32), device=device),
            torch.as_tensor(b.astype(np.float32), device=device))


def hi8(x):
    """The top 16 bits of f32 x by mask: exactly bf16-representable."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def _bf16(x):
    return x.bfloat16().float()


def _dot_t(x, y):
    """x [m, s] · y [n, s]ᵀ as one DEFAULT pass: operands rounded to bf16
    (products exact in f32), sums in f32."""
    return (_bf16(x)[:, None, :] * _bf16(y)[None]).sum(-1)


def mmT3(a, b):
    """[m, s] × [n, s] → [m, n] from three DEFAULT passes on hi/lo splits
    of both operands (the lo·lo term dropped)."""
    ah, bh = hi8(a), hi8(b)
    return _dot_t(ah, bh) + (_dot_t(ah, b - bh) + _dot_t(a - ah, bh))


def _check(w, b):
    if w.shape != (P, S) or b.shape != (Q + 1, S) \
            or w.dtype != torch.float32 or b.dtype != torch.float32 \
            or w.device != b.device:
        raise ValueError(f"w must be float32 [{P}, {S}] and b float32 "
                         f"[{Q + 1}, {S}] on one device, got "
                         f"{tuple(w.shape)} {tuple(b.shape)}")


def mmt3_plain(w, b):
    """Plain PyTorch version: (a, b, c, t), each [512, 7] f32."""
    _check(w, b)
    bq = b[:Q]
    t = (w[:, None, :] * bq[None]).sum(-1)
    bt = b.T                          # [S, 8]; the standard form x @ y
    ah, bh = hi8(w), hi8(bt)
    c = (_dot_t(ah, bh.T) + (_dot_t(ah, (bt - bh).T)
                             + _dot_t(w - ah, bh.T)))[:, :Q]
    return mmT3(w, bq), mmT3(w, b)[:, :Q], c, t


def mmt3_library(w, b):
    """One PyTorch call computing the contraction (the yardstick; f32 with
    TF32 off)."""
    return torch.matmul(w, b[:Q].T)


def mmt3_cuda(w, b, design: str = "redesign"):
    """Launch the T9 kernel on the current stream: its ``redesign``
    (``csrc/mmt3_sm90.cuh``) or its ``first`` design (``csrc/mmt3.cu``)."""
    _check(w, b)
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {DESIGNS}, got {design!r}")
    if w.device.type != "cuda" or not (w.is_contiguous()
                                       and b.is_contiguous()):
        raise ValueError("w and b must be contiguous CUDA tensors, got "
                         f"{w.device}")
    lib = cuda_lib.load_library()
    outs = [torch.empty((P, Q), dtype=torch.float32, device=w.device)
            for _ in range(4)]
    index = w.device.index if w.device.index is not None \
        else torch.cuda.current_device()
    entry = lib.su_mmt3 if design == "redesign" else lib.su_mmt3_first
    rc = entry(w.data_ptr(), b.data_ptr(), *[o.data_ptr() for o in outs],
               index, torch.cuda.current_stream(w.device).cuda_stream)
    cuda_lib.check(rc, f"mmt3 ({design}) launch")
    trace.launch_counts["mmt3"] += 1
    return tuple(outs)


def mmt3(w, b, design: str = "redesign"):
    """The kernel (``design``) on CUDA tensors, the plain version on CPU
    tensors."""
    if w.device.type == "cpu":
        return mmt3_plain(w, b)
    return mmt3_cuda(w, b, design)


def truth_errors(outs):
    """Each way's largest error relative to the truth's largest value."""
    t = outs[3]
    scale = float(t.abs().max())
    return {name: float((x - t).abs().max()) / scale
            for name, x in zip(WAYS, outs[:3])}


def run(w, b, reps=10, design="redesign"):
    """The contraction once through ``mmt3``, then, on the card and with
    ``reps`` > 0, the kernel timed (median of ``reps`` CUDA-event times).
    Returns a dict with the outputs (``out``) and each way's error against
    the truth."""
    from streetunveiler_torch.tools import timing
    outs = mmt3(w, b, design)
    line = dict(device=str(w.device), max_rel_err_vs_truth=truth_errors(outs),
                out=outs)
    if w.device.type == "cuda" and reps > 0:
        line.update(design=design, ms=timing.median_ms(
            lambda: mmt3_cuda(w, b, design), reps))
    return line


def main(argv=None):
    from streetunveiler_torch.tools import timing
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--design", choices=DESIGNS, default="redesign",
                    help="the kernel's design on the card")
    args = ap.parse_args(argv)
    if torch.device(args.device).type != "cpu":
        timing.require_cuda(args.device)
        print(timing.card(), flush=True)
    line = run(*make_inputs(args.device), args.reps, args.design)
    line.pop("out")
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
