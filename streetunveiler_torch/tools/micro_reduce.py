"""Lane-reduction probe (T3): the ways a [512, 128] block's k weighted row
sums can be taken, timed on the card.

Counterpart of ``tools/micro_reduce.py`` (its Pallas kernel, ``build``
:37, is launched at :70), as the kernel ``csrc/micro_reduce.cu``. The
same function: x is [512, NV·128] f32 and per 128-column block v
``out[p, i] += Σ_s x[p, 128v + s]·(1 + 0.01 i)`` for i < k, the other
columns zero; mode ``pair`` runs the 25-step chain y = 1.0001·y + 0.001
on every element and sums it into column 0. Modes (the TPU's in
brackets): ``pair`` (pair), ``thread`` (vpu: one thread per row, as K1
sums), ``warp`` (vpu: a warp per row with shuffle sums, as K2 sums),
``mma`` (mxu at Precision.DEFAULT: one tensor-core product per block,
bf16 operands, f32 accumulation).

``micro_reduce`` runs the plain PyTorch version on a CPU tensor and the
kernel on a CUDA tensor. Run on the card: ``python -m
streetunveiler_torch.tools.micro_reduce [--device cuda]`` times every
(mode, k) of the TPU tool at NV = 4096 (1.07 GB, drawn from a seed on the
device) and prints ms and ns per block; ``--device cpu --nv 8`` checks the
plain versions only.
"""

from __future__ import annotations

import argparse
import json

import torch

from streetunveiler_torch.ops.rasterizer import cuda_lib

P, S = 512, 128
NV = 4096
NSPLIT = 128          # slices the blocks are split over on the card
MODES = (("pair", 0), ("thread", 4), ("thread", 8), ("thread", 13),
         ("warp", 4), ("warp", 8), ("warp", 13), ("mma", 8), ("mma", 13))
MODE_INDEX = {"pair": 0, "thread": 1, "warp": 2, "mma": 3}
PRECISION = {"pair": "f32", "thread": "f32", "warp": "f32",
             "mma": "bf16 operands, f32 accumulation, one pass"}


def weights(k: int, device="cpu"):
    """The TPU tool's weights 1 + 0.01·i, rounded to f32 from double."""
    return torch.tensor([1.0 + 0.01 * i for i in range(k)],
                        dtype=torch.float64, device=device).float()


def _check_mode(mode, k):
    if (mode, k) not in MODES:
        raise ValueError(f"(mode, k) must be one of {MODES}, got "
                         f"({mode!r}, {k})")


def micro_reduce_plain(mode: str, k: int, x):
    """Plain PyTorch version: x [512, nv·128] → out [512, 128]. The ``mma``
    mode rounds x and the weights to bf16 first, as its kernel does."""
    _check_mode(mode, k)
    nv = x.shape[1] // S
    out = torch.zeros((P, S), dtype=torch.float32, device=x.device)
    if mode == "pair":
        y = x
        for _ in range(25):
            y = y * 1.0001 + 0.001
        out[:, 0] = y.view(P, nv, S).sum(-1).sum(-1)
        return out
    c = weights(k, x.device)
    xb = x.view(P, nv, S)
    if mode == "mma":
        xb = xb.bfloat16().float()
        c = c.bfloat16().float()
    for i in range(k):
        out[:, i] = (xb * c[i]).sum(-1).sum(-1)
    return out


def micro_reduce_library(k: int, x):
    """One PyTorch reduction computing the same sums: the row sums of
    ``x.view(512, NV, 128)`` times the weights (timed as a yardstick)."""
    nv = x.shape[1] // S
    return x.view(P, nv, S).sum(-1).sum(-1)[:, None] * weights(k, x.device)


def micro_reduce_cuda(mode: str, k: int, x):
    """Launch the T3 kernel (``csrc/micro_reduce.cu``) on the current
    stream."""
    _check_mode(mode, k)
    if x.device.type != "cuda" or x.dtype != torch.float32 \
            or not x.is_contiguous() or x.dim() != 2 or x.shape[0] != P \
            or x.shape[1] % S:
        raise ValueError("x must be a contiguous float32 CUDA tensor "
                         f"[{P}, nv·{S}], got {tuple(x.shape)} {x.dtype} "
                         f"on {x.device}")
    nv = x.shape[1] // S
    nsplit = NSPLIT if nv % NSPLIT == 0 else nv
    lib = cuda_lib.load_library()
    partial = torch.empty((nsplit, P, 16), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((P, S), dtype=torch.float32, device=x.device)
    index = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    rc = lib.su_micro_reduce(MODE_INDEX[mode], k, x.data_ptr(), nv, nsplit,
                             partial.data_ptr(), out.data_ptr(), index,
                             torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(rc, f"micro_reduce {mode} launch")
    cuda_lib.launch_counts["micro_reduce"] += 1
    return out


def micro_reduce(mode: str, k: int, x):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    fn = micro_reduce_plain if x.device.type == "cpu" else micro_reduce_cuda
    return fn(mode, k, x)


def make_input(nv: int = NV, seed: int = 0, device="cuda"):
    """x [512, nv·128] uniform in [0, 1) from ``seed``, drawn on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((P, nv * S), generator=gen, device=device)


def main(argv=None):
    from streetunveiler_torch.tools import timing
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nv", type=int, default=NV)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    cpu = torch.device(args.device).type == "cpu"
    if not cpu:
        timing.require_cuda(args.device)
        print(timing.card(), flush=True)
    x = make_input(args.nv, device=args.device)
    for mode, k in MODES:
        out = micro_reduce(mode, k, x)
        line = dict(mode=mode, k=k, nv=args.nv, precision=PRECISION[mode],
                    checksum=float(out.sum()))
        if not cpu:
            ms = timing.median_ms(lambda: micro_reduce_cuda(mode, k, x),
                                  args.reps)
            line.update(ms=ms, ns_per_block=ms * 1e6 / args.nv)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
