"""Prefix-sum probe (T4): the ways the blend's transmittance and running
moments can be taken as lane prefix sums, timed on the card.

Counterpart of ``tools/micro_prefix.py`` (its Pallas kernel is the closure
``kern`` :43-102 inside ``main``, launched at :105), as the kernel
``csrc/micro_prefix.cu``. The same function (micro_prefix.py:50-102): rec
is [24, NCHUNK·128] f32 (rows 0-2 are read), chunk c adds into tile
c // 66 of out [NCHUNK/66, 512, 16]; per pixel ``sub`` and lane s a fake
pair (u, v, α, w0 = α > 1e-3 ? α : 0), the exclusive lane prefix sums of
log1p(−w0), w0, w0·u and w0·u², T = exp(prefix of log1p(−w0)),
w = w0·T, and the chunk adds (Σw, Σw·u, Σw·(u²·A + M2 − 2u·M1), Σw·v,
then Σw·T twelve times). Modes (the TPU's in brackets): ``serial`` (a
thread per pixel with running sums, as K1 composites), ``warpscan``
(roll: Hillis-Steele warp shuffles), ``mma_bf16`` (default: the
triangular product on tensor cores in bf16, one pass), ``mma_bf16x2``
(split2: log1p(−w0) as bf16 hi + lo, two passes), ``mma_3xtf32``
(highest: tf32 hi + lo; the 0/1 triangle is exact, so two passes).

``micro_prefix`` runs the plain PyTorch version on a CPU tensor and the
kernel on a CUDA tensor. Run on the card: ``python -m
streetunveiler_torch.tools.micro_prefix [--device cuda]`` times every mode
at NCHUNK = 16896 (rec from a seed on the device) and prints ms and ns
per chunk; ``--device cpu --chunks 132`` checks the plain versions only.
"""

from __future__ import annotations

import argparse
import json

import torch

from streetunveiler_torch.ops.rasterizer import cuda_lib

P, S, REC = 512, 128, 24
NCHUNK = 16896
CPT = 66                # chunks per tile (the TPU tool's fixed 66)
MODES = ("serial", "warpscan", "mma_bf16", "mma_bf16x2", "mma_3xtf32")
PRECISION = {"serial": "f32", "warpscan": "f32",
             "mma_bf16": "bf16 operands, one pass, f32 accumulation",
             "mma_bf16x2": "log1p(-w0) as bf16 hi + lo (two passes), the "
                           "rest bf16 one pass, f32 accumulation",
             "mma_3xtf32": "tf32 hi + lo (two passes: the 0/1 triangle is "
                           "exact), f32 accumulation"}


def _bf16(x):
    return x.bfloat16().float()


def _excl(x):
    """Exclusive prefix sum along the last axis."""
    c = torch.cumsum(x, dim=-1)
    return torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], dim=-1)


def _pair_values(r, sub):
    """The fake pair of micro_prefix.py:53-66 for rows r [3, B, 1, S] and
    pixels sub [P, 1]: (u, v, w0, log1p(−w0)), each [B, P, S]."""
    r1, r2, r3 = r[0], r[1], r[2]
    a_ = r1 - sub * r3
    b_ = r2 - sub * r3
    kx = a_ * b_ - r3
    ky = b_ * r1 - a_
    kz = a_ * r2 - b_ * r1
    kzs = torch.where(kz.abs() < 1e-12, torch.full_like(kz, 1e-12), kz)
    u = kx / kzs
    v = ky / kzs
    rho = u * u + v * v
    alpha = torch.clamp(torch.exp(-0.5 * rho), max=0.99)
    w0 = torch.where(alpha > 1e-3, alpha, torch.zeros_like(alpha))
    return u, v, w0, torch.log1p(-w0)


def _rows(rec, c0, c1):
    return rec[:3, c0 * S:c1 * S].reshape(3, c1 - c0, 1, S)


def _n_tiles(rec):
    """Tiles of CPT chunks in rec [≥3, lanes]; lanes a multiple of 128·CPT."""
    if rec.dim() != 2 or rec.shape[0] < 3 or rec.shape[1] % (S * CPT):
        raise ValueError(f"rec must be [>=3, k*{S * CPT}], got "
                         f"{tuple(rec.shape)}")
    return rec.shape[1] // (S * CPT)


def micro_prefix_plain(mode: str, rec):
    """Plain PyTorch version: rec [≥3, n_chunks·128] → out [n_chunks / CPT,
    512, 16], the prefix sums by ``cumsum`` in f32, one tile at a time; a
    bf16 mode rounds its operands to bf16 first, as its kernel does (the
    tf32 mode's hi + lo keeps ~21 bits and is taken at f32)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    n_tiles = _n_tiles(rec)
    dev = rec.device
    out = torch.empty((n_tiles, P, 16), device=dev)
    sub = torch.arange(P, device=dev, dtype=torch.float32)[:, None]
    for tile in range(n_tiles):
        u, v, w0, logom = _pair_values(
            _rows(rec, tile * CPT, (tile + 1) * CPT), sub)
        wu = w0 * u
        q = [logom, w0, wu, wu * u]
        if mode == "mma_bf16x2":
            hi = _bf16(logom)
            L = _excl(hi) + _excl(_bf16(logom - hi))
            A, M1, M2 = (_excl(_bf16(x)) for x in q[1:])
        elif mode == "mma_bf16":
            L, A, M1, M2 = (_excl(_bf16(x)) for x in q)
        else:
            L, A, M1, M2 = (_excl(x) for x in q)
        T = torch.exp(L)
        w = w0 * T
        upd = torch.stack([w.sum(-1), (w * u).sum(-1),
                           (w * (u * u * A + M2 - 2 * u * M1)).sum(-1),
                           (w * v).sum(-1), (w * T).sum(-1)], dim=-1).sum(0)
        out[tile, :, :4] = upd[:, :4]
        out[tile, :, 4:] = upd[:, 4:5]
    return out


def prefix_operands(rec):
    """The four prefix operands log1p(−w0), w0, w0·u, w0·u² of every
    (chunk, pixel, lane), [4, n_chunks, 512, 128] f32: the input of the
    library yardstick ``torch.cumsum(prefix_operands(rec), dim=-1)``, the
    scan alone."""
    n_tiles = _n_tiles(rec)
    dev = rec.device
    ops = torch.empty((4, n_tiles * CPT, P, S), device=dev)
    sub = torch.arange(P, device=dev, dtype=torch.float32)[:, None]
    for c0 in range(0, n_tiles * CPT, CPT):
        u, _, w0, logom = _pair_values(_rows(rec, c0, c0 + CPT), sub)
        wu = w0 * u
        for i, x in enumerate((logom, w0, wu, wu * u)):
            ops[i, c0:c0 + CPT] = x
    return ops


def micro_prefix_cuda(mode: str, rec):
    """Launch the T4 kernel (``csrc/micro_prefix.cu``) on the current
    stream."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if rec.device.type != "cuda" or rec.dtype != torch.float32 \
            or not rec.is_contiguous():
        raise ValueError("rec must be a contiguous float32 CUDA tensor, got "
                         f"{rec.dtype} on {rec.device}")
    n_tiles = _n_tiles(rec)
    lib = cuda_lib.load_library()
    out = torch.empty((n_tiles, P, 16), dtype=torch.float32,
                      device=rec.device)
    index = rec.device.index if rec.device.index is not None \
        else torch.cuda.current_device()
    rc = lib.su_micro_prefix(MODES.index(mode), rec.data_ptr(),
                             rec.shape[1], n_tiles * CPT, out.data_ptr(),
                             index,
                             torch.cuda.current_stream(rec.device).cuda_stream)
    cuda_lib.check(rc, f"micro_prefix {mode} launch")
    cuda_lib.launch_counts["micro_prefix"] += 1
    return out


def micro_prefix(mode: str, rec):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    fn = micro_prefix_plain if rec.device.type == "cpu" \
        else micro_prefix_cuda
    return fn(mode, rec)


def make_input(n_chunks: int = NCHUNK, seed: int = 0, device="cuda"):
    """rec [24, n_chunks·128] standard normal from ``seed``, drawn on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((REC, n_chunks * S), generator=gen, device=device)


def main(argv=None):
    from streetunveiler_torch.tools import timing
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chunks", type=int, default=NCHUNK)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    cpu = torch.device(args.device).type == "cpu"
    if not cpu:
        timing.require_cuda(args.device)
        print(timing.card(), flush=True)
    rec = make_input(args.chunks, device=args.device)
    for mode in MODES:
        out = micro_prefix(mode, rec)
        line = dict(mode=mode, chunks=args.chunks,
                    precision=PRECISION[mode], checksum=float(out.sum()))
        if not cpu:
            ms = timing.median_ms(lambda: micro_prefix_cuda(mode, rec),
                                  args.reps)
            line.update(ms=ms, ns_per_chunk=ms * 1e6 / args.chunks)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
