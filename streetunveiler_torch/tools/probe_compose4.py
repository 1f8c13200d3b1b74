"""Launder probe (T7): does re-producing the binning's outputs by one extra
copy kernel change what binning → blend costs? Timed on the card.

Counterpart of ``tools/probe_compose4.py``, whose Pallas identity
``pallas_identity`` (:39, body ``k`` :48, launched at :51) becomes the
kernel ``csrc/identity.cu`` (shared with T8, ``probe_tax``):
``identity_copy_stack(*xs)`` takes k 1-D int32 arrays of one length n,
stacks them zero-padded to [k, ⌈n/128⌉, 128], copies the stack in one
launch and returns the k copies of length n, as the tool's does. Its
plain version is a clone of the padded stack.

The TPU's blend read seven visit arrays; the port's K1 reads
``tile_offsets`` [T + 1] beside the records, so the laundered "visit
arrays" are that one binning output (``kernel.blend_stream`` reads it).
The variants on the 300k-surfel street at 1920x1280
(``street.probe_inputs``), each a binning then a blend:

* ``k_bin``: the blend of the stored records on the fresh binning;
* ``k_bin_launder``: the same with ``tile_offsets`` through the copy;
* ``k_full_launder``: binning, the copy, the record gather on the fresh
  ``sorted_surfel``, the blend;
* ``k_full_launder1``: the tool launders only ``tile_of_visit`` of its
  seven arrays; with one array that is all of them, so it equals
  ``k_full_launder`` (kept, to keep the tool's lines).

The binning is deterministic, so every variant's blend is bit for bit the
same. ``--device cpu`` runs the plain versions on the 600-surfel
miniature (``street.MINI``).
"""

from __future__ import annotations

import argparse
import json

import torch

from streetunveiler_torch.tools.probe_tax import (copy_cuda, copy_plain,
                                                 pad_lanes)

MODES = ("k_bin", "k_bin_launder", "k_full_launder", "k_full_launder1")


def stack_lanes(*xs):
    """k 1-D int32 arrays of one length n → [k, ⌈n/128⌉, 128], each
    zero-padded by ``pad_lanes`` (a new tensor)."""
    if not xs or any(x.shape != xs[0].shape or x.device != xs[0].device
                     for x in xs):
        raise ValueError("identity_copy_stack takes arrays of one length "
                         "on one device")
    return torch.stack([pad_lanes(x) for x in xs])


def _unstack(out, n):
    return tuple(out[i].view(-1)[:n] for i in range(out.shape[0]))


def identity_copy_stack_plain(*xs):
    """Plain version of T7."""
    return _unstack(copy_plain(stack_lanes(*xs)), xs[0].numel())


def identity_copy_stack_cuda(*xs):
    """T7 through the copy kernel, one launch for the stack."""
    if not xs or xs[0].device.type != "cuda":
        raise ValueError("identity_copy_stack_cuda takes CUDA tensors")
    return _unstack(copy_cuda(stack_lanes(*xs), "identity_stack"),
                    xs[0].numel())


def identity_copy_stack(*xs):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    fn = identity_copy_stack_plain if xs and xs[0].device.type == "cpu" \
        else identity_copy_stack_cuda
    return fn(*xs)


def make(mode, ctx):
    """The probe's body for ``mode`` on ``street.probe_inputs``' ctx: a
    function returning the blend's (acc, lk)."""
    from streetunveiler_torch.ops.rasterizer import kernel
    from streetunveiler_torch.ops.rasterizer.api import _gather_records
    from streetunveiler_torch.tools.street import bin_stream
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")

    def body():
        with torch.no_grad():
            b = bin_stream(ctx)
            va = (b.tile_offsets,)
            if mode != "k_bin":
                va = identity_copy_stack(*va)
            recT = ctx.recT0 if mode in ("k_bin", "k_bin_launder") \
                else _gather_records(ctx.packT0, b.sorted_surfel)
            return kernel.blend_stream(recT, va[0], ctx.tiles_x,
                                       ctx.tiles_y, ctx.settings,
                                       tile_order=b.tile_order)
    return body


def run(ctx, reps=10):
    """Every mode once, then, on the card and with ``reps`` > 0, each timed
    (median of ``reps`` CUDA-event times). Returns one dict per mode;
    ``out`` is its (acc, lk), to be compared."""
    from streetunveiler_torch.tools import timing
    lines = []
    for mode in MODES:
        fn = make(mode, ctx)
        line = dict(mode=mode, out=fn())
        if ctx.recT0.device.type == "cuda" and reps > 0:
            line["ms"] = timing.median_ms(fn, reps)
        lines.append(line)
    return lines


def main(argv=None):
    from streetunveiler_torch.tools import street, timing
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cpu":
        ctx = street.probe_inputs(
            **{k: street.MINI[k] for k in ("n", "width", "height", "focal",
                                           "scale")}, device="cpu")
    else:
        timing.require_cuda(args.device)
        print(timing.card(), flush=True)
        ctx = street.probe_inputs(device=args.device)
    for line in run(ctx, args.reps):
        acc, _ = line.pop("out")
        line["checksum"] = float(acc.double().sum())
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
