"""Producer probe (T8): does the producer of the blend's index arrays change
what the blend costs? Timed on the card.

Counterpart of ``tools/probe_tax.py``, whose Pallas identity
``_pallas_identity`` (:66, body ``k`` :72, launched at :75) becomes the
kernel ``csrc/identity.cu``: ``identity_copy(x)`` pads the 1-D int32 x
with zeros to [⌈n/128⌉, 128], copies it and returns its first n values,
as the tool's does. Its plain version is a clone of the padded view.
The copy has two designs with the same bits (``DESIGNS``): ``redesign``
(the default, ``csrc/identity_sm90.cuh``: a grid that covers the values
once, two 16-byte loads and stores a thread) and ``first`` (the first
design, a grid-stride loop).

The TPU's blend read seven visit arrays through scalar prefetch and ran
30-45 ms slower when they were computed in the same program than when
they came in as arguments. The port's K1 reads one index array,
``tile_offsets`` [T + 1], beside the records, so the probe's "visit
arrays" are that one binning output (``kernel.blend_stream`` reads it).
The variants on the 300k-surfel street at 1920x1280
(``street.probe_inputs``), each the blend of the stored records:

* ``args``: ``tile_offsets`` as the binning left it;
* ``dyn``: ``tile_offsets + z``, z an int32 zero computed on the device;
* ``launder``: ``identity_copy(tile_offsets + z)``;
* ``dyn`` ×2 and ``args`` ×2: two blends on the same arrays.

The TPU tool perturbed its inputs on every call only to defeat its
remote relay's dedupe of repeated launches; the port times with
``timing.median_ms`` and needs no perturbation. ``--hlo`` dumped XLA's
optimised module and has no eager counterpart: it raises here.

Run on the card: ``python -m streetunveiler_torch.tools.probe_tax
[--device cuda]``; ``--device cpu`` runs the plain versions on the
600-surfel miniature (``street.MINI``).
"""

from __future__ import annotations

import argparse
import json

import torch

from streetunveiler_torch import trace
from streetunveiler_torch.ops.rasterizer import cuda_lib

LANES = 128
VARIANTS = (("args", 1), ("dyn", 1), ("launder", 1), ("dyn", 2),
            ("args", 2))
DESIGNS = ("redesign", "first")


def pad_lanes(x):
    """x [n] int32 → [⌈n/128⌉, 128], zero-padded (a new tensor)."""
    if x.dim() != 1 or x.dtype != torch.int32 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty 1-D int32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    pad = -(-x.numel() // LANES) * LANES - x.numel()
    return torch.cat([x, x.new_zeros(pad)]).view(-1, LANES)


def copy_plain(xp):
    """Plain version of the copy kernel: a clone."""
    return xp.clone()


def _check_padded(xp):
    if xp.device.type != "cuda" or xp.dtype != torch.int32 \
            or not xp.is_contiguous() or xp.numel() % LANES \
            or xp.numel() == 0:
        raise ValueError("xp must be a contiguous int32 CUDA tensor of a "
                         f"multiple of {LANES} values, got "
                         f"{tuple(xp.shape)} {xp.dtype} on {xp.device}")
    index = xp.device.index if xp.device.index is not None \
        else torch.cuda.current_device()
    return index, torch.cuda.current_stream(xp.device).cuda_stream


def copy_cuda(xp, key="identity", design="redesign"):
    """Launch the copy kernel of ``design`` (``csrc/identity.cu``) on the
    current stream: a new tensor equal to xp (int32, contiguous, a
    multiple of 128 values). ``key`` is the caller's entry of
    ``launch_counts``."""
    if design not in DESIGNS:
        raise ValueError(f"design must be one of {DESIGNS}, got {design!r}")
    index, stream = _check_padded(xp)
    lib = cuda_lib.load_library()
    out = torch.empty_like(xp)
    entry = lib.su_identity if design == "redesign" \
        else lib.su_identity_first
    rc = entry(xp.data_ptr(), out.data_ptr(), xp.numel(), index, stream)
    cuda_lib.check(rc, f"identity launch ({design})")
    trace.launch_counts[key] += 1
    return out


def identity_copy_plain(x):
    """Plain version of T8."""
    return copy_plain(pad_lanes(x)).view(-1)[:x.numel()]


def identity_copy_cuda(x):
    """T8 through the copy kernel."""
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    return copy_cuda(pad_lanes(x)).view(-1)[:x.numel()]


def identity_copy(x):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    fn = identity_copy_plain if x.device.type == "cpu" \
        else identity_copy_cuda
    return fn(x)


def make(variant, ncalls, ctx):
    """The probe's body for ``variant`` on ``street.probe_inputs``' ctx:
    a function returning the last blend's (acc, lk)."""
    from streetunveiler_torch.ops.rasterizer import kernel
    if (variant, ncalls) not in VARIANTS:
        raise ValueError(f"(variant, ncalls) must be one of {VARIANTS}")
    base = ctx.binning.tile_offsets
    dev = base.device

    def body():
        with torch.no_grad():
            if variant == "args":
                off = base
            else:
                z = (torch.zeros((), device=dev) * 1e-30).to(torch.int32)
                off = base + z
                if variant == "launder":
                    off = identity_copy(off)
            for _ in range(ncalls):
                out = kernel.blend_stream(
                    ctx.recT0, off, ctx.tiles_x, ctx.tiles_y, ctx.settings,
                    tile_order=ctx.binning.tile_order)
            return out
    return body


def run(ctx, reps=10):
    """Every variant once, then, on the card and with ``reps`` > 0, each
    timed (median of ``reps`` CUDA-event times). Returns one dict per
    variant; ``out`` is its last (acc, lk), to be compared."""
    from streetunveiler_torch.tools import timing
    lines = []
    for variant, ncalls in VARIANTS:
        fn = make(variant, ncalls, ctx)
        line = dict(variant=variant, calls=ncalls, out=fn())
        if ctx.recT0.device.type == "cuda" and reps > 0:
            line["ms"] = timing.median_ms(fn, reps)
        lines.append(line)
    return lines


def main(argv=None):
    from streetunveiler_torch.tools import street, timing
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--hlo", action="store_true",
                    help="the TPU tool's XLA dump: not available here")
    args = ap.parse_args(argv)
    if args.hlo:
        raise SystemExit("probe_tax --hlo dumps XLA's optimised HLO, which "
                         "only the JAX tool (tools/probe_tax.py) has; the "
                         "port runs eagerly")
    cpu = torch.device(args.device).type == "cpu"
    if cpu:
        ctx = street.probe_inputs(
            **{k: street.MINI[k] for k in ("n", "width", "height", "focal",
                                           "scale")}, device="cpu")
    else:
        timing.require_cuda(args.device)
        print(timing.card(), flush=True)
        ctx = street.probe_inputs(device=args.device)
    print(json.dumps(dict(steps=int(ctx.binning.tile_offsets[-1]),
                          tiles=ctx.tiles_x * ctx.tiles_y)), flush=True)
    for line in run(ctx, args.reps):
        acc, _ = line.pop("out")
        line["checksum"] = float(acc.double().sum())
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
