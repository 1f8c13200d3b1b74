"""The yardstick of the rooflines and of ``mfu``: the card's peaks and what
a step or a frame needs, in operations and bytes.

The blend's counts are the port's (``chip_smoke.py`` ``k1_ops``,
``k2_ops``, ``k1_bytes``, ``k2_bytes``, ``bound``, frozen here), fed with
pair counts of the plain reference's own binning and blend under the
kernels' skip rule (``reference.raster.blend_*_plain(count_pairs=True,
skip_rule=True)``): the same whatever implements a kernel.

K1 (the blend forward): ~30 float32 operations for each pair it
evaluates, 8 more for each pair a gated chain keeps. K2 (the backward):
~33 for each evaluated pair (the forward's recompute), 20 + 4·nq for each
pair the main chain keeps (its scan), 20 for each pair a gated chain
keeps, 62 for each pair some chain keeps (the pair VJP and its sums).

The sky and SSIM count what their arithmetic needs at least: the sky's
per-ray MLP 16 → 64 → 64 → 64 → 3 (the camera origin's 95 features enter
the first layer once a view), 2 operations a multiply-add, the backward
twice the forward (inputs and weights); SSIM's separable 11-tap blurs of
5·3 maps forward and of the 3·3 maps that depend on the render backward.
Everything else of a step counts zero, so a share of the peak is a lower
bound.
"""

from __future__ import annotations

# NVIDIA H100 SXM, data sheet, dense: float32 outside the tensor cores and
# HBM3 bandwidth, at the full 700 W limit
F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

K1_OPS_PER_PAIR = 30
K1_OPS_GATED_KEPT = 8
K2_OPS_EVALUATED, K2_OPS_SCAN, K2_OPS_KEPT_CHANNEL, K2_OPS_VJP = 33, 20, 4, 62
Q_ROW0 = 10          # the first payload row of a record
EVALUATED = "evaluated_skip_rule"

SKY_MACS_PER_RAY = 16 * 64 + 64 * 64 + 64 * 64 + 64 * 3
SSIM_TAPS = 11
SSIM_MAPS_FWD, SSIM_MAPS_BWD = 15, 9


def k1_ops(counts: dict) -> float:
    """K1's float32 operations on one call's pair counts."""
    return (K1_OPS_PER_PAIR * counts[EVALUATED]
            + K1_OPS_GATED_KEPT * counts["gated_kept"])


def k2_ops(counts: dict, nq: int) -> float:
    """K2's float32 operations on one call's pair counts."""
    return (K2_OPS_EVALUATED * counts[EVALUATED]
            + (K2_OPS_SCAN + K2_OPS_KEPT_CHANNEL * nq) * counts["kept"]
            + K2_OPS_SCAN * counts["gated_kept"]
            + K2_OPS_VJP * counts["any_kept"])


def k1_bytes(rec_rows: int, filled: int, n_tiles: int, pixels: int,
             channels: int) -> float:
    """What K1 reads and writes: every record row of the stream's filled
    slots, the tile offsets, the accumulator and lk."""
    return 4.0 * (rec_rows * filled + (n_tiles + 1) + pixels * channels
                  + pixels)


def k2_bytes(rec_rows: int, capacity: int, filled: int, n_tiles: int,
             pixels: int, nq: int, n_gates: int) -> float:
    """What K2 reads and writes: record rows 0..9+nq and the gate row of
    each filled slot; of the accumulator α and each (α_g, lk_g); of its
    cotangent the payload, α, depth, m1 and m2 and each (α_g, m1_g, m2_g);
    lk; all of the record gradient."""
    return 4.0 * ((Q_ROW0 + nq + (1 if n_gates else 0)) * filled
                  + (n_tiles + 1) + pixels * (1 + 2 * n_gates) + pixels
                  + pixels * (nq + 4 + 3 * n_gates) + rec_rows * capacity)


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def sky_ops(rays: int, backward: bool) -> float:
    return 2.0 * SKY_MACS_PER_RAY * rays * (3 if backward else 1)


def ssim_ops(pixels: int) -> float:
    return 2.0 * 2 * SSIM_TAPS * pixels * (SSIM_MAPS_FWD + SSIM_MAPS_BWD)
