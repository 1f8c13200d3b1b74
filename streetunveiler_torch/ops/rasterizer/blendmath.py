"""Pair (surfel × pixel) math shared by the oracle and the plain blend
(counterpart of ``streetunveiler_tpu/ops/rasterizer/blendmath.py``; the
CUDA kernel ``csrc/blend_fwd.cu`` repeats the same formulas per thread).

Semantics: ray–plane intersection via the homogeneous pixel planes,
object-space ρ3d merged with the screen-space low-pass ρ2d = 2‖Δpix‖² by
the min, α = min(0.99, o·e^{−ρ/2}), pairs with α < 1/255 or t < znear
dropped, front-to-back compositing with early termination at ``t_eps``.
"""

from __future__ import annotations

import torch

from .types import ALPHA_EPS, ALPHA_MAX, FILTER_INV_SQUARE, T_EPS


def pair_alpha_depth(m_rows, center2d, center_depth, opacity, valid,
                     px, py, znear, exp=torch.exp):
    """Alpha and intersection depth for every (surfel, pixel) pair.

    m_rows: 9 tensors — rows of M (r1x, r1y, r1z, r2x, ..., r3z);
    center2d: (cx2d, cy2d); center_depth, opacity, valid: per surfel.
    The per-surfel tensors are shaped to broadcast against ``px``/``py``
    (1-D [S] against 1-D [P] gives [S, P]; callers with batch axes shape
    them themselves). Returns (alpha, t), alpha zeroed for non-contributing
    pairs. ``exp`` is the Gaussian falloff's exponential (a measurement
    variant swaps in a linear stand-in).

    k = hu × hv is affine in the pixel: k = (r1×r2) + px·(r2×r3) +
    py·(r3×r1), and r3·k = det(M), so the cross products are per-surfel.
    """
    col = lambda m: m[:, None] if m.dim() == 1 else m
    row = lambda p: p[None, :] if p.dim() == 1 else p
    r1x, r1y, r1z, r2x, r2y, r2z, r3x, r3y, r3z = [col(m) for m in m_rows]
    pxb, pyb = row(px), row(py)
    c2dx, c2dy = col(center2d[0]), col(center2d[1])
    center_depth = col(center_depth)
    opacity = col(opacity)
    valid = col(valid)

    ax = r1y * r2z - r1z * r2y          # A = r1 × r2
    ay = r1z * r2x - r1x * r2z
    az = r1x * r2y - r1y * r2x
    bx = r2y * r3z - r2z * r3y          # B = r2 × r3
    by = r2z * r3x - r2x * r3z
    bz = r2x * r3y - r2y * r3x
    cx = r3y * r1z - r3z * r1y          # C = r3 × r1
    cy = r3z * r1x - r3x * r1z
    cz = r3x * r1y - r3y * r1x
    det_m = r3x * ax + r3y * ay + r3z * az   # r3·(r1×r2) = det(M)

    kx = ax + pxb * bx + pyb * cx
    ky = ay + pxb * by + pyb * cy
    kz = az + pxb * bz + pyb * cz
    kz_safe = torch.where(torch.abs(kz) < 1e-12, torch.full_like(kz, 1e-12),
                          kz)
    rcp = 1.0 / kz_safe

    rho3d = (kx * kx + ky * ky) * (rcp * rcp)
    t_isect = det_m * rcp

    dx = pxb - c2dx
    dy = pyb - c2dy
    rho2d = FILTER_INV_SQUARE * (dx * dx + dy * dy)

    use2d = rho3d > rho2d
    rho = torch.where(use2d, rho2d, rho3d)
    t = torch.where(use2d, center_depth.expand_as(t_isect), t_isect)

    g = exp(-0.5 * rho)
    alpha = torch.clamp(opacity * g, max=ALPHA_MAX)
    contrib = (alpha >= ALPHA_EPS) & (t >= znear) & valid
    return torch.where(contrib, alpha, torch.zeros_like(alpha)), t


def map_depth(t, znear, zfar):
    """Depth → [0,1] NDC-style mapping used by the distortion accumulator."""
    tsafe = torch.clamp(t, min=1e-6)
    return (zfar / (zfar - znear)) * (1.0 - znear / tsafe)


def chunk_weights(alpha, t_carry, done_carry, t_eps=T_EPS, dim=0):
    """Compositing weights for one depth-sorted chunk along ``dim``.

    alpha: [..., S, ..., P] zeroed for non-contributing pairs; t_carry and
    done_carry: the incoming transmittance and early-termination flag,
    shaped like alpha without ``dim``.

    Returns (w, t_excl, t_out, done_out): ``w`` = α·T_excl with the
    reference's early-termination rule — a pair whose post-blend
    transmittance would drop below ``t_eps`` is not composited and freezes
    the pixel (0 disables).
    """
    one_minus = 1.0 - alpha
    cum_incl = torch.cumprod(one_minus, dim=dim)
    t_in = t_carry.unsqueeze(dim)
    excl = torch.cat([torch.ones_like(cum_incl.narrow(dim, 0, 1)),
                      cum_incl.narrow(dim, 0, cum_incl.shape[dim] - 1)],
                     dim=dim)
    t_excl = t_in * excl
    t_after = t_in * cum_incl

    trigger = (alpha > 0.0) & (t_after < t_eps)
    dead = (torch.cumsum(trigger.to(torch.int32), dim=dim) > 0) | \
        done_carry.unsqueeze(dim)
    keep = (alpha > 0.0) & ~dead

    w = torch.where(keep, alpha * t_excl, torch.zeros_like(alpha))
    kept_factor = torch.where(keep, one_minus, torch.ones_like(one_minus))
    t_out = t_carry * torch.prod(kept_factor, dim=dim)
    done_out = done_carry | torch.any(trigger, dim=dim)
    return w, t_excl, t_out, done_out
