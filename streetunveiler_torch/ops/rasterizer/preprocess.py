"""Per-surfel preprocess: world space → screen-space ray-intersection form
(counterpart of ``streetunveiler_tpu/ops/rasterizer/preprocess.py``).

A 2D surfel is the plane patch P(u, v) = p + s_u·t_u·u + s_v·t_v·v. In
view space it is a·u + b·v + c, and with the pinhole intrinsics K' one
3x3 matrix M = K'·[a | b | c] maps (u, v, 1) to homogeneous screen
coordinates. Everything the blend needs derives from M's rows, the
projected center and the view-space normal.

Every 3-wide contraction here is an elementwise product and sum, never a
matmul: a TF32 matmul on the card keeps ~10 mantissa bits and would
quantize the geometry the way the TPU's bf16 default did (the JAX package
pins HIGHEST precision at the same places). So the result is full f32
whatever ``torch.backends.cuda.matmul.allow_tf32`` says.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..transforms import quat_to_rotmat
from .types import FILTER_INV_SQUARE, RasterizeSettings


class SurfelScreen(NamedTuple):
    """Screen-space surfel representation consumed by the blend.

    All tensors have leading dim N (surfel count)."""

    M: torch.Tensor        # [N, 3, 3] splat(u,v,1) → homogeneous screen
    center2d: torch.Tensor  # [N, 2] projected center (pixels)
    depth: torch.Tensor    # [N] view-space center depth (sort key)
    normal: torch.Tensor   # [N, 3] camera-facing view-space unit normal
    opacity: torch.Tensor  # [N] activated opacity
    color: torch.Tensor    # [N, C] per-view color
    radius: torch.Tensor   # [N] conservative screen-space radius (pixels)
    ext: torch.Tensor      # [N, 2] exact per-axis screen extents (pixels)
    valid: torch.Tensor    # [N] bool — in frustum and non-degenerate
    cull: torch.Tensor     # [N, 11] conic-cull table: A=r1×r2, B=r2×r3,
    #                        C=r3×r1 (k(p) = A + px·B + py·C), rho_max, d2max


def _rowdot(x, m):
    """x [N,3] times mᵀ for a 3x3 ``m``: out[:, i] = Σ_j x[:, j]·m[i, j],
    as elementwise f32 products (no matmul, hence no TF32)."""
    return (x[:, None, :] * m[None, :, :]).sum(dim=-1)


def preprocess_surfels(means3d, scales, quats, opacities, colors,
                       w2c, K, settings: RasterizeSettings,
                       center2d_offset=None) -> SurfelScreen:
    """Vectorized over N. ``scales``/``opacities`` are pre-activated.

    ``center2d_offset`` [N,2] is an always-zero tap: the projected center
    is ``project(mean) + offset`` and M's third column is rebuilt from it,
    so ∂L/∂offset is the screen-space position gradient densification
    reads.
    """
    R = w2c[:3, :3]
    t = w2c[:3, 3]
    c_view = _rowdot(means3d, R) + t                 # [N,3]
    depth = c_view[:, 2]

    rot = quat_to_rotmat(quats)                      # [N,3,3]
    s = scales * settings.scale_modifier
    a = _rowdot(rot[:, :, 0], R) * s[:, 0:1]         # view-space u-axis
    b = _rowdot(rot[:, :, 1], R) * s[:, 1:2]         # view-space v-axis
    n = _rowdot(rot[:, :, 2], R)                     # view-space normal

    # flip normals toward the camera (ray dir ≈ center dir in view space)
    facing = torch.sum(n * c_view, dim=-1)
    n = torch.where(facing[:, None] > 0, -n, n)

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    Kp = torch.eye(3, dtype=torch.float32, device=means3d.device)
    Kp[0, 0], Kp[0, 2], Kp[1, 1], Kp[1, 2] = fx, cx, fy, cy

    zsafe = torch.where(torch.abs(depth) < 1e-8,
                        torch.full_like(depth, 1e-8), depth)
    center2d = torch.stack([(fx * c_view[:, 0] + cx * zsafe) / zsafe,
                            (fy * c_view[:, 1] + cy * zsafe) / zsafe], dim=-1)
    if center2d_offset is not None:
        center2d = center2d + center2d_offset

    # M columns: K'a | K'b | (x2d·z, y2d·z, z) — the third column rebuilt
    # from the (tapped) screen center
    col_a = _rowdot(a, Kp)
    col_b = _rowdot(b, Kp)
    col_c = torch.stack([center2d[:, 0] * zsafe, center2d[:, 1] * zsafe,
                         depth], dim=-1)
    M = torch.stack([col_a, col_b, col_c], dim=-1)   # [N,3,3]

    # Exact projective screen extent of the contribution region ρ ≤ ρ_max
    # = 2·ln(255·opacity): the union of the conic image of the uv-disc
    # (axis extremes from the dual conic D = M·diag(ρ,ρ,−1)·Mᵀ) and the
    # low-pass disc. Index-space only, never differentiated.
    op = opacities.reshape(-1)
    rho_max = 2.0 * torch.log(torch.clamp(255.0 * op.detach(), min=1e-6))
    rho_pos = torch.clamp(rho_max, min=1e-12)
    Msg = M.detach()

    def conic_interval(i):
        ri, r3 = Msg[:, i, :], Msg[:, 2, :]
        dii = rho_pos * (ri[:, 0] ** 2 + ri[:, 1] ** 2) - ri[:, 2] ** 2
        di2 = (rho_pos * (ri[:, 0] * r3[:, 0] + ri[:, 1] * r3[:, 1])
               - ri[:, 2] * r3[:, 2])
        d22 = rho_pos * (r3[:, 0] ** 2 + r3[:, 1] ** 2) - r3[:, 2] ** 2
        bounded = d22 < -1e-12
        d22s = torch.where(bounded, d22, torch.full_like(d22, -1.0))
        ce = di2 / d22s
        half = torch.sqrt(torch.clamp(ce * ce - dii / d22s, min=0.0))
        # unbounded conic image (plane grazing the camera): cover all;
        # the exact conic tile test in the binning prunes it
        return (torch.where(bounded, ce, torch.zeros_like(ce)),
                torch.where(bounded, half, torch.full_like(half, 1e6)))

    cex, ext3_x = conic_interval(0)
    cey, ext3_y = conic_interval(1)
    r_lowpass = torch.sqrt(rho_pos * 0.5)
    c2dsg = center2d.detach()
    ext_x = torch.maximum(torch.abs(cex - c2dsg[:, 0]) + ext3_x,
                          r_lowpass) + 0.51
    ext_y = torch.maximum(torch.abs(cey - c2dsg[:, 1]) + ext3_y,
                          r_lowpass) + 0.51
    radius = torch.maximum(ext_x, ext_y)
    visible = rho_max > 0.0  # opacity below 1/255 can never contribute

    in_depth = (depth > settings.znear) & (depth < settings.zfar)
    on_screen = ((center2d[:, 0] + ext_x > 0)
                 & (center2d[:, 0] - ext_x < settings.width)
                 & (center2d[:, 1] + ext_y > 0)
                 & (center2d[:, 1] - ext_y < settings.height))
    valid = in_depth & on_screen & torch.isfinite(radius) & visible

    zero = torch.zeros_like(ext_x)
    ext = torch.stack([torch.where(valid, ext_x, zero),
                       torch.where(valid, ext_y, zero)], dim=-1)

    # conic-cull table: ρ3d ≤ ρ_max ⟺ kx²+ky²−ρ_max·kz² ≤ 0 with
    # k(p) = A + px·B + py·C (blendmath's hoisted cross products)
    r1, r2, r3 = (Msg[:, i, :] for i in range(3))
    rho_sg = rho_max.detach()[:, None]
    cull = torch.cat([
        torch.linalg.cross(r1, r2, dim=-1), torch.linalg.cross(r2, r3, dim=-1),
        torch.linalg.cross(r3, r1, dim=-1),
        rho_sg, rho_sg * (1.0 / FILTER_INV_SQUARE)], dim=1)

    return SurfelScreen(M=M, center2d=center2d, depth=depth, normal=n,
                        opacity=op, color=colors,
                        radius=torch.where(valid, radius, zero), ext=ext,
                        valid=valid, cull=cull)
