"""TSDF fusion and mesh extraction (counterpart of ``streetunveiler_tpu/
ops/tsdf.py``).

* ``integrate_tsdf`` fuses one depth/colour view into a dense voxel grid
  on the volume's device, elementwise per voxel, in chunks of voxels, so
  that the grid's ``[X·Y·Z, 3]`` point array is never held whole (the same
  arithmetic per voxel as the JAX package's unchunked version);
* ``surface_nets`` extracts a triangle mesh on the host with numpy (naive
  surface nets: one vertex per sign-change cell at the centroid of its
  edge crossings, two triangles across each sign-changing grid edge);
* ``save_mesh_ply`` writes a binary PLY mesh.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..device import resolve_device

# voxels per integration chunk: the chunk's temporaries (points, view
# coordinates, pixel indices, masks) stay near 100 MB
TSDF_CHUNK = 1 << 22


@dataclasses.dataclass
class TSDFVolume:
    tsdf: torch.Tensor      # [X, Y, Z] truncated signed distance
    weight: torch.Tensor    # [X, Y, Z]
    color: torch.Tensor     # [X, Y, Z, 3]
    origin: torch.Tensor    # [3] world position of voxel (0, 0, 0)
    voxel_size: float


def make_volume(origin, size, voxel_size: float,
                device="cuda") -> TSDFVolume:
    dev = resolve_device(device)
    dims = tuple(int(np.ceil(s / voxel_size)) for s in np.asarray(size))
    return TSDFVolume(
        tsdf=torch.ones(dims, device=dev),
        weight=torch.zeros(dims, device=dev),
        color=torch.zeros(dims + (3,), device=dev),
        origin=torch.as_tensor(np.asarray(origin, np.float32), device=dev),
        voxel_size=voxel_size)


@torch.no_grad()
def integrate_tsdf(vol: TSDFVolume, depth, color, w2c, K,
                   trunc: float = 0.04, depth_trunc: float = 100.0,
                   alpha=None, alpha_thresh: float = 0.5,
                   chunk: int = TSDF_CHUNK) -> TSDFVolume:
    """Fuse one view (depth [H, W], color [H, W, 3], optional alpha
    [H, W]) into ``vol`` IN PLACE, on the volume's device; returns it.

    A voxel takes the view's depth at the pixel its centre projects to
    (the projection truncated toward zero, as ``astype(int32)``), and
    updates where it is in the image, in front of the camera, the depth is
    valid (and α > ``alpha_thresh``) and it lies less than ``trunc``
    behind the surface. The view transform is a 3-wide contraction
    written as products and sums: full f32 whatever the TF32 flags say.
    """
    dev = vol.tsdf.device
    dims = vol.tsdf.shape
    depth = torch.as_tensor(depth, dtype=torch.float32, device=dev)
    color = torch.as_tensor(color, dtype=torch.float32, device=dev)
    w2c = torch.as_tensor(w2c, dtype=torch.float32, device=dev)
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    if alpha is not None:
        alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    h, wimg = depth.shape
    tsdf = vol.tsdf.view(-1)
    weight = vol.weight.view(-1)
    colv = vol.color.view(-1, 3)
    yz = dims[1] * dims[2]
    R, t = w2c[:3, :3], w2c[:3, 3]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    for start in range(0, tsdf.numel(), chunk):
        idx = torch.arange(start, min(start + chunk, tsdf.numel()),
                           device=dev)
        ix, rem = idx // yz, idx % yz
        grid = torch.stack([ix, rem // dims[2], rem % dims[2]], dim=-1)
        pts = grid.to(torch.float32) * vol.voxel_size + vol.origin
        v = (pts[:, None, :] * R).sum(dim=-1) + t
        z = v[:, 2]
        zs = torch.clamp(z, min=1e-6)
        u = v[:, 0] / zs * fx + cx
        w_ = v[:, 1] / zs * fy + cy
        ui = torch.clamp(u.to(torch.int32), 0, wimg - 1).long()
        wi = torch.clamp(w_.to(torch.int32), 0, h - 1).long()
        in_img = (u >= 0) & (u < wimg) & (w_ >= 0) & (w_ < h) & (z > 0)
        d_obs = depth[wi, ui]
        valid = (d_obs > 0) & (d_obs < depth_trunc)
        if alpha is not None:
            valid = valid & (alpha[wi, ui] > alpha_thresh)
        sdf = (d_obs - z) / trunc
        update = in_img & valid & (sdf > -1.0)
        sdf = torch.clamp(sdf, -1.0, 1.0)
        old_t = tsdf[idx]
        old_w = weight[idx]
        old_c = colv[idx]
        new_w = old_w + update.to(torch.float32)
        safe = torch.clamp(new_w, min=1e-6)
        tsdf[idx] = torch.where(update, (old_t * old_w + sdf) / safe, old_t)
        colv[idx] = torch.where(update[:, None],
                                (old_c * old_w[:, None] + color[wi, ui])
                                / safe[:, None], old_c)
        weight[idx] = new_w
    return vol


def surface_nets(tsdf: np.ndarray, weight: np.ndarray, origin, voxel_size,
                 color: np.ndarray | None = None, min_weight: float = 1.0):
    """Extract a triangle mesh from the fused volume (numpy, host-side).

    Returns (vertices [V,3], faces [F,3] int, vertex_colors [V,3] or None).
    """
    t = np.asarray(tsdf)
    w = np.asarray(weight)
    valid = w >= min_weight
    # unobserved voxels count as outside (+1)
    f = np.where(valid, t, 1.0)

    inside = f < 0
    # cells indexed by their min corner; a cell is active when its 8
    # corners mix signs and are all observed
    c_inside = np.zeros(tuple(d - 1 for d in f.shape), np.int32)
    c_valid = np.ones_like(c_inside, bool)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                sl = (slice(dx, f.shape[0] - 1 + dx),
                      slice(dy, f.shape[1] - 1 + dy),
                      slice(dz, f.shape[2] - 1 + dz))
                c_inside += inside[sl]
                c_valid &= valid[sl]
    active = (c_inside > 0) & (c_inside < 8) & c_valid
    if not active.any():
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64),
                None)

    cell_idx = np.full(active.shape, -1, np.int64)
    ax, ay, az = np.nonzero(active)
    cell_idx[ax, ay, az] = np.arange(ax.size)

    # a vertex per active cell at the centroid of its edge crossings
    corners = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1],
                                   indexing="ij"), -1).reshape(8, 3)
    fvals = np.stack([f[ax + c[0], ay + c[1], az + c[2]] for c in corners],
                     axis=1)                                # [N, 8]
    edges = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    num = np.zeros(ax.size)
    acc = np.zeros((ax.size, 3))
    for a, b in edges:
        fa, fb = fvals[:, a], fvals[:, b]
        cross = (fa < 0) != (fb < 0)
        tpar = np.where(cross, fa / np.where(np.abs(fa - fb) < 1e-12, 1e-12,
                                             fa - fb), 0.0)
        pt = corners[a] + tpar[:, None] * (corners[b] - corners[a])
        acc += np.where(cross[:, None], pt, 0.0)
        num += cross
    centroid = acc / np.maximum(num, 1)[:, None]
    verts = (np.stack([ax, ay, az], 1) + centroid) * voxel_size + \
        np.asarray(origin)

    vcols = None
    if color is not None:
        vcols = np.asarray(color)[ax, ay, az]

    # two triangles across each grid edge with a sign change, joining the
    # 4 cells that share the edge
    faces = []
    for axis in range(3):
        o1, o2 = [a for a in range(3) if a != axis]
        sl_a = [slice(None)] * 3
        sl_b = [slice(None)] * 3
        sl_b[axis] = slice(1, None)
        sl_a[axis] = slice(0, -1)
        sign_a = inside[tuple(sl_a)]
        sign_b = inside[tuple(sl_b)]
        crossing = ((sign_a != sign_b) & valid[tuple(sl_a)]
                    & valid[tuple(sl_b)])
        ex, ey, ez = np.nonzero(crossing)
        e = np.stack([ex, ey, ez], 1)
        cells = []
        ok = np.ones(e.shape[0], bool)
        for d1 in (0, -1):
            for d2 in (0, -1):
                off = np.zeros(3, np.int64)
                off[o1] = d1
                off[o2] = d2
                cc = e + off
                inb = np.all((cc >= 0) & (cc < np.array(active.shape)), 1)
                ids = np.where(inb, cell_idx[
                    cc[:, 0].clip(0, active.shape[0] - 1),
                    cc[:, 1].clip(0, active.shape[1] - 1),
                    cc[:, 2].clip(0, active.shape[2] - 1)], -1)
                ok &= ids >= 0
                cells.append(ids)
        c00, c01, c10, c11 = cells
        # quads (c00, c01, c11, c10), reversed where the first voxel is
        # inside, each split into (q0, q1, q2) and (q0, q2, q3)
        quad = np.stack([c00, c01, c11, c10], 1)[ok]
        flip = sign_a[ex, ey, ez][ok]
        quad = np.where(flip[:, None], quad[:, ::-1], quad)
        faces.append(np.stack([quad[:, [0, 1, 2]], quad[:, [0, 2, 3]]],
                              1).reshape(-1, 3))
    faces = np.concatenate(faces).astype(np.int64)
    return verts.astype(np.float32), faces, vcols


def save_mesh_ply(path: str, verts, faces, colors=None) -> None:
    """Binary little-endian PLY mesh: float xyz, optional uchar rgb
    (colours in [0, 1]), triangles as uchar-counted int lists."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    v = np.asarray(verts, np.float32)
    fidx = np.asarray(faces, np.int32)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {v.shape[0]}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [f"element face {fidx.shape[0]}",
               "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        if colors is None:
            fh.write(v.tobytes())
        else:
            c8 = (np.clip(np.asarray(colors), 0, 1) * 255).astype(np.uint8)
            rec = np.empty(v.shape[0], dtype=[("xyz", "<f4", 3),
                                              ("rgb", "u1", 3)])
            rec["xyz"] = v
            rec["rgb"] = c8
            fh.write(rec.tobytes())
        frec = np.empty(fidx.shape[0], dtype=[("n", "u1"), ("idx", "<i4", 3)])
        frec["n"] = 3
        frec["idx"] = fidx
        fh.write(frec.tobytes())
