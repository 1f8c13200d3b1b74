"""Mesh extraction (counterpart of ``streetunveiler_tpu/mesh.py``): render
every view, TSDF-fuse on the device, extract on the host with surface
nets, and keep the large connected components (the reference's
``post_process_mesh`` cluster filter).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops.tsdf import integrate_tsdf, make_volume, save_mesh_ply, surface_nets
from .renderer import render


def estimate_bounds(state, margin: float = 0.05):
    """Axis-aligned bounds of the alive surfels, padded by ``margin`` of
    their extent (+1e-3), as numpy (lo, hi)."""
    xyz = state.params.xyz.detach().cpu().numpy()[
        state.alive.detach().cpu().numpy()]
    lo = xyz.min(0)
    hi = xyz.max(0)
    pad = (hi - lo) * margin + 1e-3
    return lo - pad, hi + pad


@torch.no_grad()
def fuse_views(cameras, state, bg=None, voxel_size: float = 0.05,
               sdf_trunc: float | None = None, depth_trunc: float = 100.0,
               bounds=None, alpha_thresh: float = 0.5,
               depth_ratio: float = 0.0,
               duplicate_capacity: int | None = None, device="cuda"):
    """The TSDF volume of ``cameras``' renders of ``state`` on
    ``device``."""
    dev = resolve_device(device)
    state = state.to(dev)
    bg = torch.zeros(3, device=dev) if bg is None else torch.as_tensor(
        bg, dtype=torch.float32, device=dev)
    lo, hi = estimate_bounds(state) if bounds is None else bounds
    if sdf_trunc is None:
        sdf_trunc = 5.0 * voxel_size
    vol = make_volume(lo, np.asarray(hi) - np.asarray(lo), voxel_size,
                      device=dev)
    for cam in cameras:
        cam = cam.to(dev)
        res = render(cam, state, bg, depth_ratio=depth_ratio,
                     duplicate_capacity=duplicate_capacity, device=dev)
        integrate_tsdf(vol, res.surf_depth, res.render, cam.w2c, cam.K,
                       trunc=sdf_trunc, depth_trunc=depth_trunc,
                       alpha=res.rend_alpha, alpha_thresh=alpha_thresh)
    return vol


def volume_mesh(vol):
    """``surface_nets`` of a fused volume, on the host."""
    host = lambda t: t.detach().cpu().numpy()
    return surface_nets(host(vol.tsdf), host(vol.weight), host(vol.origin),
                        vol.voxel_size, color=host(vol.color))


def extract_mesh(cameras, state, bg=None, voxel_size: float = 0.05,
                 sdf_trunc: float | None = None, depth_trunc: float = 100.0,
                 bounds=None, alpha_thresh: float = 0.5,
                 min_cluster_frac: float = 0.02, depth_ratio: float = 0.0,
                 duplicate_capacity: int | None = None, device="cuda"):
    """TSDF-fuse the views and return (verts, faces, colors) as numpy.

    Pass a measured ``duplicate_capacity`` (``renderer.
    measure_duplicate_capacity``) for trained states: a truncated duplicate
    stream drops the farthest surfels and punches depth holes into the
    fusion."""
    vol = fuse_views(cameras, state, bg=bg, voxel_size=voxel_size,
                     sdf_trunc=sdf_trunc, depth_trunc=depth_trunc,
                     bounds=bounds, alpha_thresh=alpha_thresh,
                     depth_ratio=depth_ratio,
                     duplicate_capacity=duplicate_capacity, device=device)
    verts, faces, colors = volume_mesh(vol)
    if faces.shape[0] and min_cluster_frac > 0:
        verts, faces, colors = keep_large_clusters(verts, faces, colors,
                                                   min_cluster_frac)
    return verts, faces, colors


def keep_large_clusters(verts, faces, colors, min_frac: float):
    """Drop the connected components with fewer than ``min_frac`` of the
    vertices (the reference's ``post_process_mesh``), on the host. The
    components come from scipy's ``connected_components`` over the face
    edges: the same partition as the JAX package's union-find, so the
    same vertices and faces survive, in the same order."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    n = verts.shape[0]
    f = np.asarray(faces, np.int64)
    a = np.concatenate([f[:, 0], f[:, 1]])
    b = np.concatenate([f[:, 1], f[:, 2]])
    graph = coo_matrix((np.ones(a.size, np.int32), (a, b)), shape=(n, n))
    _, labels = connected_components(graph, directed=False)
    counts = np.bincount(labels)
    vkeep = counts[labels] >= min_frac * n
    remap = -np.ones(n, np.int64)
    remap[vkeep] = np.arange(vkeep.sum())
    fkeep = vkeep[f].all(axis=1)
    new_faces = remap[f[fkeep]]
    return (verts[vkeep], new_faces,
            None if colors is None else colors[vkeep])


__all__ = ["estimate_bounds", "extract_mesh", "fuse_views",
           "keep_large_clusters", "save_mesh_ply", "volume_mesh"]
