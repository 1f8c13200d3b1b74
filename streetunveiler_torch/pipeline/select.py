"""Unveil stage A and the start of B — instance selection (counterpart of
``streetunveiler_tpu/pipeline/select.py``).

Clusters the surfels of a target semantic class into spatial instances
(connected components of the τ-ball graph, on the host: scipy's KD-tree
gives the neighbour pairs, ``connected_components`` the partition), renders
a preview of each solid instance for choosing ids, and turns the chosen
ids into the surfel removal mask.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
from scipy.spatial import cKDTree

from ..models.gaussians import SurfelState

CLUSTER_THRESHOLD = 7e-2     # the reference's clustering radius
MIN_SOLID_CLUSTER = 50       # clusters below this are not offered


class Clustering(NamedTuple):
    labels: np.ndarray        # [C] instance id, -1 = not in target class
    cluster_ids: np.ndarray   # ids sorted by descending size
    cluster_sizes: np.ndarray


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def auto_cluster_threshold(xyz: np.ndarray, factor: float = 3.0) -> float:
    """Data-driven clustering radius: ``factor`` × the median 1-NN
    distance of the class points, at least CLUSTER_THRESHOLD (which
    assumes the reference's normalized scene units)."""
    if xyz.shape[0] < 2:
        return CLUSTER_THRESHOLD
    tree = cKDTree(xyz)
    d, _ = tree.query(xyz[:: max(1, xyz.shape[0] // 5000)], k=2)
    return float(max(factor * np.median(d[:, 1]), CLUSTER_THRESHOLD))


def cluster_semantic_instance(state: SurfelState, class_bits: int,
                              threshold: float | None = CLUSTER_THRESHOLD
                              ) -> Clustering:
    """Connected components of the τ-ball graph over the alive surfels of
    a class (the reference's ``cluster_instance_with_mask``); instances are
    numbered by their smallest surfel index. ``threshold=None`` derives τ
    from the class points' nearest-neighbour distances."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    alive = _host(state.alive)
    in_class = _host(state.semantic_mask(class_bits)) & alive
    xyz = _host(state.params.xyz)[in_class]
    idx = np.where(in_class)[0]

    labels = np.full(alive.shape[0], -1, np.int64)
    if xyz.shape[0] == 0:
        return Clustering(labels, np.array([], np.int64),
                          np.array([], np.int64))
    if threshold is None:
        threshold = auto_cluster_threshold(xyz)
    n = xyz.shape[0]
    pairs = cKDTree(xyz).query_pairs(threshold, output_type="ndarray")
    graph = coo_matrix((np.ones(len(pairs), np.int32),
                        (pairs[:, 0], pairs[:, 1])), shape=(n, n))
    # components come numbered in the order of their smallest point
    _, comp = connected_components(graph, directed=False)
    counts = np.bincount(comp)
    labels[idx] = comp
    order = np.argsort(-counts)
    return Clustering(labels=labels, cluster_ids=order.astype(np.int64),
                      cluster_sizes=counts[order])


def solid_cluster_mask(clustering: Clustering,
                       min_size: int = MIN_SOLID_CLUSTER) -> np.ndarray:
    """[C] bool: the surfels in clusters of ≥ ``min_size`` (the reference's
    ``solid_cluster_mask.pt``)."""
    solid = [int(c) for c, s in zip(clustering.cluster_ids,
                                    clustering.cluster_sizes)
             if s >= min_size]
    return np.isin(clustering.labels, np.array(sorted(solid), np.int64)) & (
        clustering.labels >= 0)


def frame_visibility(scene, xyz):
    """For every train camera of ``scene``: which points lie in its
    frustum (``pcd_in_frame_mask``) and their view depths
    (``pcd_pixel_coords``), as [F, N] bool and [F, N] tensors."""
    frames = range(len(scene.train_cameras))
    return (torch.stack([scene.pcd_in_frame_mask(xyz, f) for f in frames]),
            torch.stack([scene.pcd_pixel_coords(xyz, f)[1] for f in frames]))


def frame_stats(inside, depth, weights):
    """For every camera at once: the share of the ``weights`` [N] mass (a
    cluster's 0/1 mask) in its frustum and its weighted mean depth there,
    from ``frame_visibility``. Returns (frac [F], depth [F])."""
    wi = weights[None] * inside
    cnt = wi.sum(dim=1)
    frac = cnt / torch.clamp(weights.sum(), min=1.0)
    mdepth = (wi * depth).sum(dim=1) / torch.clamp(cnt, min=1e-6)
    return frac, mdepth


@torch.no_grad()
def render_instance_previews(scene, state: SurfelState,
                             clustering: Clustering, workspace: str,
                             bg=None, min_size: int = MIN_SOLID_CLUSTER,
                             close_depth: float = 4.0,
                             duplicate_capacity=None,
                             device="cuda") -> np.ndarray:
    """A preview render of each solid cluster, for choosing ids by eye.

    For each solid cluster: the first frame that sees > 90% of its surfels
    at mean depth < ``close_depth`` (else the first that sees > 50%)
    renders ONLY the cluster's surfels into
    ``instance_render/<cluster_id>.png``. Also writes
    ``solid_cluster_mask.npy`` and ``solid_cluster.ply`` (the solid surfels
    as an RGB cloud). Returns the solid-cluster mask."""
    from ..device import resolve_device
    from ..renderer import render
    dev = resolve_device(device)
    state = state.to(dev)
    bg = torch.zeros(3, device=dev) if bg is None else torch.as_tensor(
        bg, dtype=torch.float32, device=dev)
    render_dir = os.path.join(workspace, "instance_render")
    os.makedirs(render_dir, exist_ok=True)
    solid = np.zeros(clustering.labels.shape[0], bool)

    cams = scene.train_cameras
    inside, depth = (t.to(dev) for t in frame_visibility(
        scene, state.params.xyz))
    for cid, size in zip(clustering.cluster_ids, clustering.cluster_sizes):
        if size < min_size:
            break   # sizes are sorted descending
        cmask = clustering.labels == int(cid)
        solid |= cmask
        fracs, depths = (_host(t) for t in frame_stats(
            inside, depth,
            torch.as_tensor(cmask, dtype=torch.float32, device=dev)))
        good = np.where((fracs > 0.9) & (depths < close_depth))[0]
        if good.size:
            pick = int(good[0])
        else:
            fallback = np.where(fracs > 0.5)[0]
            pick = int(fallback[0]) if fallback.size else -1
        if pick < 0:
            continue
        res = render(cams[pick], state, bg,
                     opacity_mask=torch.as_tensor(cmask, device=dev),
                     duplicate_capacity=duplicate_capacity, device=dev)
        _save_png(os.path.join(render_dir, f"{int(cid):05d}.png"),
                  _host(res.render))

    np.save(os.path.join(workspace, "solid_cluster_mask.npy"), solid)
    _save_rgb_ply(os.path.join(workspace, "solid_cluster.ply"),
                  _host(state.params.xyz)[solid], _dc_rgb(state)[solid])
    return solid


def _save_png(path, img):
    from PIL import Image
    Image.fromarray((np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)
                    ).save(path)


def _dc_rgb(state: SurfelState) -> np.ndarray:
    """Approximate per-surfel RGB from the SH DC band (C0·dc + 0.5)."""
    dc = _host(state.params.features_dc).reshape(state.capacity, -1)[:, :3]
    return np.clip(0.28209479177387814 * dc + 0.5, 0, 1)


def _save_rgb_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Minimal ASCII xyz+rgb PLY (the reference's ``save_rgb_ply``)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {xyz.shape[0]}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        f.writelines(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                     f"{c[0]} {c[1]} {c[2]}\n"
                     for p, c in zip(xyz, (rgb * 255).astype(np.uint8)))


def removal_mask_for_instances(clustering: Clustering, instance_ids,
                               all_solid: bool = False,
                               min_size: int = MIN_SOLID_CLUSTER
                               ) -> np.ndarray:
    """The removal mask [C] bool: the chosen instance ids or, with
    ``all_solid``, every solid cluster (the reference's
    ``generate_pcd_valid_mask``)."""
    if all_solid:
        return solid_cluster_mask(clustering, min_size)
    sel = np.asarray(list(instance_ids), np.int64)
    return np.isin(clustering.labels, sel) & (clustering.labels >= 0)
