"""Semantic point clouds (counterpart of ``streetunveiler_tpu/utils/
pcd.py``, the reference's ``utils/pcd_utils.py``): the voxel downsample
with a semantic majority vote, on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device

# bits per axis of a voxel key, as the JAX package's host library packs
# them: scenes span far fewer than 2^21 voxels an axis
_KEY_BITS = 21


class SemanticPointCloud(NamedTuple):
    points: np.ndarray     # [N, 3] float32
    colors: np.ndarray     # [N, 3] float32 in [0,1]
    semantics: np.ndarray  # [N] int32

    def concat(self, other: "SemanticPointCloud") -> "SemanticPointCloud":
        return SemanticPointCloud(
            np.concatenate([self.points, other.points]),
            np.concatenate([self.colors, other.colors]),
            np.concatenate([self.semantics, other.semantics]))


def voxel_down_sample(pc: SemanticPointCloud, voxel_size: float,
                      agreement: float = 0.8,
                      device="cuda") -> SemanticPointCloud:
    """Voxel-mean downsample with a semantic majority vote, on ``device``
    (numpy in and out).

    The semantics of the JAX package's host library
    (``su_voxel_downsample``), which that package runs whenever its
    library loads: a point's voxel is ``floor(p · inv)`` in float32, with
    ``inv = 1/voxel_size`` rounded to float32 and the smallest key of each
    axis subtracted; a voxel's xyz and rgb are float64 sums over its
    points, in point order, divided by the count and cast to float32; its
    label is the first class with the most votes; a voxel is dropped when
    that count is below ``agreement · count`` (both float32); voxels come
    out in the order of their first point. Every step is deterministic, so
    the card, the CPU and two runs give the same bits. The JAX package's
    numpy fallback differs in two ways: it keys voxels by
    ``floor(p / voxel_size)`` in float64 (a point within rounding of a
    voxel edge can fall in the neighbouring voxel) and emits the voxels in
    sorted key order.
    """
    n = np.asarray(pc.points).shape[0]
    if n == 0:
        return pc
    dev = resolve_device(device)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                    device=dev)
    pts, rgb = f32(pc.points), f32(pc.colors)
    sem = torch.as_tensor(np.asarray(pc.semantics, np.int64), device=dev)
    inv = float(np.float32(1.0) / np.float32(voxel_size))

    cell = torch.floor(pts * inv).to(torch.int64)
    cell = (cell - cell.amin(dim=0)) & ((1 << _KEY_BITS) - 1)
    key = (cell[:, 0] << 2 * _KEY_BITS) | (cell[:, 1] << _KEY_BITS) \
        | cell[:, 2]
    # voxels numbered by their first point
    _, inverse, counts = torch.unique(key, return_inverse=True,
                                      return_counts=True)
    n_vox = counts.shape[0]
    first = torch.full((n_vox,), n, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, inverse, torch.arange(n, device=dev), "amin")
    by_first = torch.argsort(first)
    rank = torch.empty_like(by_first)
    rank[by_first] = torch.arange(n_vox, device=dev)
    slot = rank[inverse]
    counts = counts[by_first]

    # each voxel's sums in point order: its points gathered by a stable
    # sort, then a segment sum that runs through each segment in order
    order = torch.argsort(slot, stable=True)
    vals = torch.cat([pts, rgb], dim=1)[order].to(torch.float64)
    sums = torch.segment_reduce(vals, "sum", lengths=counts, axis=0)
    means = (sums / counts[:, None].to(torch.float64)).to(torch.float32)

    n_classes = max(int(sem.max()) + 1, 1)
    votes = torch.bincount(slot * n_classes + sem,
                           minlength=n_vox * n_classes).view(n_vox,
                                                              n_classes)
    # argmax returns the first of equal maxima
    best = torch.argmax(votes, dim=1)
    best_count = votes.gather(1, best[:, None])[:, 0]
    keep = ~(best_count.to(torch.float32)
             < counts.to(torch.float32) * float(np.float32(agreement)))
    means = means[keep].cpu().numpy()
    return SemanticPointCloud(points=np.ascontiguousarray(means[:, :3]),
                              colors=np.ascontiguousarray(means[:, 3:]),
                              semantics=best[keep].to(torch.int32)
                              .cpu().numpy())
