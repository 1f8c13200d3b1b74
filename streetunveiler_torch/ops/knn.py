"""Nearest-neighbor distances (counterpart of
``streetunveiler_tpu/ops/knn.py``: ``mean_sq_dist_to_3nn`` and
``mean_dist_to_reference``), on the host with scipy's KD-tree."""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def mean_sq_dist_to_3nn(points: np.ndarray) -> np.ndarray:
    """Per-point mean squared distance to the 3 nearest neighbors
    (reference ``dist3knn``)."""
    points = np.asarray(points, np.float32)
    tree = cKDTree(points)
    d, _ = tree.query(points, k=4)        # first neighbor is the point itself
    return np.mean(d[:, 1:] ** 2, axis=1).astype(np.float32)


def mean_dist_to_reference(query: np.ndarray, reference: np.ndarray,
                           k: int = 3) -> np.ndarray:
    """Per-query mean distance to the k nearest reference points (the
    reference's ``meanDistFromReferencePcd``, which the unveil stage's
    mask expansion uses)."""
    tree = cKDTree(np.asarray(reference, np.float32))
    d, _ = tree.query(np.asarray(query, np.float32), k=k)
    return np.mean(d, axis=1).astype(np.float32)
