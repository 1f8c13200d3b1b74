"""Nearest-neighbor distances (counterpart of
``streetunveiler_tpu/ops/knn.py:mean_sq_dist_to_3nn``), on the host with
scipy's KD-tree."""

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
