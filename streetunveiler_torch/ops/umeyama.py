"""Similarity alignment (counterpart of ``streetunveiler_tpu/ops/
umeyama.py``): the Kabsch-Umeyama least-squares fit that replaces the
reference's ``superpose3d``, target ≈ c·R·source + t. Host numpy in
float64: an SVD of a 3x3 over a few hundred camera centres.
"""

from __future__ import annotations

import numpy as np


def umeyama(target: np.ndarray, source: np.ndarray,
            allow_scale: bool = True):
    """Least-squares similarity transform: target ≈ c·R·source + t.

    Returns (rmsd, R [3,3], t [3], c). Shapes [N,3]/[N,3], N ≥ 3.
    """
    target = np.asarray(target, np.float64)
    source = np.asarray(source, np.float64)
    mu_t = target.mean(axis=0)
    mu_s = source.mean(axis=0)
    tc = target - mu_t
    sc = source - mu_s

    cov = tc.T @ sc / source.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt

    if allow_scale:
        var_s = (sc ** 2).sum() / source.shape[0]
        c = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        c = 1.0
    t = mu_t - c * R @ mu_s
    resid = target - (c * source @ R.T + t)
    rmsd = float(np.sqrt((resid ** 2).sum(axis=1).mean()))
    return rmsd, R, t, c


def apply_similarity(points, R, t, c):
    return c * np.asarray(points, np.float64) @ np.asarray(R).T + t
