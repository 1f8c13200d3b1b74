"""Paired-directory evaluation (counterpart of ``streetunveiler_tpu/
evaluation/metrics.py``).

``evaluate_dirs`` walks two image directories pairwise (sorted name order)
and reports mean PSNR and SSIM (``train/losses.py``). LPIPS comes with the
evaluation networks (ROADMAP item 15): a weight file is refused until
then. ``frechet_distance``, ``activation_stats`` and ``fid_from_dirs`` are
FID's math around a feature function the caller passes.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..train.losses import psnr, ssim


def _load_dir(path):
    from PIL import Image
    names = sorted(f for f in os.listdir(path)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    for n in names:
        yield n, np.asarray(Image.open(os.path.join(path, n)).convert("RGB"),
                            np.float32) / 255.0


@torch.no_grad()
def evaluate_dirs(render_dir: str, gt_dir: str,
                  lpips_weights: Optional[str] = None,
                  device="cuda") -> dict:
    """Mean PSNR and SSIM over the images of ``render_dir`` that have a
    same-named ground truth in ``gt_dir``, computed on ``device``."""
    if lpips_weights:
        raise NotImplementedError(
            "LPIPS is not ported to the PyTorch build yet: it comes with the "
            "evaluation networks, item 15 (ROADMAP.md)")
    dev = resolve_device(device)
    psnrs, ssims = [], []
    gt_files = dict(_load_dir(gt_dir))
    for name, img in _load_dir(render_dir):
        if name not in gt_files:
            continue
        a = torch.as_tensor(img, device=dev)
        b = torch.as_tensor(gt_files[name], device=dev)
        psnrs.append(float(psnr(a, b)))
        ssims.append(float(ssim(a, b)))
    return {"n": len(psnrs), "psnr": float(np.mean(psnrs)) if psnrs else None,
            "ssim": float(np.mean(ssims)) if ssims else None}


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID's Fréchet distance between two Gaussians. A singular product of
    covariances (fewer samples than feature dimensions) is regularized
    with ``eps·I`` on both factors when its plain square root is not
    finite, as ``pytorch_fid`` does."""
    import warnings

    from scipy import linalg
    diff = mu1 - mu2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # LinAlgWarning on singular input
        covmean, _ = linalg.sqrtm(sigma1 @ sigma2, disp=False)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean, _ = linalg.sqrtm(
            (sigma1 + offset) @ (sigma2 + offset), disp=False)
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0.0, atol=1e-3):
            raise ValueError(
                f"sqrtm produced a significantly imaginary component "
                f"({np.max(np.abs(np.diagonal(covmean).imag)):.2e}); the "
                f"feature covariances are too degenerate for a meaningful "
                f"FID — use more samples")
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1 + sigma2 - 2.0 * covmean))


def activation_stats(features: np.ndarray):
    """features [N, D] → (mu, sigma) for ``frechet_distance``."""
    return features.mean(axis=0), np.cov(features, rowvar=False)


def fid_from_dirs(render_dir: str, gt_dir: str,
                  feature_fn: Callable[[np.ndarray], np.ndarray]) -> float:
    """FID between two directories through ``feature_fn`` (an [H, W, 3]
    image in [0, 1] → a feature vector)."""
    def feats(d):
        return np.stack([np.asarray(feature_fn(img))
                         for _, img in _load_dir(d)])
    return frechet_distance(*activation_stats(feats(render_dir)),
                            *activation_stats(feats(gt_dir)))
