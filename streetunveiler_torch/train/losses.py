"""Reconstruction losses (counterpart of ``streetunveiler_tpu/train/
losses.py``): L1/L2, PSNR, the 11×11 σ=1.5 windowed SSIM and the stage-1
photometric loss. Images are channels-last [H, W, C] at every public
function.

SSIM's blur is a separable depthwise ``F.conv2d`` with zero padding, as
the reference's. On a card a float32 convolution runs through cuDNN in
TF32 unless ``torch.backends.cudnn.allow_tf32`` is False; the training
entry points turn it off.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred, target):
    return torch.mean((pred - target) ** 2)


def psnr(pred, target, dim=None):
    """PSNR in dB over all elements (or per ``dim``)."""
    mse = torch.mean((pred - target) ** 2, dim=dim)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float):
    xs = [math.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma ** 2))
          for x in range(window_size)]
    s = sum(xs)
    return tuple(x / s for x in xs)


def _blur(x, window_size: int, sigma: float):
    """Separable depthwise Gaussian blur of x [C, H, W], zero padding."""
    c = x.shape[0]
    r = window_size // 2
    w = torch.tensor(_gaussian_window(window_size, sigma), dtype=x.dtype,
                     device=x.device)
    kh = w.view(1, 1, -1, 1).expand(c, 1, window_size, 1)
    kw = w.view(1, 1, 1, -1).expand(c, 1, 1, window_size)
    x = F.conv2d(x[None], kh, padding=(r, 0), groups=c)
    x = F.conv2d(x, kw, padding=(0, r), groups=c)
    return x[0]


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """Mean windowed SSIM of [H, W, C] images in [0, 1]. The five blurred
    maps (μ1, μ2, E[x1²], E[x2²], E[x1·x2]) go through one depthwise
    convolution pair as 5·C channels."""
    a = img1.permute(2, 0, 1)
    b = img2.permute(2, 0, 1)
    c = a.shape[0]
    blurred = _blur(torch.cat([a, b, a * a, b * b, a * b], dim=0),
                    window_size, sigma)
    mu1, mu2, e11, e22, e12 = torch.split(blurred, c, dim=0)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map)


def photometric_loss(pred, target, lambda_dssim: float = 0.2):
    """(1−λ)·L1 + λ·(1−SSIM), the stage-1 RGB loss."""
    return ((1.0 - lambda_dssim) * l1_loss(pred, target)
            + lambda_dssim * (1.0 - ssim(pred, target)))
