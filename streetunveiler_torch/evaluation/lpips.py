"""LPIPS (the VGG-16 variant) as a torch module (counterpart of
``streetunveiler_tpu/evaluation/lpips.py``).

The reference scores unveiling with mean VGG-LPIPS over paired
directories. This is the LPIPS-VGG computation written out, since the
port depends on no torchvision or lpips package: conv features after
relu{1_2, 2_2, 3_3, 4_3, 5_3}, unit normalization along the channels
(1e-10 inside the square root), the learned 1×1 heads as a contraction,
the spatial mean and the sum over the five layers. The weights come from
the ``.npz`` artifact that ``streetunveiler_torch/tools/
export_eval_weights.py`` writes (``conv0..conv25``: the 13 conv weight and
bias pairs; ``lin0..lin4``: the [1, C] heads), the same file the JAX
package loads.

``vgg_feature_fn`` pools the five taps into 1472 features, the VGG-tap
feature space the evaluation CLI uses for FID when no Inception weights
are given (not comparable to Inception FID values).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device, strict_fp32

# VGG16 conv plan: (out_channels, pool_before)
_VGG_PLAN = [(64, False), (64, False), (128, True), (128, False),
             (256, True), (256, False), (256, False), (512, True),
             (512, False), (512, False), (512, True), (512, False),
             (512, False)]
# feature taps after these conv indices (post-ReLU): relu1_2 … relu5_3
_TAPS = (1, 3, 6, 9, 12)
TAP_CHANNELS = (64, 128, 256, 512, 512)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPSVGG(nn.Module):
    """VGG-16's 13 convs (3×3, padding 1) with the LPIPS heads. Inputs are
    NCHW in [0, 1]."""

    def __init__(self):
        super().__init__()
        convs, cin = [], 3
        for cout, _ in _VGG_PLAN:
            convs.append(nn.Conv2d(cin, cout, 3, padding=1))
            cin = cout
        self.convs = nn.ModuleList(convs)
        self.lins = nn.ParameterList(
            [nn.Parameter(torch.zeros(1, c)) for c in TAP_CHANNELS])
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))

    def features(self, x):
        """x [N, 3, H, W] in [0, 1] → the five tap features (NCHW). The
        2×2 pools floor odd sizes (600 → 300 → 150 → 75 → 37)."""
        h = (x * 2.0 - 1.0 - self.shift) / self.scale
        feats = []
        for i, (conv, (_, pool)) in enumerate(zip(self.convs, _VGG_PLAN)):
            if pool:
                h = F.max_pool2d(h, 2)
            h = F.relu(conv(h))
            if i in _TAPS:
                feats.append(h)
        return feats

    def distance(self, x0, x1):
        """LPIPS between two NCHW batches → [N]."""
        total = 0.0
        for a, b, lin in zip(self.features(x0), self.features(x1),
                             self.lins):
            na = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True)
                                + 1e-10)
            nb = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True)
                                + 1e-10)
            d = (na - nb) ** 2
            wd = torch.einsum("nchw,oc->nohw", d, lin)   # the 1×1 head
            total = total + wd.mean(dim=(1, 2, 3))
        return total


def load_lpips_weights(path: str, device="cuda") -> LPIPSVGG:
    """The ``.npz`` artifact → an ``LPIPSVGG`` in eval mode on ``device``.
    Shapes are checked against the network's."""
    dev = resolve_device(device)
    blob = np.load(path)
    model = LPIPSVGG()
    with torch.no_grad():
        for i, conv in enumerate(model.convs):
            for name, key in (("weight", f"conv{2 * i}"),
                              ("bias", f"conv{2 * i + 1}")):
                arr = np.asarray(blob[key], np.float32)
                p = getattr(conv, name)
                if tuple(arr.shape) != tuple(p.shape):
                    raise ValueError(f"{key}: expected {tuple(p.shape)}, "
                                     f"got {arr.shape}")
                p.copy_(torch.from_numpy(arr))
        for i, lin in enumerate(model.lins):
            arr = np.asarray(blob[f"lin{i}"], np.float32)
            if tuple(arr.shape) != tuple(lin.shape):
                raise ValueError(f"lin{i}: expected {tuple(lin.shape)}, "
                                 f"got {arr.shape}")
            lin.copy_(torch.from_numpy(arr))
    return model.eval().requires_grad_(False).to(dev)


def _nchw(img, dev):
    """An [H, W, 3] image (numpy or tensor) → [1, 3, H, W] on ``dev``."""
    t = torch.as_tensor(np.asarray(img, np.float32) if not torch.is_tensor(
        img) else img, dtype=torch.float32, device=dev)
    return t.permute(2, 0, 1)[None]


@torch.no_grad()
def lpips_pair(model: LPIPSVGG, img0, img1):
    """LPIPS distance for a pair of [H, W, 3] images in [0, 1] (a 0-d
    tensor on the model's device)."""
    dev = model.shift.device
    return model.distance(_nchw(img0, dev), _nchw(img1, dev))[0]


def lpips_fn(weights_path: str, device="cuda"):
    """A pairwise LPIPS callable on ``device``; TF32 is turned off so the
    convolutions run in full float32."""
    strict_fp32()
    model = load_lpips_weights(weights_path, device)
    return lambda img0, img1: lpips_pair(model, img0, img1)


def vgg_feature_fn(weights_path: str, device="cuda"):
    """Image [H, W, 3] in [0, 1] → the five taps' spatial means,
    concatenated (1472 features, numpy) for FID. Self-consistent across
    runs; not comparable to Inception FID values."""
    strict_fp32()
    model = load_lpips_weights(weights_path, device)
    dev = model.shift.device

    @torch.no_grad()
    def fn(img):
        feats = model.features(_nchw(img, dev))
        return torch.cat([f.mean(dim=(0, 2, 3)) for f in feats]
                         ).cpu().numpy()

    return fn
