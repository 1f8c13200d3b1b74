"""FID InceptionV3 (pool3 features) as a torch module (counterpart of
``streetunveiler_tpu/evaluation/inception.py``).

The network is torchvision's InceptionV3 graph with the FID flavour the
JAX package implements, written out here because the port depends on no
torchvision or pytorch_fid package:

* every in-block average pool divides by the window's true size
  (``count_include_pad=False``);
* the last block's pool branch (Mixed_7c) pools with a 3×3 stride-1 max;
* the input is resized to 299×299, bilinear with ``align_corners=False``
  and ``antialias=True``, then mapped [0, 1] → [-1, 1]. The JAX package
  resizes with ``jax.image.resize(..., "bilinear")``, which antialiases
  when it downsamples; pytorch_fid does not, so a downsampled input
  departs from pytorch_fid's features by the JAX package's own choice,
  and the port keeps it to match the package it is held against.

Weights load from the ``.npz`` of torch ``state_dict`` tensors that
``streetunveiler_torch/tools/export_eval_weights.py --inception`` writes;
each BatchNorm (eps 1e-3) is folded into its conv at load time, in numpy
float32 as the JAX package folds it. The output is the 2048-d global
average pool ("pool3") that ``evaluation.metrics.fid_from_dirs`` feeds to
the Fréchet distance.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device, strict_fp32

_BN_EPS = 1e-3


def _fold_conv(blob, prefix):
    """conv + BN (torch state_dict names) → folded (w, b), OIHW numpy."""
    w = np.asarray(blob[f"{prefix}.conv.weight"], np.float32)
    gamma = np.asarray(blob[f"{prefix}.bn.weight"], np.float32)
    beta = np.asarray(blob[f"{prefix}.bn.bias"], np.float32)
    mean = np.asarray(blob[f"{prefix}.bn.running_mean"], np.float32)
    var = np.asarray(blob[f"{prefix}.bn.running_var"], np.float32)
    s = gamma / np.sqrt(var + _BN_EPS)
    return w * s[:, None, None, None], beta - mean * s


def conv_shapes():
    """{state_dict prefix: (O, I, kh, kw)} for every conv of the FID
    InceptionV3: the weight contract of ``load_inception_weights``."""
    s = {"Conv2d_1a_3x3": (32, 3, 3, 3), "Conv2d_2a_3x3": (32, 32, 3, 3),
         "Conv2d_2b_3x3": (64, 32, 3, 3), "Conv2d_3b_1x1": (80, 64, 1, 1),
         "Conv2d_4a_3x3": (192, 80, 3, 3)}
    for m, cin, pf in [("Mixed_5b", 192, 32), ("Mixed_5c", 256, 64),
                       ("Mixed_5d", 288, 64)]:
        s.update({f"{m}.branch1x1": (64, cin, 1, 1),
                  f"{m}.branch5x5_1": (48, cin, 1, 1),
                  f"{m}.branch5x5_2": (64, 48, 5, 5),
                  f"{m}.branch3x3dbl_1": (64, cin, 1, 1),
                  f"{m}.branch3x3dbl_2": (96, 64, 3, 3),
                  f"{m}.branch3x3dbl_3": (96, 96, 3, 3),
                  f"{m}.branch_pool": (pf, cin, 1, 1)})
    s.update({"Mixed_6a.branch3x3": (384, 288, 3, 3),
              "Mixed_6a.branch3x3dbl_1": (64, 288, 1, 1),
              "Mixed_6a.branch3x3dbl_2": (96, 64, 3, 3),
              "Mixed_6a.branch3x3dbl_3": (96, 96, 3, 3)})
    for m, c7 in [("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160),
                  ("Mixed_6e", 192)]:
        s.update({f"{m}.branch1x1": (192, 768, 1, 1),
                  f"{m}.branch7x7_1": (c7, 768, 1, 1),
                  f"{m}.branch7x7_2": (c7, c7, 1, 7),
                  f"{m}.branch7x7_3": (192, c7, 7, 1),
                  f"{m}.branch7x7dbl_1": (c7, 768, 1, 1),
                  f"{m}.branch7x7dbl_2": (c7, c7, 7, 1),
                  f"{m}.branch7x7dbl_3": (c7, c7, 1, 7),
                  f"{m}.branch7x7dbl_4": (c7, c7, 7, 1),
                  f"{m}.branch7x7dbl_5": (192, c7, 1, 7),
                  f"{m}.branch_pool": (192, 768, 1, 1)})
    s.update({"Mixed_7a.branch3x3_1": (192, 768, 1, 1),
              "Mixed_7a.branch3x3_2": (320, 192, 3, 3),
              "Mixed_7a.branch7x7x3_1": (192, 768, 1, 1),
              "Mixed_7a.branch7x7x3_2": (192, 192, 1, 7),
              "Mixed_7a.branch7x7x3_3": (192, 192, 7, 1),
              "Mixed_7a.branch7x7x3_4": (192, 192, 3, 3)})
    for m, cin in [("Mixed_7b", 1280), ("Mixed_7c", 2048)]:
        s.update({f"{m}.branch1x1": (320, cin, 1, 1),
                  f"{m}.branch3x3_1": (384, cin, 1, 1),
                  f"{m}.branch3x3_2a": (384, 384, 1, 3),
                  f"{m}.branch3x3_2b": (384, 384, 3, 1),
                  f"{m}.branch3x3dbl_1": (448, cin, 1, 1),
                  f"{m}.branch3x3dbl_2": (384, 448, 3, 3),
                  f"{m}.branch3x3dbl_3a": (384, 384, 1, 3),
                  f"{m}.branch3x3dbl_3b": (384, 384, 3, 1),
                  f"{m}.branch_pool": (192, cin, 1, 1)})
    return s


def _maxpool3s2(x):
    return F.max_pool2d(x, 3, stride=2)


def _avgpool3s1p1(x):
    """3×3 stride-1 pad-1 average that divides by the window's true size
    (the FID-Inception flavour)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _maxpool3s1p1(x):
    return F.max_pool2d(x, 3, stride=1, padding=1)


class FIDInceptionV3(nn.Module):
    """The FID InceptionV3 up to pool3, with folded BatchNorms: one
    ``Conv2d`` (with bias) per ``conv_shapes`` entry, its dots spelled
    ``__`` in the module dict."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleDict({
            n.replace(".", "__"): nn.Conv2d(i, o, (kh, kw))
            for n, (o, i, kh, kw) in conv_shapes().items()})

    def _conv(self, x, name, stride=1, padding=0):
        c = self.convs[name.replace(".", "__")]
        return F.relu(F.conv2d(x, c.weight, c.bias, stride=stride,
                               padding=padding))

    def _block_a(self, m, x):
        c = self._conv
        b1 = c(x, f"{m}.branch1x1")
        b5 = c(c(x, f"{m}.branch5x5_1"), f"{m}.branch5x5_2", padding=2)
        b3 = c(c(c(x, f"{m}.branch3x3dbl_1"), f"{m}.branch3x3dbl_2",
                 padding=1), f"{m}.branch3x3dbl_3", padding=1)
        bp = c(_avgpool3s1p1(x), f"{m}.branch_pool")
        return torch.cat([b1, b5, b3, bp], dim=1)

    def _block_b(self, x):
        c = self._conv
        b3 = c(x, "Mixed_6a.branch3x3", stride=2)
        bd = c(c(c(x, "Mixed_6a.branch3x3dbl_1"),
                 "Mixed_6a.branch3x3dbl_2", padding=1),
               "Mixed_6a.branch3x3dbl_3", stride=2)
        return torch.cat([b3, bd, _maxpool3s2(x)], dim=1)

    def _block_c(self, m, x):
        c = self._conv
        b1 = c(x, f"{m}.branch1x1")
        b7 = c(c(c(x, f"{m}.branch7x7_1"), f"{m}.branch7x7_2",
                 padding=(0, 3)), f"{m}.branch7x7_3", padding=(3, 0))
        bd = x
        for i, pad in zip(range(1, 6), [0, (3, 0), (0, 3), (3, 0), (0, 3)]):
            bd = c(bd, f"{m}.branch7x7dbl_{i}", padding=pad)
        bp = c(_avgpool3s1p1(x), f"{m}.branch_pool")
        return torch.cat([b1, b7, bd, bp], dim=1)

    def _block_d(self, x):
        c = self._conv
        b3 = c(c(x, "Mixed_7a.branch3x3_1"), "Mixed_7a.branch3x3_2",
               stride=2)
        b7 = c(c(c(c(x, "Mixed_7a.branch7x7x3_1"),
                   "Mixed_7a.branch7x7x3_2", padding=(0, 3)),
                 "Mixed_7a.branch7x7x3_3", padding=(3, 0)),
               "Mixed_7a.branch7x7x3_4", stride=2)
        return torch.cat([b3, b7, _maxpool3s2(x)], dim=1)

    def _block_e(self, m, x, pool):
        c = self._conv
        b1 = c(x, f"{m}.branch1x1")
        b3 = c(x, f"{m}.branch3x3_1")
        b3 = torch.cat([c(b3, f"{m}.branch3x3_2a", padding=(0, 1)),
                        c(b3, f"{m}.branch3x3_2b", padding=(1, 0))], dim=1)
        bd = c(x, f"{m}.branch3x3dbl_1")
        bd = c(bd, f"{m}.branch3x3dbl_2", padding=1)
        bd = torch.cat([c(bd, f"{m}.branch3x3dbl_3a", padding=(0, 1)),
                        c(bd, f"{m}.branch3x3dbl_3b", padding=(1, 0))],
                       dim=1)
        bp = c(pool(x), f"{m}.branch_pool")
        return torch.cat([b1, b3, bd, bp], dim=1)

    def forward(self, x):
        """x [N, H, W, 3] in [0, 1] → pool3 features [N, 2048]."""
        h = x.permute(0, 3, 1, 2)
        h = F.interpolate(h, size=(299, 299), mode="bilinear",
                          align_corners=False, antialias=True)
        h = h * 2.0 - 1.0
        c = self._conv
        h = c(h, "Conv2d_1a_3x3", stride=2)
        h = c(h, "Conv2d_2a_3x3")
        h = c(h, "Conv2d_2b_3x3", padding=1)
        h = _maxpool3s2(h)
        h = c(h, "Conv2d_3b_1x1")
        h = c(h, "Conv2d_4a_3x3")
        h = _maxpool3s2(h)
        for m in ["Mixed_5b", "Mixed_5c", "Mixed_5d"]:
            h = self._block_a(m, h)
        h = self._block_b(h)
        for m in ["Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"]:
            h = self._block_c(m, h)
        h = self._block_d(h)
        h = self._block_e("Mixed_7b", h, _avgpool3s1p1)
        # FIDInceptionE_2: the checkpoint's last block pools with MAX
        h = self._block_e("Mixed_7c", h, _maxpool3s1p1)
        return h.mean(dim=(2, 3))


def load_inception_weights(path: str, device="cuda") -> FIDInceptionV3:
    """npz of torch state_dict tensors → ``FIDInceptionV3`` in eval mode on
    ``device``, its BatchNorms folded, shape-checked against
    ``conv_shapes``."""
    dev = resolve_device(device)
    blob = np.load(path)
    model = FIDInceptionV3()
    with torch.no_grad():
        for n, shp in conv_shapes().items():
            got = tuple(np.asarray(blob[f"{n}.conv.weight"]).shape)
            if got != shp:
                raise ValueError(f"{n}.conv.weight: expected {shp}, got "
                                 f"{got} — not a pytorch_fid InceptionV3 "
                                 f"export?")
            w, b = _fold_conv(blob, n)
            conv = model.convs[n.replace(".", "__")]
            conv.weight.copy_(torch.from_numpy(w))
            conv.bias.copy_(torch.from_numpy(b))
    return model.eval().requires_grad_(False).to(dev)


@torch.no_grad()
def inception_pool3(model: FIDInceptionV3, x):
    """x [N, H, W, 3] in [0, 1] (numpy or tensor) → pool3 features
    [N, 2048] on the model's device."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    return model(x)


def inception_feature_fn(weights_path: str, device="cuda"):
    """Image [H, W, 3] in [0, 1] → [2048] pool3 features (numpy): the
    ``feature_fn`` of ``evaluation.metrics.fid_from_dirs``. TF32 is turned
    off so the convolutions run in full float32."""
    strict_fp32()
    model = load_inception_weights(weights_path, device)
    return lambda img: inception_pool3(model, np.asarray(img)[None])[0] \
        .cpu().numpy()
