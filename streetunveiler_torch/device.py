"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA request without a CUDA
    device raises instead of carrying on silently on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def strict_fp32() -> None:
    """Turn TF32 off for float32 matmuls and cuDNN convolutions, process
    wide. On a card, cuDNN runs float32 convolutions (SSIM's blur) in TF32
    by default, which keeps about 3 decimal digits; the training entry
    points call this so that the step computes in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
