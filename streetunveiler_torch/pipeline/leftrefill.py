"""LeftRefill reference-guided inpainting adapter (counterpart of
``streetunveiler_tpu/pipeline/leftrefill.py``, the reference's
``utils/left_refill_utils.py:25-369``).

LeftRefill repaints the right half of a side-by-side [reference | source]
canvas with a Stable-Diffusion-2 inpainting model conditioned on 50
learned prompt tokens; the reference uses it to propagate unveiled frames
consistently (``1_optimization.py:144-199``). The model and its
checkpoints live in the external LeftRefill repository; this module holds
what the wrapper adds around them, on the host with PIL:

* ``compose_side_by_side``: the 512x1024 canvas with the left
  (reference) half unmasked (``left_refill_utils.py:302-325``);
* ``split_right_half``: the repainted source half, back at the original
  size (``:269,:341``);
* ``pad_to_multiple``: the edge padding to a multiple of 64 (``pad_image``,
  ``:200-204``);
* ``build_prompt``: the repeated special-token prompt (``:327-331``).

``LeftRefillInpainter`` composes these with the external model and
satisfies the ``pipeline.inpaint.Inpainter`` protocol (``reference`` is
the guide image).
"""

from __future__ import annotations

import os
from glob import glob
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device


def pad_to_multiple(img: np.ndarray, multiple: int = 64,
                    minimum: int = 128) -> np.ndarray:
    """Edge-PAD [H, W, ...] bottom/right up to the next multiple of
    ``multiple`` per side, at least ``minimum`` — the reference's
    ``pad_image`` (``left_refill_utils.py:200-204``:
    ``max(2, ceil(size/64))·64`` with ``np.pad(mode='edge')``). A no-op at
    the default 512×1024 canvas."""
    h, w = img.shape[:2]
    H = max(minimum, -(-h // multiple) * multiple)
    W = max(minimum, -(-w // multiple) * multiple)
    if (H, W) == (h, w):
        return img
    pad = [(0, H - h), (0, W - w)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad, mode="edge")


def build_prompt(repeat: int = 50, token: str = "<special-token>") -> str:
    """'<special-token0> <special-token1> …' (:327-331)."""
    return " ".join(token.replace(">", f"{i}>") for i in range(repeat))


def compose_side_by_side(source: np.ndarray, mask: np.ndarray,
                         reference: np.ndarray, size: int = 512):
    """Build the LeftRefill canvas (:302-325).

    ``source``/``reference``: [H, W, 3] float in [0, 1]; ``mask``:
    [H, W], nonzero = repaint.  Both images are resized to
    ``size``×``size`` (bicubic; mask bilinear-then-binarized), then
    concatenated [reference | source] along width with the reference half
    unmasked.  Returns ``(canvas [size, 2·size, 3], mask2 [size, 2·size])``.
    """
    from PIL import Image
    to8 = lambda a: (np.clip(np.asarray(a, np.float32), 0, 1)
                     * 255).astype(np.uint8)
    rs = lambda a, m: np.asarray(Image.fromarray(a).resize((size, size), m))
    src = rs(to8(source), Image.BICUBIC).astype(np.float32) / 255.0
    ref = rs(to8(reference), Image.BICUBIC).astype(np.float32) / 255.0
    m8 = rs(((np.asarray(mask) != 0) * 255).astype(np.uint8), Image.BILINEAR)
    m = (m8 > 0).astype(np.float32)
    canvas = np.concatenate([ref, src], axis=1)
    mask2 = np.concatenate([np.zeros_like(m), m], axis=1)
    return canvas, mask2


def split_right_half(result: np.ndarray, origin_hw) -> np.ndarray:
    """Crop the repainted source (right) half and restore the original
    size (:269,:341)."""
    from PIL import Image
    h, w = result.shape[:2]
    right = result[:, w // 2:]
    oh, ow = origin_hw
    u8 = (np.clip(right, 0, 1) * 255).astype(np.uint8)
    out = np.asarray(Image.fromarray(u8).resize((ow, oh), Image.BICUBIC))
    return out.astype(np.float32) / 255.0


class LeftRefillInpainter:
    """In-process LeftRefill adapter with the reference's sampling flow
    (:277-346): side-by-side canvas, 50-token learned prompt, DDIM with
    classifier-free guidance scale 2.5, right-half crop-back.

    Needs the external LeftRefill checkout + the ``ref_guided_inpainting``
    checkpoint directory; raises ``RuntimeError`` when they are missing or
    fail to import. Use ``DirectoryInpainter`` to run the model out of
    band on another host.
    """

    def __init__(self, repo: str,
                 ckpt_dir: str = "check_points/ref_guided_inpainting",
                 device: str = "cuda", size: int = 512,
                 repeat_sp_token: int = 50):
        import sys
        if not os.path.isdir(repo):
            raise RuntimeError(f"LeftRefill repo not found at {repo!r}")
        sys.path.insert(0, repo)
        try:
            from omegaconf import OmegaConf  # type: ignore
            from ldm.models.diffusion.ddim import DDIMSampler  # type: ignore
            from ldm.util import instantiate_from_config  # type: ignore
        except ImportError as e:
            raise RuntimeError(f"LeftRefill imports failed: {e}") from e
        self.size = size
        self.prompt = build_prompt(repeat_sp_token)
        root = ckpt_dir if os.path.isabs(ckpt_dir) else os.path.join(
            repo, ckpt_dir)
        cfg = OmegaConf.load(os.path.join(root, "model_config.yaml"))
        model = instantiate_from_config(cfg.model)
        # epoch parse like the reference (split('.ckpt')[0].split('=')[-1])
        # so Lightning names like epoch=12-step=100.ckpt sort correctly
        ckpts = sorted(
            glob(os.path.join(root, "ckpts", "epoch=*.ckpt")),
            key=lambda p: int(os.path.basename(p).split(".ckpt")[0]
                              .split("=")[-1]))
        if not ckpts:
            raise RuntimeError(
                f"no epoch=*.ckpt under {os.path.join(root, 'ckpts')}")
        sd = torch.load(ckpts[-1], map_location="cpu")
        model.load_state_dict(sd.get("state_dict", sd), strict=False)
        if getattr(model, "save_prompt_only", False):
            base = torch.load(os.path.join(
                repo, "pretrained_models", "512-inpainting-ema.ckpt"),
                map_location="cpu")
            model.load_state_dict(base.get("state_dict", base), strict=False)
        self.device = str(resolve_device(device))
        self.model = model.to(self.device).eval()
        self.sampler = DDIMSampler(self.model)

    def inpaint(self, image: np.ndarray, mask: np.ndarray,
                reference: Optional[np.ndarray] = None,
                ddim_steps: int = 50, scale: float = 2.5,
                seed: int = 42) -> np.ndarray:
        if reference is None:
            reference = image           # degenerate: self-guided
        h0, w0 = np.asarray(image).shape[:2]
        canvas, m2 = compose_side_by_side(image, mask, reference, self.size)
        canvas, m2 = pad_to_multiple(canvas), pad_to_multiple(m2[..., None]
                                                              )[..., 0]
        h, w = canvas.shape[:2]
        torch.manual_seed(seed)
        dev = self.device
        with torch.no_grad(), torch.autocast(dev.split(":")[0]) if \
                dev.startswith("cuda") else torch.no_grad():
            img_t = torch.from_numpy(canvas * 2.0 - 1.0).permute(
                2, 0, 1)[None].float().to(dev)
            m_t = torch.from_numpy((m2 > 0.5).astype(np.float32))[
                None, None].to(dev)
            masked = img_t * (1.0 - m_t)
            c = self.model.cond_stage_model.encode([self.prompt])
            cc = torch.cat([
                torch.nn.functional.interpolate(m_t, size=(h // 8, w // 8)),
                self.model.get_first_stage_encoding(
                    self.model.encode_first_stage(masked))], dim=1)
            cond = {"c_concat": [cc], "c_crossattn": [c]}
            uc = self.model.cond_stage_model.encode([""])
            uncond = {"c_concat": [cc], "c_crossattn": [uc]}
            shape = (self.model.channels, h // 8, w // 8)
            # eta=1.0 + explicit seeded start code: the reference's DDIM
            # flow (left_refill_utils.py:146-149,183) samples with full
            # stochasticity from a RandomState(seed) start latent
            start_code = torch.from_numpy(
                np.random.RandomState(seed).randn(
                    1, self.model.channels, h // 8, w // 8)).float().to(dev)
            samples, _ = self.sampler.sample(
                ddim_steps, 1, shape, cond, verbose=False, eta=1.0,
                x_T=start_code,
                unconditional_guidance_scale=scale,
                unconditional_conditioning=uncond)
            dec = self.model.decode_first_stage(samples)
            out = ((dec[0].permute(1, 2, 0).float().cpu().numpy() + 1) / 2)
        out = np.clip(out, 0, 1)
        # composite: keep known pixels from the canvas (mask-blend like the
        # reference's inpainting result assembly, :230-258)
        out = canvas * (1 - m2[..., None]) + out * m2[..., None]
        return split_right_half(out, (h0, w0))
