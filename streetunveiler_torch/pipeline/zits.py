"""ZITS++ inpainting adapter (counterpart of ``streetunveiler_tpu/pipeline/
zits.py``, the reference's ``utils/zits_utils.py:143``).

The reference wraps the external ZITS-PlusPlus stack (line detector,
edge/line transformers, structure upsampler, FTR generator) behind a
``ZitsGuidance`` class whose ``inpaint`` fills the stage-C key frames. The
networks and their checkpoints live in the external repository; this
module holds what the wrapper adds around them:

* ``masked_position_encoding``: the masked transformer's positional
  encoding (``zits_utils.py:82-134``), an iterative 8-neighbour dilation
  from the known region and four quadrant dilations, on ``device`` as 0/1
  tensors (``max_pool2d`` on zero-padded masks, exact for 0/1 values);
* ``edge_nms``: edge non-max suppression, the stand-in for the C++
  ``nms`` of the ZITS submodule (``zits_utils.py:294``);
* ``sharpen``: the post-upsample ``sigmoid((x + 2) * 2)``;
* ``sobel_xy``: the gradient branch's inputs (``zits_utils.py:249-259``);
* ``prepare_batch``: the model inputs at the reference's resolutions (the
  512/256 pyramid, nearest/area mask policy, ``zits_utils.py:205-240``).

Resizes stay on the host with PIL (NEAREST, BOX, BILINEAR), whose pixels
``torch.nn.functional.interpolate`` does not reproduce.
``ZitsInpainter`` composes these with the external models and satisfies
the ``pipeline.inpaint.Inpainter`` protocol.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

# numpy's float32 rad2deg constant, 180f / πf
_RAD2DEG_F32 = float(np.float32(180.0) / np.float32(np.pi))

# left, right, top, bottom zero padding before a 2x2 max pool that reads
# the four quadrant neighbourhoods of zits_utils.py:74-78 (d_filter1-4:
# up-left, down-left, up-right, down-right, each with the pixel itself)
_QUADRANT_PADS = [(1, 0, 1, 0), (1, 0, 0, 1), (0, 1, 1, 0), (0, 1, 0, 1)]


def _resize(img: np.ndarray, h: int, w: int, nearest: bool = False):
    """PIL resize: NEAREST with ``nearest``, else BOX to downscale and
    BILINEAR otherwise (the reference's ``resize``, zits_utils.py:57-72)."""
    from PIL import Image
    if img.shape[:2] == (h, w):
        return img.copy()
    mode = Image.NEAREST if nearest else (
        Image.BOX if img.shape[0] > h and img.shape[1] > w else Image.BILINEAR)
    if img.dtype == np.uint8:
        return np.asarray(Image.fromarray(img).resize((w, h), mode))
    return np.asarray(Image.fromarray(
        (np.clip(img, 0, 1) * 255).astype(np.uint8)).resize((w, h), mode)
    ).astype(np.float32) / 255.0


def masked_position_encoding(mask: np.ndarray, grid: int = 256,
                             max_pos: int = 128, device="cuda"):
    """Masked transformer positional encoding (zits_utils.py:82-134).

    ``mask``: [H, W], nonzero = hole. Returns numpy ``(rel_pos, abs_pos,
    direct)``: ``rel_pos`` int32 in [0, 128) at the input resolution, the
    dilation step at which each hole pixel is first reached from the known
    region on the 256 grid; ``abs_pos`` the unclipped step on the 256
    grid; ``direct`` [H, W, 4] int32, which of the four quadrant dilations
    reached the pixel. Known pixels are 0 everywhere. The dilations run on
    ``device``.
    """
    dev = resolve_device(device)
    ori = np.asarray(mask) != 0
    h0, w0 = ori.shape
    m = _resize(ori.astype(np.uint8) * 255, grid, grid, nearest=False)
    known = torch.as_tensor(m == 0, dtype=torch.float32,
                            device=dev)[None, None]
    pos = torch.zeros((grid, grid), dtype=torch.int32, device=dev)
    direct = torch.zeros((4, grid, grid), dtype=torch.int32, device=dev)
    i = 0
    while bool(known.min() < 1.0) and i < grid:
        i += 1
        grown = F.max_pool2d(known, 3, stride=1, padding=1)
        pos[(grown - known)[0, 0] == 1] = i
        for d, pad in enumerate(_QUADRANT_PADS):
            reach = F.max_pool2d(F.pad(known, pad), 2, stride=1) - known
            direct[d][reach[0, 0] == 1] = 1
        known = grown
    abs_pos = pos.cpu().numpy()
    rel_pos = np.clip(abs_pos, 0, max_pos - 1)
    direct = direct.permute(1, 2, 0).cpu().numpy()
    if (h0, w0) != (grid, grid):
        rel_pos = _resize(rel_pos.astype(np.uint8), h0, w0, nearest=True
                          ).astype(np.int32)
        direct = np.stack(
            [_resize(direct[..., d].astype(np.uint8), h0, w0, nearest=True)
             for d in range(4)], axis=-1).astype(np.int32)
        rel_pos[~ori] = 0
        direct[~ori, :] = 0
    return rel_pos, abs_pos, direct


def sobel_xy(gray):
    """3x3 Sobel gradients of a [..., H, W] image (zits_utils.py:249-259),
    edge-padded; float32 tensors on the input's device."""
    g = torch.as_tensor(gray, dtype=torch.float32)
    shape = g.shape
    pad = F.pad(g.reshape(-1, 1, *shape[-2:]), (1, 1, 1, 1),
                mode="replicate")[:, 0]
    sx = ((pad[:, :-2, 2:] + 2 * pad[:, 1:-1, 2:] + pad[:, 2:, 2:])
          - (pad[:, :-2, :-2] + 2 * pad[:, 1:-1, :-2] + pad[:, 2:, :-2]))
    sy = ((pad[:, 2:, :-2] + 2 * pad[:, 2:, 1:-1] + pad[:, 2:, 2:])
          - (pad[:, :-2, :-2] + 2 * pad[:, :-2, 1:-1] + pad[:, :-2, 2:]))
    return sx.reshape(shape), sy.reshape(shape)


def _shift(a, dy: int, dx: int):
    """Zero-filled shift of [..., H, W]: out[y, x] = a[y + dy, x + dx]."""
    h, w = a.shape[-2:]
    out = torch.zeros_like(a)
    out[..., max(0, -dy):min(h, h - dy), max(0, -dx):min(w, w - dx)] = \
        a[..., max(0, dy):min(h, h + dy), max(0, dx):min(w, w + dx)]
    return out


def edge_nms(edge, binary_threshold: int = 50):
    """Edge non-max suppression (zits_utils.py:294) of soft edge maps
    [..., H, W] in [0, 1]: a pixel survives iff it clears
    ``binary_threshold``/255 and is a local maximum along its gradient
    direction, quantized to four ways, as the C++ NMS of the ZITS
    submodule. Returns 0/1 float32 maps on the input's device."""
    e = torch.as_tensor(edge, dtype=torch.float32)
    keep = e >= (binary_threshold / 255.0)
    gx, gy = sobel_xy(e)
    ang = torch.remainder(torch.atan2(gy, gx) * _RAD2DEG_F32, 180.0)
    # the neighbours across the edge, along the gradient
    pairs = [((0, 1), (0, -1)),     # ~horizontal gradient
             ((-1, 1), (1, -1)),    # ~45°
             ((-1, 0), (1, 0)),     # ~vertical
             ((-1, -1), (1, 1))]    # ~135°
    sector = torch.div(ang + 22.5, 45, rounding_mode="floor").to(
        torch.int32) % 4
    out = torch.zeros_like(e)
    for s, (o1, o2) in enumerate(pairs):
        ridge = (e >= _shift(e, *o1)) & (e >= _shift(e, *o2))
        out = torch.where((sector == s) & ridge & keep, 1.0, out)
    return out


def sharpen(x):
    """The post-upsample squash ``sigmoid((x + 2) * 2)``
    (zits_utils.py:296-298), as a float32 tensor."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return 1.0 / (1.0 + torch.exp(-2.0 * (x + 2.0)))


def _rgb2gray(img: np.ndarray) -> np.ndarray:
    return (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2]).astype(np.float32)


def prepare_batch(image: np.ndarray, mask: np.ndarray, test_size: int = 512,
                  use_gradient: bool = False, device="cuda") -> dict:
    """The model inputs of one image and hole mask (``ZitsGuidance``'s batch,
    zits_utils.py:205-262): the image and mask at ``test_size`` and 256,
    the fixed 512x512 input of the line detector, the positional encoding
    and, with ``use_gradient``, the Sobel gradients of the grey image at
    256 and ``test_size``; tensors on ``device``."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).float()
    chw = lambda a: t(a).permute(2, 0, 1)[None]
    norm = lambda a: (chw(a) - 0.5) / 0.5
    ts = test_size
    hole = (np.asarray(mask) != 0).astype(np.uint8) * 255
    img = _resize(np.asarray(image, np.float32), ts, ts)
    m = _resize(hole, ts, ts, nearest=True)
    img256 = _resize(img, 256, 256)
    m256 = (_resize(m, 256, 256) > 0).astype(np.float32)
    # the HAWP line detector always takes a 512x512 input, whatever the
    # test size (zits_utils.py:213,223)
    img512 = img if ts == 512 else _resize(
        np.asarray(image, np.float32), 512, 512)
    m512 = m if ts == 512 else _resize(hole, 512, 512, nearest=True)
    # abs_pos stays on the 256 grid; rel_pos and direct come back at the
    # mask's resolution (zits_utils.py:122-133)
    rel_pos, abs_pos, direct = masked_position_encoding(m, device=dev)
    b = dict(
        image=norm(img), img_256=norm(img256),
        mask=chw(((m > 127)[..., None]).astype(np.float32)),
        mask_256=chw(m256[..., None]),
        mask_512=chw(((m512 > 127)[..., None]).astype(np.float32)),
        img_512=chw(img512),
        rel_pos=t(rel_pos)[None].long(),
        abs_pos=t(abs_pos)[None].long(),
        direct=t(direct)[None].long(),
        imgh=torch.tensor([[ts]]), imgw=torch.tensor([[ts]]),
        size_ratio=-1, H=-1)
    if use_gradient:
        gray = lambda a: torch.as_tensor(_rgb2gray(a) * 255.0, device=dev)
        sx, sy = sobel_xy(gray(img256))
        sxh, syh = sobel_xy(gray(img))
        b.update(gradientx=sx[None, None], gradienty=sy[None, None],
                 gradientx_hr=sxh[None, None], gradienty_hr=syh[None, None])
    return {k: (v.to(dev) if hasattr(v, "to") else v) for k, v in b.items()}


class ZitsInpainter:
    """In-process ZITS++ adapter with the reference's inference flow
    (``zits_utils.py:143-346``): line detection on the 512 input, edge and
    line completion at 256, NMS and structure upsampling to the test size,
    the FTR generator, and a resize back to the input size.

    Needs the external ZITS-PlusPlus checkout and its checkpoints (the
    reference does not vendor them either); construction raises
    ``RuntimeError`` when they are missing or fail to import. Use
    ``DirectoryInpainter`` to run the model out of band on another host.
    """

    def __init__(self, repo: str, ckpt_root: str, device: str = "cuda",
                 test_size: int = 512, binary_threshold: int = 50,
                 exp_name: str = "model_512"):
        import sys
        if not os.path.isdir(repo):
            raise RuntimeError(f"ZITS-PlusPlus repo not found at {repo!r}")
        sys.path.insert(0, repo)
        try:
            from base.parse_config import ConfigParser  # type: ignore
            from dnnlib.util import get_obj_by_name  # type: ignore
            from trainers.pl_trainers import wf_inference_test  # type: ignore
        except ImportError as e:
            raise RuntimeError(f"ZITS-PlusPlus imports failed: {e}") from e
        self._wf_inference = wf_inference_test
        self.device = resolve_device(device)
        self.test_size = test_size
        self.binary_threshold = binary_threshold

        import argparse
        ns = argparse.Namespace(
            config=os.path.join(repo, "configs/config_zitspp_finetune.yml"),
            exp_name=exp_name, dynamic_size=False, use_ema=True,
            ckpt_resume=os.path.join(ckpt_root, exp_name, "models",
                                     "last.ckpt"),
            wf_ckpt=os.path.join(ckpt_root, "best_lsm_hawp.pth"),
            save_path="outputs", test_size=test_size, eval=False,
            save_image_only=True, obj_removal=True, resume=None)
        cfg = ConfigParser.from_args(ns, mkdir=False)
        build = lambda key, **kw: get_obj_by_name(cfg[key])(**kw)
        self.model = get_obj_by_name(cfg["PLTrainer"]
                                     if cfg.config.get("PLTrainer")
                                     else "trainers.pl_trainers."
                                          "FinetunePLTrainer")(
            build("structure_upsample_class"), build("edgeline_tsr_class"),
            build("grad_tsr_class"), build("g_class", config=cfg["g_args"]),
            build("d_class", config=cfg["d_args"]), cfg,
            os.path.join(ckpt_root, exp_name), use_ema=True,
            dynamic_size=False, test_only=True)
        self.model.reset_ema()
        sd = torch.load(ns.ckpt_resume, map_location="cpu")
        self.model.load_state_dict(sd.get("state_dict", sd), strict=False)
        if hasattr(self.model, "wf"):
            self.model.wf.load_state_dict(
                torch.load(ns.wf_ckpt, map_location="cpu")["model"])
        self.model.to(self.device)
        (self.model.ftr_ema if hasattr(self.model, "ftr_ema")
         else self.model.ftr).eval()
        self.use_gradient = bool(cfg["g_args"].get("use_gradient", False))
        if self.use_gradient and test_size != 512:
            # the reference's 256 path swaps edgeline_tsr for grad_tsr
            # (zits_utils.py:308-319), which is not implemented here
            raise NotImplementedError(
                "use_gradient requires test_size=512 (the grad_tsr "
                "completion branch for test_size=256 is not implemented)")

    def inpaint(self, image: np.ndarray, mask: np.ndarray,
                reference: Optional[np.ndarray] = None) -> np.ndarray:
        torch.manual_seed(123456)
        h0, w0 = np.asarray(image).shape[:2]
        with torch.no_grad():
            b = prepare_batch(image, mask, self.test_size, self.use_gradient,
                              self.device)
            b["line_256"] = self._wf_inference(
                self.model.wf, b["img_512"], h=256, w=256,
                masks=b["mask_512"], valid_th=0.85, mask_th=0.85,
                obj_remove=True)
            edge, line = self.model.edgeline_tsr(
                b["img_256"], b["line_256"], masks=b["mask_256"])
            line = b["line_256"] * (1 - b["mask_256"]) + line * b["mask_256"]
            size, ts = 256, self.test_size
            edge_nms_t = None
            while size * 2 <= ts:          # the HR structure loop (:291-301)
                line = self.model.structure_upsample(line)[0]
                edge_nms_t = edge_nms(edge[:, 0], self.binary_threshold
                                      )[:, None].to(edge)
                edge_nms_t = sharpen(
                    self.model.structure_upsample(edge_nms_t)[0])
                line = sharpen(line)
                size *= 2
            up = lambda x: F.interpolate(x, size=(ts, ts), mode="bilinear",
                                         align_corners=False)
            edge = up(edge)
            if edge_nms_t is not None:
                edge_nms_t = up(edge_nms_t)
                edge = torch.where(edge >= 0.25, edge_nms_t, edge)
            b["edge"], b["line"] = edge.detach(), up(line).detach()
            runner = (self.model.run_G_ema if hasattr(self.model, "run_G_ema")
                      else self.model.run_G)
            out, _ = runner(b)
            out = (torch.clamp(out, -1, 1) + 1) / 2
            out_np = out[0].permute(1, 2, 0).cpu().numpy()
        return _resize(out_np.astype(np.float32), h0, w0)
