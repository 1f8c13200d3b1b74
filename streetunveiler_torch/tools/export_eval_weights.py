"""Convert the reference evaluation protocol's torch checkpoints to the
``.npz`` weights of ``evaluation/lpips.py`` and ``evaluation/inception.py``
(the port's own copy of the repo-root ``tools/export_eval_weights.py``,
with the same command line and the same artifacts):

    # LPIPS-VGG from the installed `lpips` package (needs lpips+torchvision)
    python -m streetunveiler_torch.tools.export_eval_weights \
        --lpips-from-package lpips_vgg.npz

    # LPIPS-VGG from raw checkpoints (no packages):
    #   vgg16 torchvision weights + lpips repo's vgg.pth linear heads
    python -m streetunveiler_torch.tools.export_eval_weights \
        --vgg16 vgg16-397923af.pth --lpips-lins weights/v0.1/vgg.pth \
        --lpips-out lpips_vgg.npz

    # FID InceptionV3 from pytorch_fid's checkpoint
    python -m streetunveiler_torch.tools.export_eval_weights \
        --inception pt_inception-2015-12-05-21f595ea.pth \
        --inception-out inception_fid.npz

Artifact contracts:
  lpips_vgg.npz      conv0..conv25 (13 conv w/b pairs of VGG16 features) +
                     lin0..lin4 ([1, C] LPIPS linear heads)
  inception_fid.npz  the torch state_dict tensors under their original
                     names (evaluation/inception.py folds the BatchNorms)
"""

from __future__ import annotations

import argparse

import numpy as np

# torchvision's vgg16 `features.{i}` indices of the 13 convs
VGG_CONV_IDS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def _torch_load(path):
    import torch
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(blob, "state_dict"):
        blob = blob.state_dict()
    return blob


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") \
        else np.asarray(t)


def lpips_arrays(vgg: dict, lins: dict) -> dict:
    """torchvision vgg16 and lpips head state dicts → the lpips_vgg.npz
    arrays."""
    blob = {}
    for i, c in enumerate(VGG_CONV_IDS):
        blob[f"conv{2 * i}"] = _np(vgg[f"features.{c}.weight"])
        blob[f"conv{2 * i + 1}"] = _np(vgg[f"features.{c}.bias"])
    for i in range(5):
        blob[f"lin{i}"] = _np(lins[f"lin{i}.model.1.weight"])[:, :, 0, 0]
    return blob


def inception_arrays(sd: dict) -> dict:
    """pytorch_fid state dict → the inception_fid.npz arrays (the
    auxiliary classifier and the fc head dropped)."""
    return {k: _np(v) for k, v in sd.items()
            if not k.startswith(("AuxLogits", "fc."))}


def export_lpips_from_package(out: str) -> None:
    import lpips
    m = lpips.LPIPS(net="vgg")
    blob = {f"conv{i}": _np(p) for i, p in enumerate(m.net.parameters())}
    blob.update({f"lin{i}": _np(lin.model[1].weight)[:, :, 0, 0]
                 for i, lin in enumerate(m.lins)})
    np.savez(out, **blob)
    print(f"wrote {out} ({len(blob)} arrays)")


def export_lpips_from_pth(vgg16_path: str, lins_path: str, out: str) -> None:
    """torchvision vgg16 state_dict + lpips vgg.pth (the `lin{k}.model.1`
    1x1 heads published in the lpips repo) → lpips_vgg.npz."""
    blob = lpips_arrays(_torch_load(vgg16_path), _torch_load(lins_path))
    np.savez(out, **blob)
    print(f"wrote {out} ({len(blob)} arrays)")


def export_inception(pth: str, out: str) -> None:
    blob = inception_arrays(_torch_load(pth))
    np.savez(out, **blob)
    print(f"wrote {out} ({len(blob)} arrays)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--lpips-from-package", metavar="OUT",
                    help="export lpips_vgg.npz via the installed lpips pkg")
    ap.add_argument("--vgg16", help="torchvision vgg16 .pth state_dict")
    ap.add_argument("--lpips-lins",
                    help="lpips repo weights/v0.1/vgg.pth (linear heads)")
    ap.add_argument("--lpips-out", default="lpips_vgg.npz")
    ap.add_argument("--inception",
                    help="pytorch_fid pt_inception-2015-12-05-*.pth")
    ap.add_argument("--inception-out", default="inception_fid.npz")
    args = ap.parse_args(argv)

    did = False
    if args.lpips_from_package:
        export_lpips_from_package(args.lpips_from_package)
        did = True
    if args.vgg16 and args.lpips_lins:
        export_lpips_from_pth(args.vgg16, args.lpips_lins, args.lpips_out)
        did = True
    if args.inception:
        export_inception(args.inception, args.inception_out)
        did = True
    if not did:
        ap.error("nothing to do: pass --lpips-from-package, "
                 "--vgg16+--lpips-lins, and/or --inception")


if __name__ == "__main__":
    main()
