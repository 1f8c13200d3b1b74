"""Evaluation CLI (counterpart of ``streetunveiler_tpu/cli/evaluate.py``,
the reference's ``eval_lpips.py`` / ``eval_lpips_fid.sh``):

    python -m streetunveiler_torch.cli.evaluate \
        --render_path <dir> --gt_path <dir> \
        [--lpips_weights lpips_vgg.npz] \
        [--fid --inception_weights inception_fid.npz] [--device cuda]

Prints one JSON object: the mean PSNR and SSIM over the same-named image
pairs, and LPIPS with ``--lpips_weights``. ``--fid`` adds the Fréchet
distance: over InceptionV3 pool3 features with ``--inception_weights``
(an export of pytorch_fid's ``pt_inception-2015-12-05`` checkpoint by
``streetunveiler_torch/tools/export_eval_weights.py``), reported as
``fid``; else over pooled VGG tap features of the LPIPS artifact,
self-consistent across runs but not comparable to Inception FID,
reported as ``fid_vgg``. The networks run on the card by default
(``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--render_path", required=True)
    ap.add_argument("--gt_path", required=True)
    ap.add_argument("--lpips_weights", default="")
    ap.add_argument("--inception_weights", default="",
                    help="inception_fid.npz (tools/export_eval_weights.py) "
                         "for reference-comparable FID")
    ap.add_argument("--fid", action="store_true",
                    help="also report the Frechet distance (InceptionV3 "
                         "pool3 with --inception_weights, else VGG taps)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..evaluation.metrics import evaluate_dirs, fid_from_dirs
    dev = resolve_device(args.device)
    out = evaluate_dirs(args.render_path, args.gt_path,
                        lpips_weights=args.lpips_weights or None,
                        device=dev)
    if args.fid:
        if args.inception_weights and os.path.exists(args.inception_weights):
            from ..evaluation.inception import inception_feature_fn
            out["fid"] = fid_from_dirs(
                args.render_path, args.gt_path,
                inception_feature_fn(args.inception_weights, device=dev))
        elif args.lpips_weights and os.path.exists(args.lpips_weights):
            from ..evaluation.lpips import vgg_feature_fn
            out["fid_vgg"] = fid_from_dirs(
                args.render_path, args.gt_path,
                vgg_feature_fn(args.lpips_weights, device=dev))
        else:
            raise SystemExit("--fid needs --inception_weights "
                             "<inception_fid.npz> (reference protocol) or "
                             "--lpips_weights <lpips_vgg.npz> (VGG-tap "
                             "fallback)")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
