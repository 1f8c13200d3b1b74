"""Dataset preprocessing (counterpart of ``streetunveiler_tpu/cli/
preprocess.py``, the reference's ``preprocess_script/convert.py`` and its
SegFormer mask scripts):

    python -m streetunveiler_torch.cli.preprocess --source_path /data/scene \
        [--dry_run] [--labels_png /data/labels]

* COLMAP: feature extraction, exhaustive matching, the mapper and the
  undistorter (the reference's ``convert.py:35-91``), run through
  ``subprocess``; the ``colmap`` binary must be on PATH, and the commands
  are only printed without it or with ``--dry_run``.
* Semantic masks: any Cityscapes-trained segmenter can write the
  ``input_masks/<idx>.npz`` files (``np.savez(path, mask)`` of train ids);
  ``--labels_png`` converts a directory of PNG label maps to that layout.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

import numpy as np

def colmap_commands(source_path: str, camera_model: str = "OPENCV"):
    """The four COLMAP stages' command lines, on ``<source_path>/input``
    into ``distorted/`` and back into ``source_path``."""
    db = os.path.join(source_path, "distorted", "database.db")
    img = os.path.join(source_path, "input")
    out = os.path.join(source_path, "distorted", "sparse")
    cmds = [
        ["colmap", "feature_extractor", "--database_path", db,
         "--image_path", img, "--ImageReader.single_camera", "1",
         "--ImageReader.camera_model", camera_model],
        ["colmap", "exhaustive_matcher", "--database_path", db],
        ["colmap", "mapper", "--database_path", db, "--image_path", img,
         "--output_path", out,
         "--Mapper.ba_global_function_tolerance", "0.000001"],
        ["colmap", "image_undistorter", "--image_path", img,
         "--input_path", os.path.join(out, "0"),
         "--output_path", source_path, "--output_type", "COLMAP"],
    ]
    return cmds


def convert_label_pngs(png_dir: str, out_dir: str) -> int:
    """PNG label maps (sorted by name; the first channel of a colour PNG)
    → ``out_dir/<idx>.npz``; returns their count."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    names = sorted(f for f in os.listdir(png_dir) if f.endswith(".png"))
    for i, name in enumerate(names):
        with Image.open(os.path.join(png_dir, name)) as pil:
            arr = np.asarray(pil)
        if arr.ndim == 3:
            arr = arr[..., 0]
        np.savez(os.path.join(out_dir, f"{i:05d}.npz"), arr.astype(np.int64))
    return len(names)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--source_path", required=True)
    ap.add_argument("--camera_model", default="OPENCV")
    ap.add_argument("--dry_run", action="store_true")
    ap.add_argument("--labels_png", default="",
                    help="convert a dir of PNG label maps to input_masks/")
    args = ap.parse_args(argv)

    if args.labels_png:
        n = convert_label_pngs(
            args.labels_png,
            os.path.join(args.source_path, "input_masks"))
        print(f"converted {n} label maps")
        return

    cmds = colmap_commands(args.source_path, args.camera_model)
    have_colmap = shutil.which("colmap") is not None
    for cmd in cmds:
        print("$", " ".join(cmd))
        if args.dry_run or not have_colmap:
            continue
        ret = subprocess.run(cmd).returncode
        if ret != 0:
            print(f"colmap stage failed ({ret})", file=sys.stderr)
            sys.exit(ret)
    if not have_colmap and not args.dry_run:
        print("colmap binary not found — commands printed for execution "
              "on a machine with COLMAP installed", file=sys.stderr)


if __name__ == "__main__":
    main()
