"""The street scene written as a Waymo segment, in the layout the Waymo
reader reads (``scene/readers/waymo.py``):

    python -m streetunveiler_torch.tools.waymo_segment --out /tmp/seg \\
        [--frames 50 --rays 150000 --surfels 300000 --width 1920 \\
         --height 1280] [--device cpu]

writes ``<out>/segment`` (``scenario.pt``, ``images/camera_*/``,
``lidars/lidar_TOP/``) and ``<out>/segment_colmap/input_masks/``, which
``cli.train --scene waymo --source_path <out>/segment --colmap_path
<out>/segment_colmap`` trains on. The rig is the reader's three front
cameras, FRONT and FRONT_LEFT/RIGHT yawed ∓45°, stepped ``STEP`` metres
along the street a frame. Each camera's image is its render of the street
(``tools/street.py``), its semantic mask the semantic render's argmax (the
sky prior where nothing is rendered) as one Cityscapes train id a class,
and each frame's LiDAR sweep ``rays`` rays from the sensor, above the
cameras, to surfel centres (a choice seeded by the frame), ``INVALID`` of
them with range 0, as Waymo stores a missing return. Below 1920 pixels of
width the focal length and the splats shrink with the width, so that the
scene looks the same (``street.MINI``'s rule).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os

import numpy as np
import torch

# the reader's cameras, yaw in degrees (+x is right, so a positive yaw
# turns the camera right)
RIG = (("camera_FRONT", 0.0), ("camera_FRONT_LEFT", -45.0),
       ("camera_FRONT_RIGHT", 45.0))
LIDAR_Y = -0.5     # the sensor above the cameras (y points down)
STEP = 1.0         # metres along the street (+z) a frame
INVALID = 0.05     # share of the rays with range 0 (no return)
# concerned class id -> a Cityscapes train id of that class (road,
# sidewalk, building, vegetation, sky, car)
CONCERNED_TO_CITYSCAPES = (0, 1, 2, 8, 10, 13)


def rig_c2w(frame: int, yaw_deg: float) -> np.ndarray:
    """Camera-to-world of a rig camera at ``frame``: yawed about y,
    ``STEP`` metres a frame along the street (+z)."""
    c, s = np.cos(np.radians(yaw_deg)), np.sin(np.radians(yaw_deg))
    c2w = np.eye(4)
    c2w[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    c2w[2, 3] = STEP * frame
    return c2w


def write_segment(state, root: str, colmap: str, frames: int, rays: int,
                  width: int, height: int, focal: float,
                  device="cuda") -> dict:
    """Write the segment of ``state`` (a street ``SurfelState``) into
    ``root`` and its masks into ``colmap``; renders on ``device``.
    Returns the counts and seconds."""
    import time

    from PIL import Image

    from .. import renderer
    from ..device import resolve_device
    from ..scene.cameras import Camera
    dev = resolve_device(device)
    t0 = time.perf_counter()
    K = np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]])
    observers, views = {}, []
    for rank, (cam, yaw) in enumerate(RIG):
        c2ws = np.stack([rig_c2w(f, yaw) for f in range(frames)])
        observers[cam] = {"data": {
            "c2w": c2ws, "intr": np.repeat(K[None], frames, 0),
            "hw": np.tile([height, width], (frames, 1))}}
        os.makedirs(os.path.join(root, "images", cam))
        views += [(cam, f, f + rank * frames, Camera(
            w2c=torch.tensor(np.linalg.inv(c2w), dtype=torch.float32,
                             device=dev),
            K=torch.tensor(K, dtype=torch.float32, device=dev),
            width=width, height=height)) for f, c2w in enumerate(c2ws)]
    torch.save({"observers": observers}, os.path.join(root, "scenario.pt"))
    os.makedirs(os.path.join(colmap, "input_masks"))
    cap = renderer.measure_duplicate_capacity(
        [v[3] for v in views], state, sample=len(views), device=dev)
    to_city = torch.tensor(CONCERNED_TO_CITYSCAPES, dtype=torch.uint8,
                           device=dev)
    bg = torch.zeros(3, device=dev)

    def save(img, ids, cam, frame, idx):
        Image.fromarray(img).save(os.path.join(root, "images", cam,
                                               f"{frame:08d}.jpg"))
        np.savez(os.path.join(colmap, "input_masks", f"{idx:05d}.npz"), ids)

    # the images and masks are encoded by a pool while the next view
    # renders
    with torch.no_grad(), concurrent.futures.ThreadPoolExecutor(8) as pool:
        futures = []
        for cam, frame, idx, camera in views:
            res = renderer.render(camera, state, bg, duplicate_capacity=cap,
                                  device=dev)
            sem = renderer.render_semantic(camera, state,
                                           duplicate_capacity=cap,
                                           device=dev).argmax(dim=-1)
            if bool(res.overflow):
                raise RuntimeError(f"{cam} frame {frame} overflowed its "
                                   "duplicate capacity")
            img = (res.render.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
            futures.append(pool.submit(save, img.cpu().numpy(),
                                       to_city[sem].cpu().numpy(), cam,
                                       frame, idx))
        for fut in futures:
            fut.result()
    render_s = time.perf_counter() - t0

    xyz = state.params.xyz[state.alive].cpu().numpy()
    lidar_dir = os.path.join(root, "lidars", "lidar_TOP")
    os.makedirs(lidar_dir)
    valid = 0
    for frame in range(frames):
        rng = np.random.default_rng(frame)
        o = np.array([0.0, LIDAR_Y, STEP * frame], np.float32)
        p = xyz[rng.choice(len(xyz), rays, replace=False)]
        dist = np.linalg.norm(p - o, axis=1)
        ranges = np.where(rng.random(rays) < INVALID, 0.0, dist)
        valid += int((ranges > 0).sum())
        np.savez(os.path.join(lidar_dir, f"{frame:08d}.npz"),
                 rays_o=np.tile(o, (rays, 1)),
                 rays_d=((p - o) / dist[:, None]).astype(np.float32),
                 ranges=ranges.astype(np.float32))
    return dict(cameras=len(views), frames=frames, width=width,
                height=height, duplicate_capacity=cap,
                lidar_rays=rays * frames, lidar_valid=valid,
                renders_and_images_s=render_s,
                seconds=time.perf_counter() - t0)


def main(argv=None):
    from . import street
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--rays", type=int, default=150_000)
    ap.add_argument("--surfels", type=int, default=street.N_SURFELS)
    ap.add_argument("--width", type=int, default=street.W)
    ap.add_argument("--height", type=int, default=street.H)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    scale = street.W / args.width
    state = street.street_state(args.surfels, device=args.device,
                                scale=scale)
    root = os.path.join(args.out, "segment")
    colmap = os.path.join(args.out, "segment_colmap")
    counts = write_segment(state, root, colmap, args.frames,
                           min(args.rays, args.surfels), args.width,
                           args.height, street.FOCAL / scale,
                           device=args.device)
    print(json.dumps(dict(source_path=root, colmap_path=colmap, **counts)))
    return counts


if __name__ == "__main__":
    main()
