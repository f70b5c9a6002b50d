"""UpsampleDisparity equivalent: color-guided disparity upsampling to the
output resolution. Flags mirror ``depth_estimation/UpsampleDisparity.cpp:37-55``;
the upsample follows ``UpsampleDisparityLib.cpp:93-220`` (masked nearest or
Lanczos4 upsize, NaN fill, background fill), then with ``--color`` the
joint bilateral filter guided by the full-resolution color runs on the
card. Writes ``<output>/<cam>/<frame>.<format>``.

    python -m facebook360_dep_tpu_torch.cli.upsample_disparity --rig <rig.json> \\
        --disparity <dir at the input level> --output <dir> --resolution 2048 \\
        [--color <full-res color dir>] [--foreground_masks_in <masks at the input level> \\
         --foreground_masks_out <masks at the output level> --background_disp <bg at the output level>]
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from .. import resolve_device
from ..core import camera as cam, io
from ..depth import pipeline as depth_pipeline
from ..depth.pipeline import generate_fov_masks
from ..ops import filters

log = logging.getLogger("upsample")


def get_radius(size_hw, size_up_wh) -> int:
    """UpsampleDisparityLib.cpp:93-96: radius = scale^2 + 1."""
    scale = float(size_up_wh[0]) / float(size_hw[1])
    return int(scale * scale + 1)


def main(argv=None, *, device=None):
    """Parse ``argv`` and write the outputs; ``device`` None means the card."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--disparity", required=True, help="input-resolution disparity dir")
    p.add_argument("--output", required=True)
    p.add_argument("--resolution", type=int, required=True, help="output width (px)")
    p.add_argument("--rig", required=True)
    p.add_argument("--background_disp", default="", help="output-resolution bg disparity dir")
    p.add_argument("--background_frame", default="000000")
    p.add_argument("--cameras", default="")
    p.add_argument("--color", default="", help="output-resolution color dir (enables bilateral)")
    p.add_argument("--first", default="000000")
    p.add_argument("--last", default="000000")
    p.add_argument("--foreground_masks_in", default="")
    p.add_argument("--foreground_masks_out", default="")
    p.add_argument("--height", type=int, default=-1)
    p.add_argument("--output_formats", default="")
    p.add_argument("--sigma", type=float, default=0.05)
    p.add_argument("--weight_r", type=float, default=1.0)
    p.add_argument("--weight_g", type=float, default=0.5)
    p.add_argument("--weight_b", type=float, default=0.5)
    p.add_argument("--threads", type=int, default=-1)
    args = p.parse_args(argv)
    dev = resolve_device(device)

    rig = cam.filter_destinations(cam.load_rig(args.rig), args.cameras)
    nrig = cam.normalize_rig(rig)
    res = rig.cameras.resolution[0]
    if args.height == -1:
        height = int(round(float(res[1] / res[0]) * args.resolution))
        height += height % 2  # force even (UpsampleDisparity.cpp:90)
    else:
        height = args.height
    size_up = (args.resolution, height)
    formats = [f for f in (args.output_formats or "pfm").split(",") if f]
    use_fg = bool(args.foreground_masks_in)

    fov_small = fov_up = None

    def load(root, cam_id, frame, loader):
        return loader(io.frame_path(os.path.join(root, cam_id), frame))

    for f in range(int(args.first), int(args.last) + 1):
        frame = io.frame_name(f)
        for i, cam_id in enumerate(rig.ids):
            disp = load(args.disparity, cam_id, frame, io.read_disparity)
            if fov_small is None:
                fov_small = generate_fov_masks(nrig, disp.shape, dev).cpu().numpy()
                fov_up = generate_fov_masks(nrig, (size_up[1], size_up[0]), dev).cpu().numpy()
            bg_up = (load(args.background_disp, cam_id, args.background_frame, io.read_disparity)
                     if args.background_disp else np.zeros((size_up[1], size_up[0]), np.float32))
            mask_up = np.ones((size_up[1], size_up[0]), bool)
            if use_fg:
                mask = load(args.foreground_masks_in, cam_id, frame, io.read_mask)
                if args.foreground_masks_out:
                    mask_up = load(args.foreground_masks_out, cam_id, frame, io.read_mask)
                up = torch.from_numpy(depth_pipeline.upsample_disparity_fg(
                    disp, fov_small[i] & mask, fov_up[i] & mask_up, bg_up, size_up)).to(dev)
            else:
                up = depth_pipeline.upsample_disparity_init(torch.from_numpy(disp).to(dev), size_up)

            if args.color:
                radius = get_radius(disp.shape, size_up)
                color = load(args.color, cam_id, frame, io.read_color)[..., :3]
                if color.shape[:2] != (size_up[1], size_up[0]):
                    color = io.resize_image(color, size_up)
                log.info("bilateral radius %d on %s %s", radius, cam_id, frame)
                up = filters.joint_bilateral(
                    up, torch.from_numpy(color).to(dev), torch.from_numpy(mask_up).to(dev), radius,
                    sigma=args.sigma, weights=(args.weight_r, args.weight_g, args.weight_b))
            up = up.cpu().numpy()
            out_dir = os.path.join(args.output, cam_id)
            os.makedirs(out_dir, exist_ok=True)
            for ext in formats:
                io.write_disparity(os.path.join(out_dir, f"{frame}.{ext.lstrip('.')}"), up)
            log.info("upsampled %s %s -> %dx%d", cam_id, frame, size_up[0], size_up[1])


if __name__ == "__main__":
    main()
