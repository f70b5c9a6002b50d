"""GenerateForegroundMasks equivalent (render/GenerateForegroundMasks.cpp:41-53).

Each frame of each camera is compared with the background frame by
background subtraction (render/foreground.py) on the card, after
both are resized to ``--width`` (INTER_AREA) when they are wider. Masks are
written as 8-bit PNGs, 255 = foreground, to ``<foreground_masks>/<cam>/<frame>.png``.

    python -m facebook360_dep_tpu_torch.cli.generate_foreground_masks --rig <rig.json> \\
        --background_color <root>/background/color --color <root>/video/color \\
        --foreground_masks <root>/video/foreground_masks --first 000000 --last 000002
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from . import resolve_device
from ..core import camera as cam, io
from ..render import foreground

log = logging.getLogger("fgmasks")


def main(argv=None, *, device=None):
    """Parse ``argv`` and write the masks; ``device`` None means the card."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--background_color", required=True)
    p.add_argument("--background_frame", default="000000")
    p.add_argument("--color", required=True)
    p.add_argument("--foreground_masks", required=True)
    p.add_argument("--rig", required=True)
    p.add_argument("--first", required=True)
    p.add_argument("--last", required=True)
    p.add_argument("--cameras", default="")
    p.add_argument("--blur_radius", type=int, default=1)
    p.add_argument("--morph_closing_size", type=int, default=4)
    p.add_argument("--threshold", type=float, default=0.04)
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--threads", type=int, default=-1)
    args = p.parse_args(argv)
    dev = resolve_device(device)

    rig = cam.load_rig(args.rig)
    if args.cameras:
        rig = cam.filter_destinations(rig, args.cameras)

    def load(root, cam_id, frame, size_wh=None):
        img = io.read_color(io.frame_path(os.path.join(root, cam_id), frame))[..., :3]
        if size_wh and img.shape[:2] != (size_wh[1], size_wh[0]):
            img = io.resize_image(img, size_wh)
        return img

    for f in range(int(args.first), int(args.last) + 1):
        frame = io.frame_name(f)
        for cam_id in rig.ids:
            bg = load(args.background_color, cam_id, args.background_frame)
            size_wh = None
            if args.width and bg.shape[1] != args.width:
                size_wh = (args.width, int(round(bg.shape[0] * args.width / bg.shape[1])))
                bg = io.resize_image(bg, size_wh)
            fr = load(args.color, cam_id, frame, size_wh)
            mask = foreground.generate_foreground_mask(
                torch.from_numpy(bg).to(dev), torch.from_numpy(fr).to(dev),
                args.blur_radius, args.threshold, args.morph_closing_size,
            ).cpu().numpy()
            log.info("%s %s: foreground amount: %.2f%%", cam_id, frame, 100.0 * mask.sum() / mask.size)
            out_dir = os.path.join(args.foreground_masks, cam_id)
            os.makedirs(out_dir, exist_ok=True)
            io.write_mask(os.path.join(out_dir, frame + ".png"), mask)


if __name__ == "__main__":
    main()
