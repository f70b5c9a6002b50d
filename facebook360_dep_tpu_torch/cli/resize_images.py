"""Pyramid construction: resize color or mask frames to every level width.

Mirrors ``scripts/render/resize.py`` (INTER_AREA to the pyramid widths, a
threshold for masks) over the directory contract, on the host. Heights keep
the frame's aspect, rounded and then made even; every level is written as a
16-bit PNG to ``<output>/level_N/<cam>/<frame>.png``.

    python -m facebook360_dep_tpu_torch.cli.resize_images --rig <rig.json> \\
        --color <root>/video/color --output <root>/video/color_levels --first 000000 --last 000002
    # masks: binarize every level
    python -m facebook360_dep_tpu_torch.cli.resize_images --rig <rig.json> \\
        --color <root>/video/foreground_masks --output <root>/video/foreground_masks_levels --threshold 0.5
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from ..core import camera as cam, imagetypes, io

log = logging.getLogger("resize")


def level_sizes(full_wh, widths=imagetypes.PYRAMID_WIDTHS):
    """[(level, (w, h))]: h = round(h0 * w / w0), then made even (from
    2048x1536: 1536, 768, 384, 192, 150, 96, 76, 60, 46, 38)."""
    w0, h0 = full_wh
    out = []
    for level, w in enumerate(widths):
        h = int(round(h0 * w / w0))
        h += h % 2
        out.append((level, (w, h)))
    return out


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rig", required=True)
    p.add_argument("--color", required=True, help="full-res input color dir (per camera)")
    p.add_argument("--output", required=True, help="output levels dir (level_N/cam)")
    p.add_argument("--first", default="000000")
    p.add_argument("--last", default="000000")
    p.add_argument("--cameras", default="")
    p.add_argument("--threshold", type=float, default=-1.0, help=">=0: binarize (masks)")
    p.add_argument("--widths", default=",".join(str(w) for w in imagetypes.PYRAMID_WIDTHS))
    args = p.parse_args(argv)

    rig = cam.filter_destinations(cam.load_rig(args.rig), args.cameras)
    widths = [int(w) for w in args.widths.split(",") if w]

    for f in range(int(args.first), int(args.last) + 1):
        frame = io.frame_name(f)
        for cam_id in rig.ids:
            img = io.read_color(io.frame_path(os.path.join(args.color, cam_id), frame))
            for level, (w, h) in level_sizes((img.shape[1], img.shape[0]), widths):
                resized = io.resize_image(img, (w, h))
                if args.threshold >= 0:
                    resized = (resized > args.threshold).astype(np.float32)
                out_dir = os.path.join(args.output, f"level_{level}", cam_id)
                os.makedirs(out_dir, exist_ok=True)
                io.write_color(os.path.join(out_dir, frame + ".png"), resized, bit_depth=16)
            log.info("resized %s %s to %d levels", cam_id, frame, len(widths))


if __name__ == "__main__":
    main()
