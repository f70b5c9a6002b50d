"""TemporalBilateralFilter equivalent: cross-frame disparity smoothing.

Flags mirror ``depth_estimation/TemporalBilateralFilter.cpp:40-59``. Each
output frame is filtered over the frames within ``time_radius`` that exist
on disk for both color and disparity, on the card
(``filters.temporal_bilateral``); camera by camera, so each input file is
read once, and written to
``<output_root>/disparity_time_filtered_levels/level_N/<cam>/<frame>.pfm``.

    python -m facebook360_dep_tpu_torch.cli.temporal_bilateral_filter --rig <rig.json> \\
        --input_root <root> --output_root <out> --level 0 --first 000000 --last 000002 \\
        [--use_foreground_masks true]
"""

from __future__ import annotations

import argparse
import logging
import math
import os

import numpy as np
import torch

from .. import resolve_device
from ..core import camera as cam, imagetypes, io
from ..depth.pipeline import generate_fov_masks
from ..ops import cost as cost_ops, filters

log = logging.getLogger("temporal")

TEMPORAL_SPACE_RADIUS_MIN = 1
TEMPORAL_SPACE_RADIUS_MAX = 1


def _frame_path(root, level, cam_id, frame):
    return io.frame_path(os.path.join(root, f"level_{level}", cam_id), frame)


def _frame_window(root, level, cam_id, frame_idx, time_radius):
    """Frames within +-time_radius that exist on disk (populateMinMaxFrame)."""
    lo, hi = frame_idx, frame_idx
    for f in range(frame_idx - time_radius, frame_idx + time_radius + 1):
        if os.path.exists(_frame_path(root, level, cam_id, io.frame_name(f))):
            lo, hi = min(lo, f), max(hi, f)
    return lo, hi


def main(argv=None, *, device=None):
    """Parse ``argv`` and write the outputs; ``device`` None means the card."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_root", required=True)
    p.add_argument("--output_root", required=True)
    p.add_argument("--rig", required=True)
    p.add_argument("--color", default="")
    p.add_argument("--disparity", default="")
    p.add_argument("--foreground_masks", default="")
    p.add_argument("--cameras", default="")
    p.add_argument("--first", default="000000")
    p.add_argument("--last", default="000000")
    p.add_argument("--level", type=int, default=0)
    p.add_argument("--output_formats", default="")
    p.add_argument("--resolution", type=int, default=2048)
    p.add_argument("--sigma", type=float, default=0.01)
    p.add_argument("--space_radius", type=int, default=-1)
    p.add_argument("--time_radius", type=int, default=2)
    p.add_argument("--use_foreground_masks", type=lambda v: str(v).lower() in ("1", "true"), default=False)
    p.add_argument("--weight_r", type=float, default=1.0)
    p.add_argument("--weight_g", type=float, default=1.0)
    p.add_argument("--weight_b", type=float, default=0.5)
    p.add_argument("--threads", type=int, default=-1)
    args = p.parse_args(argv)
    dev = resolve_device(device)

    color = args.color or imagetypes.image_dir(args.input_root, "color_levels")
    disparity = args.disparity or imagetypes.image_dir(args.output_root, "disparity_levels")
    fg_root = args.foreground_masks or imagetypes.image_dir(args.input_root, "foreground_masks_levels")

    rig = cam.filter_destinations(cam.load_rig(args.rig), args.cameras)
    nrig = cam.normalize_rig(rig)
    scale = cost_ops.LEVEL_SCALE ** args.level
    space_radius = (max(math.ceil(TEMPORAL_SPACE_RADIUS_MAX * scale), TEMPORAL_SPACE_RADIUS_MIN)
                    if args.space_radius == -1 else args.space_radius)
    formats = {f for f in args.output_formats.split(",") if f} | {"pfm"}

    windows = {}
    for cur in range(int(args.first), int(args.last) + 1):
        lo, hi = _frame_window(color, args.level, rig.ids[0], cur, args.time_radius)
        lo2, hi2 = _frame_window(disparity, args.level, rig.ids[0], cur, args.time_radius)
        windows[cur] = (max(lo, lo2), min(hi, hi2))
    fov_masks = None
    for i, cam_id in enumerate(rig.ids):
        loaded = {}  # frame -> (guide, disparity, mask): each file is read once per camera
        for cur, (lo, hi) in windows.items():
            for f in range(lo, hi + 1):
                if f in loaded:
                    continue
                frame = io.frame_name(f)
                d = io.read_disparity(_frame_path(disparity, args.level, cam_id, frame))
                if fov_masks is None:
                    fov_masks = generate_fov_masks(nrig, d.shape, dev).cpu().numpy()
                m = fov_masks[i]
                if args.use_foreground_masks:
                    m = m & io.read_mask(_frame_path(fg_root, args.level, cam_id, frame))
                loaded[f] = (io.read_color(_frame_path(color, args.level, cam_id, frame))[..., :3], d, m)
            for f in [f for f in loaded if f < lo]:
                del loaded[f]
            guides, disps, masks = zip(*(loaded[f] for f in range(lo, hi + 1)))
            out = filters.temporal_bilateral(
                torch.from_numpy(np.stack(guides)).to(dev),
                torch.from_numpy(np.stack(disps)).to(dev),
                torch.from_numpy(np.stack(masks)).to(dev),
                cur - lo,
                sigma=args.sigma,
                spatial_radius=space_radius,
                weights=(args.weight_r, args.weight_g, args.weight_b),
            ).cpu().numpy()
            for ext in sorted(formats):
                path = imagetypes.gen_filename(
                    args.output_root, "disparity_time_filtered_levels", args.level, cam_id, io.frame_name(cur), ext)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                io.write_disparity(path, out)
            log.info("filtered %s frame %s (window %s..%s)", cam_id, cur, lo, hi)


if __name__ == "__main__":
    main()
