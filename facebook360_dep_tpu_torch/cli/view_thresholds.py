"""Threshold-tuning tools, one subcommand per reference binary. The port of
``facebook360_dep_tpu/cli/view_thresholds.py``; the variance and the masks
are computed on the card.

The reference versions are interactive GLFW windows with sliders
(``render/ViewColorVarianceThresholds.cpp:37-40``,
``render/ViewForegroundMaskThresholds.cpp:36-40``). Headless equivalent:
sweep the threshold range and write a contact sheet of candidate
visualizations plus a JSON report of mask statistics per setting, so the
same tuning decision (pick var_noise_floor / var_high_thresh, or blur radius
+ morphological closing size) is made from files instead of sliders.

- color_variance: visualize local color variance against candidate
  [noise floor, high threshold] bands (feeds DerpCLI --var_noise_floor /
  --var_high_thresh).
- foreground_masks: sweep (threshold, blur_radius, closing_size) for the
  background-subtraction mask (feeds GenerateForegroundMasks).

    python -m facebook360_dep_tpu_torch.cli.view_thresholds color_variance --fullsize_image <png> --output_dir <dir>
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

from . import resolve_device
from ..core import io
from ..ops import sampling
from ..render import foreground

log = logging.getLogger("view_thresholds")


def _load_resized(path, width):
    img = io.read_color(path)
    if width and img.shape[1] != width:
        h = int(round(img.shape[0] * width / img.shape[1]))
        img = io.resize_image(img, (width, h))
    return img


def color_variance(args, device):
    img = _load_resized(args.fullsize_image, args.width)
    var = sampling.rgb_variance(torch.from_numpy(np.asarray(img, np.float32)).to(device)).cpu().numpy()
    os.makedirs(args.output_dir, exist_ok=True)

    sweep = []
    lows = np.geomspace(max(args.var_low_max * 1e-3, 1e-8), args.var_low_max, args.steps)
    highs = np.geomspace(max(args.var_high_max * 1e-3, 1e-7), args.var_high_max, args.steps)
    for lo, hi in zip(lows, highs):
        below = float((var < lo).mean())
        between = float(((var >= lo) & (var < hi)).mean())
        above = float((var >= hi).mean())
        sweep.append({"var_noise_floor": float(lo), "var_high_thresh": float(hi),
                      "frac_below": below, "frac_between": between, "frac_above": above})
        # visualization: blue below floor, green in band, red above
        vis = np.stack([(var >= hi), (var >= lo) & (var < hi), var < lo], -1).astype(np.float32)
        name = f"variance_lo{lo:.2e}_hi{hi:.2e}.png"
        io.write_color(os.path.join(args.output_dir, name), vis * 0.7 + img * 0.3)
    with open(os.path.join(args.output_dir, "variance_sweep.json"), "w") as f:
        json.dump({"variance_stats": {
            "min": float(np.nanmin(var)), "median": float(np.nanmedian(var)),
            "p90": float(np.nanpercentile(var, 90)), "max": float(np.nanmax(var))},
            "sweep": sweep}, f, indent=2)
    log.info("wrote %d visualizations + variance_sweep.json to %s", len(sweep), args.output_dir)


def foreground_masks(args, device):
    bg = torch.from_numpy(np.asarray(_load_resized(args.fullsize_bg_image, args.width), np.float32)).to(device)
    fg = torch.from_numpy(np.asarray(_load_resized(args.fullsize_fg_image, args.width), np.float32)).to(device)
    os.makedirs(args.output_dir, exist_ok=True)

    sweep = []
    thresholds = np.linspace(0.05, 0.5, args.steps)
    blurs = np.unique(np.linspace(1, max(args.blur_radius_max, 1), min(args.steps, 4), dtype=int))
    closings = np.unique(np.linspace(1, max(args.morph_closing_size_max, 1), min(args.steps, 4), dtype=int))
    for thresh in thresholds:
        for blur in blurs:
            for closing in closings:
                mask = foreground.generate_foreground_mask(
                    bg, fg, threshold=float(thresh), blur_radius=int(blur), morph_closing_size=int(closing),
                ).cpu().numpy()
                frac = float(mask.mean())
                sweep.append({"threshold": float(thresh), "blur_radius": int(blur),
                              "morph_closing_size": int(closing), "foreground_frac": frac})
                name = f"mask_t{thresh:.2f}_b{blur}_c{closing}.png"
                io.write_mask(os.path.join(args.output_dir, name), mask > 0.5)
    with open(os.path.join(args.output_dir, "mask_sweep.json"), "w") as f:
        json.dump(sweep, f, indent=2)
    log.info("wrote %d masks + mask_sweep.json to %s", len(sweep), args.output_dir)


def main(argv=None, *, device=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(required=True)

    s = sub.add_parser("color_variance")
    s.add_argument("--fullsize_image", required=True)
    s.add_argument("--var_high_max", type=float, default=5e-2)
    s.add_argument("--var_low_max", type=float, default=4e-3)
    s.add_argument("--width", type=int, default=2048)
    s.add_argument("--steps", type=int, default=5)
    s.add_argument("--output_dir", required=True)
    s.set_defaults(fn=color_variance)

    s = sub.add_parser("foreground_masks")
    s.add_argument("--fullsize_bg_image", required=True)
    s.add_argument("--fullsize_fg_image", required=True)
    s.add_argument("--blur_radius_max", type=int, default=20)
    s.add_argument("--morph_closing_size_max", type=int, default=20)
    s.add_argument("--width", type=int, default=2048)
    s.add_argument("--steps", type=int, default=4)
    s.add_argument("--output_dir", required=True)
    s.set_defaults(fn=foreground_masks)

    args = p.parse_args(argv)
    args.fn(args, resolve_device(device))


if __name__ == "__main__":
    main()
