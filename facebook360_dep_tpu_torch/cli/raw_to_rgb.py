"""RawToRgb equivalent: software ISP over RAW frames, on the card.

Flags mirror ``isp/RawToRgb.cpp:36-51`` and the JAX package's CLI:
input/output paths, isp.json config, demosaic filter choice, optional DNG
output (``util/RawUtil.cpp`` writeDng), 8/16-bit output. ``.raw`` inputs
are headerless sensor dumps whose dimensions and precision come from the
ISP config (readRawImage, RawUtil.cpp:31-40); image inputs (PNG/TIFF
mosaics) are also accepted. A directory input converts every file in it.

    python -m facebook360_dep_tpu_torch.cli.raw_to_rgb --input_image_path cam0.raw \\
        --output_image_path <root>/video/color/cam0/000000.png --isp_config_path isp.json \\
        --demosaic_filter EDGE_AWARE --output_bpp 16
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from ..core import io, rawio
from ..isp import pipeline as isp
from . import resolve_device

log = logging.getLogger("isp")


def load_mosaic(path, cfg: isp.IspConfig) -> np.ndarray:
    if path.endswith(".raw"):
        if not (cfg.width > 0 and cfg.height > 0):
            raise ValueError("isp.json must set width/height for .raw input")
        return rawio.read_raw(path, cfg.width, cfg.height, cfg.bits_per_pixel)
    img = io.read_color(path)
    return img[..., 0] if img.ndim == 3 else img


def main(argv=None, *, device=None):
    """Parse ``argv`` and convert each input on ``device`` (None: the card)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_image_path", required=True, help="RAW mosaic image/dump (or dir)")
    p.add_argument("--output_image_path", required=True)
    p.add_argument("--isp_config_path", required=True, help="isp.json")
    p.add_argument("--black_level_offset", type=float, default=0.0)
    p.add_argument("--output_bpp", type=int, default=8, choices=[8, 16])
    p.add_argument(
        "--demosaic_filter", default="", choices=["", *isp.DEMOSAIC_FILTERS],
        help="override the demosaic method (default: config / BILINEAR)",
    )
    p.add_argument("--apply_tone_curve", default="true")
    p.add_argument("--dng", action="store_true", help="write a DNG instead of processing to RGB")
    p.add_argument("--resize", type=int, default=1, help="pow2 downscale factor")
    args = p.parse_args(argv)
    dev = resolve_device(device)

    cfg = isp.IspConfig.from_json(args.isp_config_path)
    if args.black_level_offset:
        cfg.black_level = tuple(b + args.black_level_offset for b in cfg.black_level)
    if args.demosaic_filter:
        cfg.demosaic_filter = args.demosaic_filter
    cfg.apply_tone_curve = str(args.apply_tone_curve).lower() in ("1", "true", "yes")

    def one(in_path, out_path):
        raw = load_mosaic(in_path, cfg)
        if args.dng:
            rawio.write_dng(
                out_path, raw, cfg.bayer_pattern,
                max(cfg.bits_per_pixel, 8), float(np.mean(cfg.black_level)),
                cfg.ccm, cfg.white_balance_gain,
            )
        else:
            rgb = isp.process(torch.from_numpy(raw).to(dev), cfg)
            if args.resize > 1:  # stride decimation, as the JAX CLI does
                rgb = rgb[:: args.resize, :: args.resize]
            io.write_color(out_path, rgb.cpu().numpy(), bit_depth=args.output_bpp)
        log.info("%s -> %s", in_path, out_path)

    if os.path.isdir(args.input_image_path):
        os.makedirs(args.output_image_path, exist_ok=True)
        ext = ".dng" if args.dng else ".png"
        for name in sorted(os.listdir(args.input_image_path)):
            if name.startswith("."):
                continue
            out = os.path.splitext(name)[0] + ext
            one(os.path.join(args.input_image_path, name), os.path.join(args.output_image_path, out))
    else:
        one(args.input_image_path, args.output_image_path)


if __name__ == "__main__":
    main()
