"""AlignColors equivalent: per-channel chromatic-aberration correction. The
port of ``facebook360_dep_tpu/cli/align_colors.py``.

Warps the R and B channels onto the green-calibrated rig using per-camera
infinity warp fields between the three single-channel rig calibrations
(calibration/AlignColors.cpp:26-200), in float32 on the card unless the
caller passes another ``device``:

    python -m facebook360_dep_tpu_torch.cli.align_colors --rig_red <r.json> --rig_green <g.json> \\
        --rig_blue <b.json> --color <color dir> --output <dir>
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from .. import resolve_device
from ..core import camera as cam, io
from ..ops import sampling

log = logging.getLogger("align_colors")


def channel_warp(cam_green: cam.Camera, cam_channel: cam.Camera, size_hw) -> torch.Tensor:
    """(H, W, 2) coords sampling the channel image at each green-rig pixel
    (computeWarpDstToSrc between the per-channel calibrations at infinity),
    on the cameras' device."""
    h, w = size_hw
    wh = torch.tensor([w, h], dtype=torch.float32, device=cam_green.position.device)
    grid = sampling.pixel_center_grid(h, w, device=wh.device) / wh
    world = cam.rig_near_infinity(cam_green, grid)
    pix, valid = cam.sees(cam_channel, world)
    return torch.where(valid[..., None], pix * wh, torch.nan)


def align_image(img_rgb: np.ndarray, cam_r, cam_g, cam_b) -> np.ndarray:
    """The image with its R and B channels warped onto the green rig; the
    channel keeps its own value where the warp leaves the image."""
    h, w = img_rgb.shape[:2]
    img = torch.from_numpy(np.ascontiguousarray(img_rgb[..., :3])).to(cam_g.position.device)
    out = img.clone()
    for ch, cam_ch in ((0, cam_r), (2, cam_b)):
        warped = sampling.bilinear_sample(img[..., ch], channel_warp(cam_g, cam_ch, (h, w)))
        out[..., ch] = torch.where(torch.isfinite(warped), warped, img[..., ch])
    return out.cpu().numpy()


def derive_channel_rig(calibrated_green: cam.Rig, ref_green: cam.Camera,
                       ref_channel: cam.Camera) -> cam.Rig:
    """Per-channel rig from the calibrated green rig + single-camera channel
    reference: transfer the channel/green focal ratio and the channel's
    distortion onto each calibrated camera (AlignColors.cpp:80-95)."""
    ratio = float(ref_channel.focal[0] / ref_green.focal[0])
    cams = calibrated_green.cameras
    cams = cams._replace(
        focal=cams.focal * ratio,
        distortion=ref_channel.distortion.to(cams.distortion).expand_as(cams.distortion).clone(),
        distortion_max=ref_channel.distortion_max.to(cams.distortion_max).expand_as(cams.distortion_max).clone(),
    )
    return calibrated_green._replace(cameras=cams)


def main(argv=None, *, device=None):
    """Parse ``argv`` and write the aligned images; ``device`` None means the card."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rig_red", required=True, help="red-channel rig calibration")
    p.add_argument("--rig_green", required=True, help="green-channel rig calibration")
    p.add_argument("--rig_blue", required=True, help="blue-channel rig calibration")
    p.add_argument("--calibrated_rig", default="", help=(
        "calibrated green rig: per-camera R/B rigs are derived from it via "
        "the channel/green focal ratio + channel distortion "
        "(AlignColors.cpp:35,80-95); empty = treat rig_red/blue as full rigs"))
    p.add_argument("--color", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--first", default="000000")
    p.add_argument("--last", default="000000")
    p.add_argument("--cameras", default="")
    args = p.parse_args(argv)
    dev = resolve_device(device)

    def load(path):
        return cam.normalize_rig(cam.filter_destinations(cam.load_rig(path), args.cameras))

    rig_r, rig_g, rig_b = load(args.rig_red), load(args.rig_green), load(args.rig_blue)
    if args.calibrated_rig:
        cal_g = load(args.calibrated_rig)
        rig_r = derive_channel_rig(cal_g, rig_g.camera(0), rig_r.camera(0))
        rig_b = derive_channel_rig(cal_g, rig_g.camera(0), rig_b.camera(0))
        rig_g = cal_g

    def f32(c):
        return c.to(dev, torch.float32)

    for f in range(int(args.first), int(args.last) + 1):
        frame = io.frame_name(f)
        for i, cam_id in enumerate(rig_g.ids):
            d = os.path.join(args.color, cam_id)
            probe = io.first_image_in(d)
            if not probe:
                raise FileNotFoundError(f"no images in {d}")
            img = io.read_color(os.path.join(d, frame + os.path.splitext(probe)[1]))
            aligned = align_image(
                img,
                f32(rig_r.camera(rig_r.find(cam_id))),
                f32(rig_g.camera(i)),
                f32(rig_b.camera(rig_b.find(cam_id))),
            )
            out_dir = os.path.join(args.output, cam_id)
            os.makedirs(out_dir, exist_ok=True)
            io.write_color(os.path.join(out_dir, frame + ".png"), aligned, bit_depth=16)
            log.info("aligned %s %s", cam_id, frame)


if __name__ == "__main__":
    main()
