"""LayerDisparities equivalent: composite foreground over background
disparity, where the foreground is NaN or 0 the background shows
(LayerDisparities.cpp:45-80). Writes ``<output>/disparity/<cam>/<frame>.pfm``.

    python -m facebook360_dep_tpu_torch.cli.layer_disparities --rig <rig.json> \\
        --background_disp <dir> --foreground_disp <dir> --output <root> --first 000000 --last 000002
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from ..core import camera as cam, imagetypes, io

log = logging.getLogger("layer")


def layer_disparities(foreground: np.ndarray, background: np.ndarray) -> np.ndarray:
    if foreground.shape != background.shape:
        raise ValueError(f"foreground {foreground.shape} and background {background.shape} differ")
    mask = np.nan_to_num(foreground, nan=0.0) > 0.0
    return np.where(mask, foreground, background)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--background_disp", required=True)
    p.add_argument("--background_frame", default="000000")
    p.add_argument("--foreground_disp", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--rig", required=True)
    p.add_argument("--cameras", default="")
    p.add_argument("--first", default="000000")
    p.add_argument("--last", default="000000")
    p.add_argument("--threads", type=int, default=-1)
    args = p.parse_args(argv)

    rig = cam.filter_destinations(cam.load_rig(args.rig), args.cameras)

    def load(root, cam_id, frame):
        return io.read_disparity(io.frame_path(os.path.join(root, cam_id), frame))

    for f in range(int(args.first), int(args.last) + 1):
        frame = io.frame_name(f)
        for cam_id in rig.ids:
            layered = layer_disparities(load(args.foreground_disp, cam_id, frame),
                                        load(args.background_disp, cam_id, args.background_frame))
            out_dir = imagetypes.image_dir(args.output, "disparity", cam_id=cam_id)
            os.makedirs(out_dir, exist_ok=True)
            io.write_disparity(os.path.join(out_dir, frame + ".pfm"), layered)
            log.info("layered %s %s", cam_id, frame)


if __name__ == "__main__":
    main()
