"""ComputeRephotographyErrors equivalent: the pipeline's quality metric.

For each camera, render a cubemap at its position twice — once from its own
(color, disparity) and once from all OTHER cameras — and score them with
MSSIM/NCC. Logs per-camera and "TOTAL average" scores in the reference's
format (``render/ComputeRephotographyErrors.cpp:46-195``), which
``facebook360_dep_tpu/cli/log_reader.py`` parses. Renders and scores run on
the card.

    python -m facebook360_dep_tpu_torch.cli.compute_rephotography_errors \\
        --color <root>/video/color_levels/level_0 --disparity <out>/disparity_levels/level_0 \\
        --rig <root>/rigs/rig_calibrated.json --output <dir> --first 000000 --last 000000
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from .. import default_device, resolve_device
from ..core import camera as cam, io
from ..render import dibr, rephoto

log = logging.getLogger("rephoto")


def load_rig_images(color_dir, disp_dir, rig, frame):
    """(N, H, W, 3) colors and (N, H, W) disparities of one frame as numpy
    float32; colors are area-resized to the disparity size where they differ."""
    colors, disps = [], []
    for cam_id in rig.ids:
        disp = io.read_disparity(io.frame_path(os.path.join(disp_dir, cam_id), frame))
        color = io.read_color(io.frame_path(os.path.join(color_dir, cam_id), frame))[..., :3]
        if color.shape[:2] != disp.shape:
            color = io.resize_image(color, (disp.shape[1], disp.shape[0]))
        colors.append(color)
        disps.append(disp)
    return np.stack(colors), np.stack(disps)


def rephotography_scores(rig: cam.Rig, colors, disps, method="MSSIM", stat_radius=1, face_size=None):
    """Per-camera (R, G, B) scores; returns (scores list, total average).
    ``colors``/``disps`` are arrays or tensors; they are rendered on the
    device of a tensor, else on the card."""
    dev = colors.device if torch.is_tensor(colors) else default_device()
    colors = torch.as_tensor(colors, dtype=torch.float32, device=dev)
    disps = torch.as_tensor(disps, dtype=torch.float32, device=dev)
    nrig = cam.normalize_rig(rig)
    face_size = face_size or colors.shape[1]
    scores = []
    for i, cam_id in enumerate(rig.ids):
        center = nrig.cameras.position[i]
        ref_c, _, ref_a = dibr.render_cubemap(nrig.subset([i]), colors[i:i + 1], disps[i:i + 1], center, face_size)
        others = [j for j in range(len(rig.ids)) if j != i]
        ren_c, _, _ = dibr.render_cubemap(nrig.subset(others), colors[others], disps[others], center, face_size)
        x = ref_c.reshape(-1, face_size, 3)
        y = ren_c.reshape(-1, face_size, 3)
        score_map = rephoto.compute_score_map(method, x, y, stat_radius)
        avg = rephoto.average_score(score_map, ref_a.reshape(-1, face_size))
        log.info("%s %s: %s", cam_id, method, rephoto.format_results(avg))
        scores.append(avg)
    total = np.mean(scores, axis=0)
    log.info("TOTAL average %s: %s", method, rephoto.format_results(total))
    return scores, total


def main(argv=None, *, device=None):
    """Parse ``argv`` and score every frame on ``device`` (None: the card). Returns {"frames": {frame:
    {"cameras": {id: [r, g, b]}, "total": [r, g, b]}}, "total": [r, g, b]}."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--color", required=True)
    p.add_argument("--disparity", required=True)
    p.add_argument("--rig", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--first", required=True)
    p.add_argument("--last", required=True)
    p.add_argument("--cameras", default="")
    p.add_argument("--method", default="MSSIM", choices=["MSSIM", "NCC"])
    p.add_argument("--stat_radius", type=int, default=1)
    p.add_argument("--threads", type=int, default=-1)
    args = p.parse_args(argv)
    dev = resolve_device(device)

    rig = cam.load_rig(args.rig)
    if args.cameras:
        rig = cam.filter_destinations(rig, args.cameras)
    os.makedirs(args.output, exist_ok=True)

    frames = {}
    for f in range(int(args.first), int(args.last) + 1):
        frame = io.frame_name(f)
        t = time.time()
        colors, disps = load_rig_images(args.color, args.disparity, rig, frame)
        log.info("frame %s: loaded %d cameras in %.2fs", frame, len(rig.ids), time.time() - t)
        scores, total = rephotography_scores(rig, torch.from_numpy(colors).to(dev), torch.from_numpy(disps).to(dev),
                                             args.method, args.stat_radius)
        frames[frame] = {"cameras": {c: s.tolist() for c, s in zip(rig.ids, scores)}, "total": total.tolist()}
    grand = np.mean([v["total"] for v in frames.values()], axis=0)
    log.info("TOTAL average %s: %s", args.method, rephoto.format_results(grand))
    return {"frames": frames, "total": grand.tolist()}


if __name__ == "__main__":
    main()
