"""SimpleMeshRenderer equivalent: offline exports from per-camera
color + disparity.

Formats (render/SimpleMeshRenderer.cpp:92-112): cubecolor, cubedisp,
eqrcolor, eqrdisp, snapshot, tbstereo, lr180, tb3dof, rendered by the DIBR
splat + gather path (render/dibr.py) on the card. Stereo formats render one ODS eye each with the latitude-faded
IPD warp. Color formats are written as 8-bit PNG, disparity formats as
16-bit PNG.

    python -m facebook360_dep_tpu_torch.cli.simple_mesh_renderer --rig <rig.json> \\
        --color <color dir> --disparity <disparity dir> --output <dir> --format eqrcolor
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from .. import resolve_device
from ..core import camera as cam, io
from ..render import dibr
from .compute_rephotography_errors import load_rig_images

log = logging.getLogger("render")

FORMATS = ["cubecolor", "cubedisp", "eqrcolor", "eqrdisp", "lr180", "tb3dof", "tbstereo", "snapshot"]


def render_format(fmt, rig, colors, disps, width, height, ipd, position):
    """One export image and its alpha, both with the image's (H, W)."""
    if fmt in ("cubecolor", "cubedisp"):
        face = height
        color, disp, alpha = dibr.render_cubemap(rig, colors, disps, position, face)
        img = color.reshape(6 * face, face, 3) if fmt == "cubecolor" else disp.reshape(6 * face, face)
        return img, alpha.reshape(6 * face, face)
    if fmt in ("eqrcolor", "eqrdisp", "snapshot"):
        color, disp, alpha = dibr.render_equirect(rig, colors, disps, position, width, height)
        return (disp if fmt == "eqrdisp" else color), alpha
    if fmt == "tb3dof":
        # color over disparity, single (mono) view
        cl, dl, al = dibr.render_equirect(rig, colors, disps, position, width, height)
        disp_vis = torch.nan_to_num(dl)[..., None].expand(-1, -1, 3)
        return torch.cat([cl, disp_vis], dim=0), torch.cat([al, al], dim=0)
    # stereo: one render per eye from the same center; the reference feeds
    # halfIpdM = +-ipd/2 (SimpleMeshRenderer.cpp:407-427), positive = left
    half = ipd / 2.0
    cl, _, al = dibr.render_equirect(rig, colors, disps, position, width, height, ipd=+half)
    cr, _, ar = dibr.render_equirect(rig, colors, disps, position, width, height, ipd=-half)
    if fmt == "tbstereo":
        return torch.cat([cl, cr], dim=0), torch.cat([al, ar], dim=0)  # top-bottom
    if fmt == "lr180":
        # central 180 degrees side by side
        q = width // 4
        return (torch.cat([cl[:, q:3 * q], cr[:, q:3 * q]], dim=1),
                torch.cat([al[:, q:3 * q], ar[:, q:3 * q]], dim=1))
    raise ValueError(f"unknown format {fmt}")


def main(argv=None, *, device=None):
    """Parse ``argv`` and render every frame on ``device`` (None: the card). Returns one record a frame:
    {"frame", "path", "shape", "coverage" (alpha share), "finite"}."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rig", required=True)
    p.add_argument("--color", required=True)
    p.add_argument("--disparity", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--format", required=True, choices=FORMATS)
    p.add_argument("--first", default="000000")
    p.add_argument("--last", default="000000")
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--ipd", type=float, default=0.064)
    p.add_argument("--position", default="0,0,0")
    args = p.parse_args(argv)
    dev = resolve_device(device)

    rig = cam.load_rig(args.rig)
    position = [float(v) for v in args.position.split(",")]
    os.makedirs(args.output, exist_ok=True)
    records = []
    for f in range(int(args.first), int(args.last) + 1):
        frame = io.frame_name(f)
        colors, disps = load_rig_images(args.color, args.disparity, rig, frame)
        img, alpha = render_format(args.format, rig, torch.from_numpy(colors).to(dev), torch.from_numpy(disps).to(dev),
                                   args.width, args.height, args.ipd, position)
        coverage = alpha.float().mean().item()
        finite = bool(torch.isfinite(img[alpha]).all())
        out = os.path.join(args.output, frame + ".png")
        if img.ndim == 2:  # disparity map
            io.write_disparity(out, img.cpu().numpy())
        else:
            io.write_color(out, img.cpu().numpy())
        log.info("%s %s -> %s (alpha coverage %.4f)", args.format, frame, out, coverage)
        records.append(dict(frame=frame, path=out, shape=tuple(img.shape), coverage=coverage, finite=finite))
    return records


if __name__ == "__main__":
    main()
