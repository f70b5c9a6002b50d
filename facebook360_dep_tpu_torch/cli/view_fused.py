"""Offline 6DoF viewer: decode fused streaming data and render novel views.
The port of ``facebook360_dep_tpu/cli/view_fused.py``.

The file-format compatibility surface of GlViewer (viewer/GlViewer.cpp:57 +
render/VideoFile.h): reads fused.json + stripe files, decodes each camera's
.vtx/.idx equi-error mesh and .bc7 color on the host (native z-buffer raster
and BC7 decoder), and renders the requested viewpoint with the DIBR splat +
gather path (render/dibr.py) on the card, to one PNG a frame: proof that the
published data round-trips without GL.

    python -m facebook360_dep_tpu_torch.cli.view_fused --rig <rig.json> --catalog <fused>/fused.json \\
        --output <dir> --width 2048 --height 1024
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

from .. import resolve_device
from ..core import camera as cam, io
from ..render import dibr
from ..stream import fusion, native

log = logging.getLogger("viewer")


def decode_camera(fused_dir, catalog, frame, cam_id, camera, num_disks, color_wh):
    """(color float32 RGB [0,1] (H, W, 3), disparity float32 (H, W)) numpy,
    decoded from the fused stream at the color's (W, H)."""
    raw_v = fusion.read_fused_entry(fused_dir, catalog, frame, cam_id, ".vtx", num_disks)
    raw_i = fusion.read_fused_entry(fused_dir, catalog, frame, cam_id, ".idx", num_disks)
    verts = np.frombuffer(raw_v, np.float32).reshape(-1, 3)
    faces = np.frombuffer(raw_i, np.uint32).reshape(-1, 3)

    w, h = color_wh
    res_x, res_y = (float(v) for v in camera.resolution.reshape(-1)[:2])
    # vertex xy are in full-camera pixel units; z = focal/depth
    z = native.rasterize_mesh(verts, faces, w, h, w / res_x, h / res_y)
    disparity = z / float(camera.focal.reshape(-1)[0])  # z = focal * disparity

    entry = catalog["frames"][frame][cam_id]
    if ".bc7" in entry:
        raw_c = fusion.read_fused_entry(fused_dir, catalog, frame, cam_id, ".bc7", num_disks)
        rgba = native.decompress_bc7(np.frombuffer(raw_c, np.uint8), w, h)
    else:  # uncompressed RGBA subframes (ConvertToBinary --output_formats rgba)
        raw_c = fusion.read_fused_entry(fused_dir, catalog, frame, cam_id, ".rgba", num_disks)
        rgba = np.frombuffer(raw_c, np.uint8).reshape(h, w, 4)
    color = np.power(rgba[..., :3].astype(np.float32) / 255.0, 1.0 / (2.2 / 1.8))
    return color, disparity


def color_size(rig: cam.Rig, entry: dict) -> tuple[int, int]:
    """(W, H) of a frame's color texture from its payload size (bc7: 1
    byte a pixel, rgba: 4) and the first camera's aspect."""
    res = rig.cameras.resolution[0].double().numpy()
    npix = entry[".bc7"]["size"] if ".bc7" in entry else entry[".rgba"]["size"] / 4.0
    scale = np.sqrt(npix / (res[0] * res[1]))
    w = int(round(res[0] * scale)) // 4 * 4
    h = int(round(npix / w)) // 4 * 4
    return w, h


def main(argv=None, *, device=None):
    """Parse ``argv`` and render every frame of the catalog on ``device``
    (None: the card). Returns one record a frame: {"frame", "path", "shape",
    "coverage" (alpha share), "finite", "alpha" (H, W) bool numpy}."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rig", required=True)
    p.add_argument("--catalog", required=True, help="fused.json")
    p.add_argument("--output", required=True, help="rendered frames directory")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--position", default="0,0,0", help="view position (m), comma separated")
    p.add_argument("--num_disks", type=int, default=1)
    p.add_argument("--first", default="")
    p.add_argument("--last", default="")
    args = p.parse_args(argv)
    dev = resolve_device(device)

    rig = cam.load_rig(args.rig)
    with open(args.catalog) as f:
        catalog = json.load(f)
    fused_dir = os.path.dirname(os.path.abspath(args.catalog))
    frames = sorted(catalog["frames"])
    if args.first:
        frames = [f for f in frames if args.first <= f <= (args.last or frames[-1])]
    position = [float(v) for v in args.position.split(",")]
    os.makedirs(args.output, exist_ok=True)

    records = []
    for frame in frames:
        wh = color_size(rig, catalog["frames"][frame][rig.ids[0]])
        decoded = [decode_camera(fused_dir, catalog, frame, cam_id, rig.camera(i), args.num_disks, wh)
                   for i, cam_id in enumerate(rig.ids)]
        colors = torch.from_numpy(np.stack([c for c, _ in decoded])).to(dev)
        disps = torch.from_numpy(np.stack([d for _, d in decoded])).to(dev)
        color_out, _, alpha = dibr.render_equirect(rig, colors, disps, position, args.width, args.height)
        out = os.path.join(args.output, frame + ".png")
        io.write_color(out, color_out.cpu().numpy())
        records.append(dict(frame=frame, path=out, shape=tuple(color_out.shape), coverage=alpha.float().mean().item(),
                            finite=bool(torch.isfinite(color_out[alpha]).all()), alpha=alpha.cpu().numpy()))
        log.info("rendered %s -> %s", frame, out)
    return records


if __name__ == "__main__":
    main()
