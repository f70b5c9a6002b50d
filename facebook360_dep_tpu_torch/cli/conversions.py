"""Conversion tools (source/conversion/* in the reference): ExportPointCloud,
ImportPointCloud, PngToPfm, ProjectCamerasToEquirects,
ProjectEquirectsToCameras, CreateObjFromDisparityEquirect, one subcommand
per binary. The port of ``facebook360_dep_tpu/cli/conversions.py``: the
projections, splats and samples run on the card; the point-cloud text, the
PFM conversion and the OBJ mesh on the host.

    python -m facebook360_dep_tpu_torch.cli.conversions export_point_cloud --rig <rig.json> \\
        --disparity <disparity level_0> --output <cloud.xyz>
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from . import resolve_device
from ..core import camera as cam, io
from ..ops import sampling
from ..render import dibr
from ..stream import mesh

log = logging.getLogger("conversion")


def _load(root, cam_id, frame, loader):
    d = os.path.join(root, cam_id)
    probe = io.first_image_in(d)
    assert probe, f"no images in {d}"
    return loader(os.path.join(d, frame + os.path.splitext(probe)[1]))


def _cam_at(rig, i, size_hw, device):
    """Camera ``i`` rescaled to an image of ``size_hw``, float32 on ``device``."""
    h, w = size_hw
    return cam.rescale(rig.camera(i), [w, h]).to(device, torch.float32)


def export_point_cloud(args, device):
    """Disparity maps -> XYZ(RGB) text point cloud (ExportPointCloud.cpp:42-51)."""
    rig = cam.filter_destinations(cam.load_rig(args.rig), args.cameras)
    points = []
    for i, cam_id in enumerate(rig.ids):
        disp = _load(args.disparity, cam_id, args.frame, io.read_disparity)
        color = _load(args.color, cam_id, args.frame, io.read_color)[..., :3] if args.color else None
        c = _cam_at(rig, i, disp.shape, device)
        h, w = disp.shape
        grid = sampling.pixel_center_grid(h, w, device=device)
        depth = 1.0 / np.maximum(disp, 1e-12)
        world = cam.rig_point(c, grid, torch.from_numpy(depth).to(device)).cpu().numpy()
        valid = np.isfinite(disp) & (disp > 0) & (depth < args.max_depth)
        pts = world[valid]
        if color is not None:
            pts = np.concatenate([pts, color[valid] * 255.0], axis=-1)
        points.append(pts)
        log.info("%s: %d points", cam_id, len(pts))
    allpts = np.concatenate(points)
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    np.savetxt(args.output, allpts, fmt="%.6f")
    log.info("wrote %d points to %s", len(allpts), args.output)


def import_point_cloud(args, device):
    """Point cloud -> per-camera depth maps via z-buffer splat
    (ImportPointCloud.cpp:46-53)."""
    rig = cam.filter_destinations(cam.load_rig(args.rig), args.cameras)
    pts = torch.from_numpy(np.loadtxt(args.point_cloud, ndmin=2)[:, :3].astype(np.float32)).to(device)
    w, h = args.width, int(round(args.width * 0.75)) if args.height <= 0 else args.height
    for i, cam_id in enumerate(rig.ids):
        c = _cam_at(rig, i, (h, w), device)
        pix, valid = cam.sees(c, pts)
        rel = pts - c.position
        dist = torch.sqrt(cam._dot3(rel, rel))
        valid &= (dist >= args.min_depth) & (dist <= args.max_depth)
        # float32 -> int truncates toward zero, as numpy's astype(int)
        xi = torch.clamp(pix[:, 0].to(torch.int64), 0, w - 1)
        yi = torch.clamp(pix[:, 1].to(torch.int64), 0, h - 1)
        zbuf = torch.full((h * w,), torch.inf, dtype=torch.float32, device=device)
        zbuf.scatter_reduce_(0, (yi * w + xi)[valid], dist[valid], reduce="amin")
        zbuf = zbuf.reshape(h, w)
        disp = torch.where(torch.isfinite(zbuf), 1.0 / torch.clamp(zbuf, min=1e-12), torch.nan)
        out_dir = os.path.join(args.output, cam_id)
        os.makedirs(out_dir, exist_ok=True)
        io.write_disparity(os.path.join(out_dir, args.frame + ".pfm"), disp.cpu().numpy())
        log.info("%s: %d points splatted", cam_id, int(valid.sum()))


def png_to_pfm(args, device=None):
    """PNG16 disparity -> PFM (PngToPfm.cpp:28-29); host only."""
    disp = io.read_disparity(args.png)
    io.write_pfm(args.pfm, disp)
    log.info("%s -> %s (%dx%d)", args.png, args.pfm, disp.shape[1], disp.shape[0])


def _frame_range(args):
    """Frames from --first/--last, falling back to the single --frame."""
    first = getattr(args, "first", "") or args.frame
    last = getattr(args, "last", "") or first
    return [io.frame_name(f) for f in range(int(first), int(last) + 1)]


def project_cameras_to_equirects(args, device):
    """Fixed-depth reprojection of each camera into an equirect
    (ProjectCamerasToEquirects.cpp:35-43)."""
    rig = cam.filter_destinations(cam.load_rig(args.rig), args.cameras)
    world = dibr.equirect_dirs(args.eqr_width, args.eqr_height, device=device) * args.depth
    for frame in _frame_range(args):
        for i, cam_id in enumerate(rig.ids):
            color = _load(args.color, cam_id, frame, io.read_color)[..., :3]
            c = _cam_at(rig, i, color.shape[:2], device)
            pix, valid = cam.sees(c, world)
            sampled = sampling.bilinear_sample(torch.from_numpy(color).to(device), pix)
            out = torch.where(valid[..., None], sampled, 0.0)
            out_dir = os.path.join(args.output, cam_id)
            os.makedirs(out_dir, exist_ok=True)
            io.write_color(os.path.join(out_dir, frame + "." + args.file_type), out.cpu().numpy())
            log.info("%s %s projected to equirect", frame, cam_id)


def project_equirects_to_cameras(args, device):
    """Inverse: sample an equirect at each camera pixel's ray at fixed depth
    (ProjectEquirectsToCameras.cpp:33-42).

    Two modes, matching the reference's mask workflow plus a color variant:
    --eqr_masks <root> projects per-camera equirect masks (root/<cam>/<frame>)
    into camera space as binary masks; --eqr <file> samples one color
    equirect for every camera.
    """
    rig = cam.filter_destinations(cam.load_rig(args.rig), args.cameras)
    assert args.eqr or args.eqr_masks, "--eqr or --eqr_masks is required"
    res = rig.cameras.resolution[0].tolist()
    w = args.width if args.width > 0 else int(res[0])
    h = int(round(res[1] / res[0] * w))
    h += h % 2  # even rows, ProjectEquirectsToCameras.cpp:64
    grid = sampling.pixel_center_grid(h, w, device=device)
    for frame in _frame_range(args):
        for i, cam_id in enumerate(rig.ids):
            if args.eqr_masks:
                eqr = _load(args.eqr_masks, cam_id, frame, io.read_color)
                eqr = (eqr[..., :3].mean(-1, keepdims=True) > 0.5).astype(np.float32)
            else:
                eqr = io.read_color(args.eqr)[..., :3]
            eh, ew = eqr.shape[:2]
            c = _cam_at(rig, i, (h, w), device)
            world = cam.rig_point(c, grid, float(args.depth))
            x, y = dibr.world_to_equirect(world, ew, eh)
            out = sampling.bilinear_sample(torch.from_numpy(eqr).to(device), torch.stack([x, y], dim=-1))
            out = out.cpu().numpy()
            if args.eqr_masks:
                out = (np.nan_to_num(out) > 0.5).astype(np.float32)
                out = np.repeat(out, 3, axis=-1) if out.shape[-1] == 1 else out
            out_dir = os.path.join(args.output, cam_id)
            os.makedirs(out_dir, exist_ok=True)
            io.write_color(os.path.join(out_dir, frame + "." + args.file_type), np.nan_to_num(out))
            log.info("%s %s sampled from equirect", frame, cam_id)


def create_obj_from_disparity_equirect(args, device=None):
    """Equirect disparity -> OBJ mesh (CreateObjFromDisparityEquirect.cpp:36-45); host only."""
    disp_path = args.disparity or args.input_png_disp
    out_path = args.output or args.output_obj
    assert disp_path, "--disparity (or --input_png_disp) is required"
    assert out_path, "--output (or --output_obj) is required"
    disp = io.read_disparity(disp_path)
    if 0 < args.scale < 1.0:
        step = max(1, int(round(1.0 / args.scale)))
        disp = disp[::step, ::step]
    h, w = disp.shape
    v = mesh.get_vertexes_equirect(disp, args.max_depth)
    faces = mesh.get_faces(v, w, h, wrap_horizontally=True, is_rig_coordinates=True, tear_ratio=args.tear_ratio)
    valid = np.isfinite(disp) & (disp > 0)
    v2, f2 = mesh.apply_mask(v, faces, valid)
    if args.strictness > 0 and 0 < args.num_faces < len(f2):
        from ..stream import native

        v2, f2 = native.simplify_mesh(v2, f2, args.num_faces, args.strictness)[:2]
    mtl = ""
    if args.create_mtl:
        # MTL referencing the color image beside the OBJ (create_mtl flag,
        # CreateObjFromDisparityEquirect.cpp:36)
        mtl = os.path.splitext(out_path)[0] + ".mtl"
        with open(mtl, "w") as fh:
            fh.write("newmtl textured\n")
            if args.input_png_color:
                fh.write(f"map_Kd {os.path.abspath(args.input_png_color)}\n")
    mesh.write_obj(out_path, v2, f2, mtl_path=mtl)
    log.info("wrote %d vertices, %d faces to %s", len(v2), len(f2), out_path)


# the subcommands that compute on a device (the others stay on the host)
_DEVICE_TOOLS = {"export_point_cloud", "import_point_cloud", "project_cameras_to_equirects",
                 "project_equirects_to_cameras"}


def main(argv=None, *, device=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="tool", required=True)

    s = sub.add_parser("export_point_cloud")
    s.add_argument("--rig", required=True)
    s.add_argument("--disparity", required=True)
    s.add_argument("--color", default="")
    s.add_argument("--output", required=True)
    s.add_argument("--cameras", default="")
    s.add_argument("--frame", default="000000")
    s.add_argument("--max_depth", type=float, default=100.0)
    s.set_defaults(fn=export_point_cloud)

    s = sub.add_parser("import_point_cloud")
    s.add_argument("--rig", required=True)
    s.add_argument("--point_cloud", required=True)
    s.add_argument("--output", required=True)
    s.add_argument("--cameras", default="")
    s.add_argument("--frame", default="000000")
    s.add_argument("--width", type=int, default=512)
    s.add_argument("--height", type=int, default=-1)
    s.add_argument("--min_depth", type=float, default=0.0)
    s.add_argument("--max_depth", type=float, default=float("inf"))
    s.add_argument("--threads", type=int, default=-1, help="accepted for flag parity")
    s.set_defaults(fn=import_point_cloud)

    s = sub.add_parser("png_to_pfm")
    s.add_argument("--png", required=True)
    s.add_argument("--pfm", required=True)
    s.set_defaults(fn=png_to_pfm)

    s = sub.add_parser("project_cameras_to_equirects")
    s.add_argument("--rig", required=True)
    s.add_argument("--color", required=True)
    s.add_argument("--output", required=True)
    s.add_argument("--cameras", default="")
    s.add_argument("--frame", default="000000")
    s.add_argument("--first", default="", help="first frame (overrides --frame)")
    s.add_argument("--last", default="", help="last frame")
    s.add_argument("--depth", type=float, default=10.0)
    s.add_argument("--eqr_width", type=int, default=2048)
    s.add_argument("--eqr_height", type=int, default=1024)
    s.add_argument("--file_type", default="png", help="output image extension")
    s.add_argument("--threads", type=int, default=-1, help="accepted for flag parity")
    s.set_defaults(fn=project_cameras_to_equirects)

    s = sub.add_parser("project_equirects_to_cameras")
    s.add_argument("--rig", required=True)
    s.add_argument("--eqr", default="", help="single color equirect to sample")
    s.add_argument("--eqr_masks", default="", help=(
        "per-camera equirect masks root (<root>/<cam>/<frame>); projected "
        "into camera space as binary masks, the reference's workflow"))
    s.add_argument("--output", required=True)
    s.add_argument("--cameras", default="")
    s.add_argument("--frame", default="000000")
    s.add_argument("--first", default="", help="first frame (overrides --frame)")
    s.add_argument("--last", default="", help="last frame")
    s.add_argument("--depth", type=float, default=10.0)
    s.add_argument("--width", type=int, default=2048)
    s.add_argument("--file_type", default="png", help="output image extension")
    s.add_argument("--threads", type=int, default=-1, help="accepted for flag parity")
    s.set_defaults(fn=project_equirects_to_cameras)

    s = sub.add_parser("create_obj_from_disparity_equirect")
    s.add_argument("--disparity", default="")
    s.add_argument("--input_png_disp", default="", help="alias of --disparity (reference name)")
    s.add_argument("--input_png_color", default="", help="color png referenced by the MTL")
    s.add_argument("--output", default="")
    s.add_argument("--output_obj", default="", help="alias of --output (reference name)")
    s.add_argument("--max_depth", type=float, default=700.0)
    s.add_argument("--tear_ratio", type=float, default=0.95)
    s.add_argument("--create_mtl", action="store_true")
    s.add_argument("--num_faces", type=int, default=200000)
    s.add_argument("--scale", type=float, default=1.0,
                   help="depth map resolution before decimation (<1 downsamples)")
    s.add_argument("--strictness", type=float, default=0.8)
    s.add_argument("--threads", type=int, default=-1, help="accepted for flag parity")
    s.set_defaults(fn=create_obj_from_disparity_equirect)

    args = p.parse_args(argv)
    args.fn(args, resolve_device(device) if args.tool in _DEVICE_TOOLS else None)


if __name__ == "__main__":
    main()
