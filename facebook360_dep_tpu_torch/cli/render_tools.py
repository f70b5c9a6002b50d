"""Rig inspection render tools, one subcommand per reference binary. The
port of ``facebook360_dep_tpu/cli/render_tools.py``; the projections,
samples and the mismatch pass run on the card.

- generate_equirect: depth-sweep preview: average all cameras' colors
  projected onto spheres of several radii (GenerateEquirect.cpp:55-135).
- generate_camera_overlaps: per camera-pair overlap visualizations via
  reprojection at a depth sweep (GenerateCameraOverlaps.cpp:41-49).
- geometric_consistency: iterative cross-camera depth cleanup using the
  solver's mismatch handler, which launches the K1 kernel
  (GeometricConsistency.cpp:29-55).
- generate_keypoint_projections: project a world grid of keypoints into each
  camera (GenerateKeypointProjections.cpp:23-37).

generate_equirect samples each camera at the pixel ``cam.sees`` returns for
the rig rescaled to the image, where the JAX tool multiplies that pixel by
the image size a second time (its taps then clamp to the image edge).

    python -m facebook360_dep_tpu_torch.cli.render_tools geometric_consistency --rig <rig.json> \\
        --color <color level_0> --disparity <disparity level_0> --output <dir>
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

log = logging.getLogger("render_tools")


def _load(root, cam_id, frame, loader):
    d = os.path.join(root, cam_id)
    probe = io.first_image_in(d)
    assert probe, f"no images in {d}"
    return loader(os.path.join(d, frame + os.path.splitext(probe)[1]))


def _cams_f32(rig, size_hw, device):
    """The rig rescaled to an image of ``size_hw``, float32 on ``device``."""
    h, w = size_hw
    return cam.rescale_rig(rig, [w, h]).cameras.to(device, torch.float32)


def _colors(args, rig, frame, device) -> torch.Tensor:
    colors = np.stack([_load(args.color, cid, frame, io.read_color)[..., :3] for cid in rig.ids])
    return torch.from_numpy(colors).to(device)


def generate_equirect(args, device):
    rig = cam.filter_destinations(cam.load_rig(args.rig), args.cameras)
    colors = _colors(args, rig, args.frame, device)
    cams = _cams_f32(rig, colors.shape[1:3], device)
    dirs = dibr.equirect_dirs(args.eqr_width, args.eqr_height, device=device)
    os.makedirs(args.output, exist_ok=True)
    for d in np.geomspace(args.min_depth, args.max_depth, args.num_depths):
        world = dirs * float(d)
        acc = torch.zeros(dirs.shape, dtype=torch.float32, device=device)
        cnt = torch.zeros(dirs.shape[:2], dtype=torch.float32, device=device)
        for i in range(len(rig.ids)):
            pix, valid = cam.sees(cams.index(i), world)
            sampled = sampling.bilinear_sample(colors[i], pix)
            ok = valid & torch.isfinite(sampled).all(dim=-1)
            acc = acc + torch.where(ok[..., None], sampled, 0.0)
            cnt = cnt + ok.to(torch.float32)
        out = acc / torch.clamp(cnt, min=1)[..., None]
        io.write_color(os.path.join(args.output, f"eqr_depth_{d:.2f}.png"), out.cpu().numpy())
        log.info("depth %.2f m equirect written", d)


def generate_camera_overlaps(args, device):
    from ..calib.features import camera_overlap

    rig = cam.filter_destinations(cam.load_rig(args.rig), args.cameras)
    colors = _colors(args, rig, args.frame, device)
    if 0 < args.scale < 1.0:
        step = max(1, int(round(1.0 / args.scale)))
        colors = colors[:, ::step, ::step].contiguous()
    h, w = colors.shape[1:3]
    cams = _cams_f32(rig, (h, w), device)
    os.makedirs(args.output, exist_ok=True)
    grid = sampling.pixel_center_grid(h, w, device=device)
    for a in range(len(rig.ids)):
        cam_a = cams.index(a)
        for b in range(len(rig.ids)):
            if a == b:
                continue
            cam_b = cams.index(b)
            if camera_overlap(cam_a, cam_b) < args.min_overlap:
                continue
            world = cam.rig_point(cam_a, grid, float(args.depth))
            pix, valid = cam.sees(cam_b, world)
            sampled = sampling.bilinear_sample(colors[b], pix)
            blend = torch.where(valid[..., None], 0.5 * colors[a] + 0.5 * torch.nan_to_num(sampled), colors[a] * 0.2)
            io.write_color(os.path.join(args.output, f"{rig.ids[a]}_{rig.ids[b]}.png"), blend.cpu().numpy())
            log.info("overlap %s-%s written", rig.ids[a], rig.ids[b])


def geometric_consistency(args, device):
    """Returns {frame: the share of pixels adjusted at each iteration}."""
    from ..depth import pipeline as dp, solver

    shares = {}
    rig = cam.load_rig(args.rig)
    first = args.first or args.frame
    last = args.last or first
    nrig = cam.normalize_rig(rig)
    for fno in range(int(first), int(last) + 1):
        frame = io.frame_name(fno)
        colors = _colors(args, rig, frame, device)
        disps = np.stack([_load(args.disparity, cid, frame, io.read_disparity) for cid in rig.ids])
        fov = dp.generate_fov_masks(nrig, disps.shape[1:3], device)
        ctx = solver.make_level_context(nrig, nrig, colors, fov)
        cfg = solver.SolverConfig(mismatches_start_level=0, level=0, num_levels=2)
        out = torch.from_numpy(disps).to(device)
        shares[frame] = []
        for it in range(args.iterations):
            out, mask = solver.handle_mismatches(ctx, cfg, out)
            shares[frame].append(mask.to(torch.float32).mean().item())
            log.info("%s iteration %d: %.2f%% pixels adjusted", frame, it, 100.0 * shares[frame][-1])
        out = out.cpu().numpy()
        for i, cid in enumerate(rig.ids):
            d = os.path.join(args.output, cid)
            os.makedirs(d, exist_ok=True)
            io.write_disparity(os.path.join(d, frame + ".pfm"), out[i])
    return shares


def generate_keypoint_projections(args, device):
    rig_path = args.rig or args.camera_rig
    output = args.output or args.output_dir
    assert rig_path, "--rig (or --camera_rig) is required"
    assert output, "--output (or --output_dir) is required"
    args.output = output
    rig = cam.filter_destinations(cam.load_rig(rig_path), args.cameras)
    w, h = (int(v) for v in rig.cameras.resolution[0].tolist())
    cams = _cams_f32(rig, (h, w), device)
    lin = np.linspace(-args.extent, args.extent, args.grid)
    pts = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
    pts_t = torch.from_numpy(pts).to(device)
    os.makedirs(args.output, exist_ok=True)
    for i, cid in enumerate(rig.ids):
        pix, valid = cam.sees(cams.index(i), pts_t)
        img = np.zeros((h, w, 3), np.float32)
        p = pix[valid].cpu().numpy()
        xi = np.clip(p[:, 0].astype(int), 0, w - 1)
        yi = np.clip(p[:, 1].astype(int), 0, h - 1)
        img[yi, xi] = [0, 1, 0]
        io.write_color(os.path.join(args.output, f"{cid}.png"), img)
        log.info("%s: %d keypoints projected", cid, len(p))


def main(argv=None, *, device=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="tool", required=True)

    s = sub.add_parser("generate_equirect")
    s.add_argument("--rig", required=True)
    s.add_argument("--color", required=True)
    s.add_argument("--output", required=True)
    s.add_argument("--cameras", default="")
    s.add_argument("--frame", default="000000")
    s.add_argument("--num_depths", type=int, default=5)
    s.add_argument("--min_depth", type=float, default=1.0)
    s.add_argument("--max_depth", type=float, default=100.0)
    s.add_argument("--eqr_width", type=int, default=1024)
    s.add_argument("--eqr_height", type=int, default=512)
    s.set_defaults(fn=generate_equirect)

    s = sub.add_parser("generate_camera_overlaps")
    s.add_argument("--rig", required=True)
    s.add_argument("--color", required=True)
    s.add_argument("--output", required=True)
    s.add_argument("--cameras", default="")
    s.add_argument("--frame", default="000000")
    s.add_argument("--depth", type=float, default=10.0)
    s.add_argument("--min_overlap", type=float, default=0.1)
    s.add_argument("--scale", type=float, default=1.0,
                   help="image scale factor before overlap render")
    s.set_defaults(fn=generate_camera_overlaps)

    s = sub.add_parser("geometric_consistency")
    s.add_argument("--rig", required=True)
    s.add_argument("--color", required=True)
    s.add_argument("--disparity", required=True)
    s.add_argument("--output", required=True)
    s.add_argument("--frame", default="000000")
    s.add_argument("--first", default="", help="first frame (overrides --frame)")
    s.add_argument("--last", default="", help="last frame")
    s.add_argument("--iterations", type=int, default=2)
    s.set_defaults(fn=geometric_consistency)

    s = sub.add_parser("generate_keypoint_projections")
    s.add_argument("--rig", default="")
    s.add_argument("--camera_rig", default="", help=(
        "alias of --rig (the canonical res/flags file uses --camera_rig; "
        "the binary defines --rig, GenerateKeypointProjections.cpp:37)"))
    s.add_argument("--output", default="")
    s.add_argument("--output_dir", default="", help="alias of --output (reference name)")
    s.add_argument("--cameras", default="")
    s.add_argument("--grid", type=int, default=10)
    s.add_argument("--extent", type=float, default=10.0)
    s.set_defaults(fn=generate_keypoint_projections)

    args = p.parse_args(argv)
    return args.fn(args, resolve_device(device))


if __name__ == "__main__":
    main()
