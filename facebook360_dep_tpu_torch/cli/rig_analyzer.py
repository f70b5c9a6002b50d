"""RigAnalyzer equivalent: rig geometry reports (rig/RigAnalyzer.cpp:30-45).
The port of ``facebook360_dep_tpu/cli/rig_analyzer.py``.

Coverage equirects (how many cameras see each direction at a given depth),
vertical cross sections, per-camera overlap images, a per-camera geometry
table, and an OBJ export of camera frusta. The coverage counts run on the
card (float32 cameras, as the JAX package's); the frusta and the table on
the host.

    python -m facebook360_dep_tpu_torch.cli.rig_analyzer --rig <rig.json> --output <dir>
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

log = logging.getLogger("rig_analyzer")


def _cams(rig: cam.Rig, device) -> cam.Camera:
    return cam.normalize_rig(rig).cameras.to(device, torch.float32)


def _count_seen(cams: cam.Camera, world: torch.Tensor, skip: int = -1) -> np.ndarray:
    """(...) int64: the cameras of the stack ``cams`` that see each world
    point (..., 3), leaving out camera ``skip``."""
    n = cams.type_code.shape[0]
    _, seen = cam.sees(cams, world.expand((n,) + world.shape))
    if skip >= 0:
        seen[skip] = False
    return seen.sum(dim=0).cpu().numpy()


def coverage_equirect(rig: cam.Rig, width: int, height: int, depth: float, device=None) -> np.ndarray:
    """(H, W) int: number of cameras seeing each equirect direction at depth."""
    cams = _cams(rig, device)
    dirs = dibr.equirect_dirs(width, height, device=cams.position.device)
    return _count_seen(cams, dirs * depth)


def frusta_obj(rig: cam.Rig, scale: float = 0.1) -> tuple[np.ndarray, np.ndarray]:
    """Camera frusta as a wireframe-ish triangle mesh for OBJ export (host)."""
    verts, faces = [], []
    for i in range(len(rig.ids)):
        c = cam.camera_to_numpy(rig.camera(i))
        base = len(verts)
        origin = c.position
        fwd, up, right = -c.rotation[2], c.rotation[1], c.rotation[0]
        verts.append(origin)
        for sy in (-1, 1):
            for sx in (-1, 1):
                verts.append(origin + scale * (fwd + 0.6 * sx * right + 0.45 * sy * up))
        for a, b in [(1, 2), (2, 4), (4, 3), (3, 1)]:
            faces.append([base, base + a, base + b])
    return np.asarray(verts), np.asarray(faces, np.uint32)


def cross_section_coverage(rig: cam.Rig, size: int, extent: float, device=None) -> np.ndarray:
    """(size, size) int: cameras seeing each point of the vertical (x, z)
    slice through the rig center (RigAnalyzer cross sections)."""
    cams = _cams(rig, device)
    lin = np.linspace(-extent, extent, size, dtype=np.float32)
    xs, zs = np.meshgrid(lin, lin)
    world = torch.from_numpy(np.stack([xs, np.zeros_like(xs), zs], axis=-1)).to(cams.position.device)
    return _count_seen(cams, world)


def camera_overlap_image(rig: cam.Rig, cam_id: str, depth: float, device=None) -> np.ndarray:
    """(H, W) int: for each pixel of ``cam_id``, how many OTHER cameras see
    the world point it hits at ``depth`` (RigAnalyzer --output_camera)."""
    cams = _cams(rig, device)
    dev = cams.position.device
    i = rig.find(cam_id)
    w, h = (int(v) for v in rig.cameras.resolution[i].tolist())
    w, h = min(w, 1024), min(h, 1024)
    grid = sampling.pixel_center_grid(h, w, device=dev) / torch.tensor([w, h], dtype=torch.float32, device=dev)
    world = cam.rig_point(cams.index(i), grid, torch.tensor(float(depth), dtype=torch.float32, device=dev))
    return _count_seen(cams, world, skip=i)


def make_named_arrangement(name: str, rig: cam.Rig) -> cam.Rig:
    """Clone camera 0 into a named arrangement (RigAnalyzer.cpp:487-488
    makeNamedArrangement; subset: ring4, tetra, cube)."""
    c0 = rig.camera(0)
    radius = float(np.linalg.norm(c0.position.cpu().numpy())) or 0.2

    def looking(fwd, up_hint=(0.0, 0.0, 1.0)):
        fwd = np.asarray(fwd, np.float64)
        fwd /= np.linalg.norm(fwd)
        up = np.asarray(up_hint, np.float64)
        if abs(np.dot(up, fwd)) > 0.9:
            up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        rot = np.stack([right, up, -fwd], axis=0)
        return c0._replace(position=torch.from_numpy(radius * fwd).to(c0.position),
                           rotation=torch.from_numpy(rot).to(c0.rotation))

    if name == "ring4":
        dirs = [(1, 0, 0), (0, 1, 0), (-1, 0, 0), (0, -1, 0)]
    elif name == "tetra":
        dirs = [(1, 1, 1), (1, -1, -1), (-1, 1, -1), (-1, -1, 1)]
    elif name == "cube":
        dirs = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    else:
        raise SystemExit(
            f"--rearrange {name}: supported arrangements are ring4, tetra, cube "
            "(reference also names ballcam24/carbon0/carbon1/diamond)")
    cams = [looking(d) for d in dirs]
    ids = tuple(f"cam{k}" for k in range(len(cams)))
    return cam.Rig(cameras=cam.stack_cameras(cams), ids=ids, groups=("",) * len(cams))


def _write_count(path, cov: np.ndarray) -> None:
    io.write_color(path, np.repeat((cov / max(cov.max(), 1))[..., None], 3, axis=-1))


def main(argv=None, *, device=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rig", required=True)
    p.add_argument("--output", default="", help="report directory (coverage pngs + rig.obj)")
    p.add_argument("--depths", default="1,5,50", help="coverage sweep depths (m)")
    p.add_argument("--eqr_width", type=int, default=512)
    p.add_argument("--eqr_height", type=int, default=256)
    p.add_argument("--min_distance", type=float, default=0.5, help="test depth (m)")
    p.add_argument("--output_equirect", default="", help="coverage equirect image path (.ppm/.png)")
    p.add_argument("--output_cross_section", default="", help="vertical-slice coverage image path")
    p.add_argument("--output_camera", default="", help="per-camera overlap-count image path")
    p.add_argument("--output_camera_id", default="", help="camera id for --output_camera")
    p.add_argument("--output_obj", default="", help="camera-frusta OBJ path")
    p.add_argument("--output_rig", default="", help="write the (rearranged) rig json here")
    p.add_argument("--rearrange", default="", help=(
        "clone camera 0 into a named arrangement: ring4, tetra, cube "
        "(RigAnalyzer.cpp:487)"))
    args = p.parse_args(argv)
    dev = resolve_device(device)

    rig = cam.load_rig(args.rig)
    if args.rearrange:
        rig = make_named_arrangement(args.rearrange, rig)
        log.info("rearranged into %s: %d cameras", args.rearrange, rig.num_cameras)
    if args.output_rig:
        cam.save_rig(args.output_rig, rig)
        log.info("wrote %s", args.output_rig)
    if args.output_equirect:
        _write_count(args.output_equirect, coverage_equirect(rig, args.eqr_width, args.eqr_height,
                                                             args.min_distance, dev))
        log.info("wrote %s", args.output_equirect)
    if args.output_cross_section:
        _write_count(args.output_cross_section, cross_section_coverage(rig, args.eqr_height,
                                                                       2.0 * args.min_distance + 1.0, dev))
        log.info("wrote %s", args.output_cross_section)
    if args.output_camera:
        cam_id = args.output_camera_id or rig.ids[0]
        _write_count(args.output_camera, camera_overlap_image(rig, cam_id, args.min_distance, dev))
        log.info("wrote %s (%s)", args.output_camera, cam_id)
    if args.output_obj:
        from ..stream import mesh as mesh_mod

        v, f = frusta_obj(rig)
        mesh_mod.write_obj(args.output_obj, v, f)
        log.info("wrote %s", args.output_obj)
    if not args.output:
        return
    os.makedirs(args.output, exist_ok=True)

    for i, cam_id in enumerate(rig.ids):
        c = cam.camera_to_numpy(rig.camera(i))
        log.info(
            "%s: position %s forward %s fov %.3f rad focal %.1f",
            cam_id, c.position, -c.rotation[2], float(np.arccos(np.clip(c.cos_fov, -1, 1))),
            float(c.focal[0]),
        )

    for depth in (float(d) for d in args.depths.split(",") if d):
        cov = coverage_equirect(rig, args.eqr_width, args.eqr_height, depth, dev)
        log.info(
            "depth %.1f m: min coverage %d, mean %.2f, %%>=2 cams: %.1f%%",
            depth, cov.min(), cov.mean(), 100.0 * (cov >= 2).mean(),
        )
        _write_count(os.path.join(args.output, f"coverage_{depth:g}m.png"), cov)

    from ..stream import mesh as mesh_mod

    v, f = frusta_obj(rig)
    mesh_mod.write_obj(os.path.join(args.output, "rig.obj"), v, f)
    log.info("wrote rig.obj with %d cameras", len(rig.ids))


if __name__ == "__main__":
    main()
