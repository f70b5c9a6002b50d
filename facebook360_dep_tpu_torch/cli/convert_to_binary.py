"""ConvertToBinary equivalent: disparity -> simplified mesh (.vtx/.idx),
color -> BC7/RGBA, plus striped fusion + catalog. The port of
``facebook360_dep_tpu/cli/convert_to_binary.py``: the same flags, defaults
and output tree, byte for byte.

Flags mirror ``mesh_stream/ConvertToBinary.cpp:63-86``; flow follows
convertDepth/convertColor (:118-230) and the fusion step (:281-301).
Disparity -> depth, its ``--depth_scale`` and foreground-mask resizes and the
equi-error vertex grid run on the device; faces, QEM simplification, BC7
and fusion are host codecs (``stream/native.py``). The (frame, camera) tasks
run on a thread pool: a forked process pool would not carry CUDA, and the
native calls release the GIL.

    python -m facebook360_dep_tpu_torch.cli.convert_to_binary --rig <rig.json> --bin <out>/bin \\
        --color <color dir> --disparity <disparity dir> --fused <out>/fused
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import resolve_device
from ..core import camera as cam, io
from ..stream import adaptive as adaptive_mod
from ..stream import fusion, mesh, native

log = logging.getLogger("convert")

FLT_MIN = float(np.finfo(np.float32).tiny)


def nearest_index_scaled(src: int, scale: float) -> np.ndarray:
    """Source index of each output index of ``cv2.resize(img, None, fx=scale,
    fy=scale, interpolation=INTER_NEAREST)`` along one axis: the output has
    ``round(src * scale)`` entries (OpenCV's saturate_cast rounds half to
    even, as Python's round does) and samples ``min(floor(d * (1 / scale)),
    src - 1)``, unlike the ``dsize`` form (:func:`io.nearest_index`), which
    samples at src / dst."""
    dst = int(round(src * scale))
    return np.minimum(np.floor(np.arange(dst) * (1.0 / scale)).astype(np.int64), src - 1)


def _gather_2d(img: torch.Tensor, rows: np.ndarray, cols: np.ndarray) -> torch.Tensor:
    dev = img.device
    return img[torch.from_numpy(rows).to(dev)][:, torch.from_numpy(cols).to(dev)]


def convert_depth(camera, cam_id, disparity, bin_dir, triangles=150000, tear_ratio=0.95, depth_scale=1.0,
                  foreground_mask=None, adaptive=True, mesh_tol_rel=1e-3, *, device=None):
    """One camera's disparity map (numpy or tensor) -> (vertexes (V, 3)
    float32, faces (F, 3) uint32) numpy: the equi-error grid on ``device``
    (None: the card), then the host's face builder, mask and QEM simplifier.
    Creates ``bin_dir/cam_id``."""
    dev = resolve_device(device)
    depth = torch.reciprocal(torch.as_tensor(disparity, dtype=torch.float32).to(dev))
    if depth_scale < 1:
        h0, w0 = depth.shape
        depth = _gather_2d(depth, nearest_index_scaled(h0, depth_scale), nearest_index_scaled(w0, depth_scale))
    h, w = depth.shape
    vertexes = mesh.get_vertexes_equi_error(depth, camera)
    vertex_mask = torch.isfinite(depth)
    if foreground_mask is not None:  # cv2.resize(mask, (w, h), INTER_NEAREST)
        fg = torch.as_tensor(np.asarray(foreground_mask, bool)).to(dev)
        vertex_mask &= _gather_2d(fg, io.nearest_index(fg.shape[0], h), io.nearest_index(fg.shape[1], w))
    vertexes, vertex_mask = vertexes.cpu().numpy(), vertex_mask.cpu().numpy()
    if adaptive:
        # tiled-LOD pre-decimation (stream/adaptive.py): full res at tears
        # and mask edges, coarse crack-free tiles on smooth surface, which
        # cuts the serial QEM stage's input ~10-100x at 2K
        z = vertexes.reshape(h, w, 3)[..., 2]
        faces = adaptive_mod.build_adaptive_faces(z, vertex_mask, tear_ratio=tear_ratio, tol_rel=mesh_tol_rel)
    else:
        faces = mesh.get_faces(vertexes, w, h, tear_ratio=tear_ratio)
    vertexes, faces = mesh.apply_mask(vertexes, faces, vertex_mask)
    if triangles > 0 and len(faces) > triangles:
        vertexes, faces = native.simplify_mesh(vertexes, faces, triangles, strictness=0.2)
        # slightly negative depths blow up to -inf in the viewer's inverse
        vertexes[:, 2] = np.where(vertexes[:, 2] < 0, FLT_MIN, vertexes[:, 2])
    os.makedirs(os.path.join(bin_dir, cam_id), exist_ok=True)
    return vertexes, faces


def gamma_correct_to_rgba8(color: np.ndarray, gamma_correction: float) -> np.ndarray:
    """Float RGB [0,1] -> gamma-corrected RGBA8 (BC7Util.h:41-66), in numpy
    float32 on the host, as the JAX package computes it: ``(x * 255 + 0.5)``
    truncates, so a power an ulp away from numpy's would change bytes that
    the BC7 blocks depend on."""
    rgb = (np.power(np.clip(color[..., :3], 0, 1), gamma_correction) * 255.0 + 0.5).astype(np.uint8)
    alpha = np.full(rgb.shape[:2] + (1,), 255, np.uint8)
    return np.concatenate([rgb, alpha], axis=-1)


def _load(root, cam_id, frame, loader):
    return loader(io.frame_path(os.path.join(root, cam_id), frame))


def convert_one(args: argparse.Namespace, camera, cam_id: str, frame: str, *, device=None) -> dict:
    """Full per-(frame, camera) conversion: mesh (+QEM simplify) and/or BC7,
    one ThreadPool task of the reference's ConvertToBinary.cpp. Returns
    {"cam_id", "frame", "vertices", "faces", "mesh_s", "color_s", "message"}."""
    formats = {f.strip() for f in args.output_formats.split(",") if f.strip()}
    out_dir = os.path.join(args.bin, cam_id)
    os.makedirs(out_dir, exist_ok=True)
    report = []
    rec = dict(cam_id=cam_id, frame=frame, vertices=None, faces=None, mesh_s=0.0, color_s=0.0)
    if args.disparity and formats & {"vtx", "idx", "obj", "pfm"}:
        t = time.perf_counter()
        disp = _load(args.disparity, cam_id, frame, io.read_disparity)
        fg = _load(args.foreground_masks, cam_id, frame, io.read_mask) if args.foreground_masks else None
        v, f = convert_depth(camera, cam_id, disp, args.bin, triangles=args.triangles, tear_ratio=args.tear_ratio,
                             depth_scale=args.depth_scale, foreground_mask=fg, adaptive=args.adaptive_mesh,
                             mesh_tol_rel=args.mesh_tol_rel, device=device)
        report.append(f"{len(v)} vertices, {len(f)} faces")
        if formats & {"vtx", "idx"}:
            mesh.write_vtx_idx(os.path.join(out_dir, frame + ".vtx"), os.path.join(out_dir, frame + ".idx"), v, f)
        if "obj" in formats:
            mesh.write_obj(os.path.join(out_dir, frame + ".obj"), v, f)
        rec.update(vertices=len(v), faces=len(f), mesh_s=time.perf_counter() - t)
    if args.color and formats & {"bc7", "rgba"}:
        t = time.perf_counter()
        color = _load(args.color, cam_id, frame, io.read_color)
        if args.color_scale < 1:
            color = io.resize_image(
                color, (int(color.shape[1] * args.color_scale), int(color.shape[0] * args.color_scale)))
        # crop to 4px multiples for block compression
        h4, w4 = color.shape[0] // 4 * 4, color.shape[1] // 4 * 4
        rgba = gamma_correct_to_rgba8(color[:h4, :w4], args.gamma_correction)
        if "bc7" in formats:
            native.compress_bc7(rgba).tofile(os.path.join(out_dir, frame + ".bc7"))
        if "rgba" in formats:
            rgba.tofile(os.path.join(out_dir, frame + ".rgba"))
        # sidecar with the true texture dims: normalized rigs carry
        # resolution [1,1], so consumers cannot infer them from the camera
        # aspect (fusion records this in the catalog)
        with open(os.path.join(out_dir, frame + ".meta.json"), "w") as f:
            json.dump({"color_wh": [int(rgba.shape[1]), int(rgba.shape[0])]}, f)
        report.append("color blocks")
        rec["color_s"] = time.perf_counter() - t
    rec["message"] = f"{cam_id} {frame}: " + ", ".join(report)
    return rec


def _flag(v) -> bool:
    return str(v).lower() in ("1", "true")


def main(argv=None, *, device=None):
    """Parse ``argv``, convert every (frame, camera) with the device work on
    ``device`` (None: the card), then fuse. Returns {"tasks": one
    :func:`convert_one` record a task, "convert_s", "fuse_s"} (wall times)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rig", required=True)
    p.add_argument("--bin", required=True, help="output binary directory")
    p.add_argument("--color", default="")
    p.add_argument("--disparity", default="")
    p.add_argument("--foreground_masks", default="")
    p.add_argument("--fused", default="", help="output fused directory (enables fusion)")
    p.add_argument("--cameras", default="")
    p.add_argument("--first", default="000000")
    p.add_argument("--last", default="000000")
    p.add_argument("--output_formats", default="vtx,idx,bc7", help="vtx,idx,pfm,obj,bc7,rgba")
    p.add_argument("--triangles", type=int, default=150000)
    p.add_argument("--adaptive_mesh", type=_flag, default=True,
                   help="tiled-LOD pre-decimation before QEM (full-res grid when false)")
    p.add_argument("--mesh_tol_rel", type=float, default=1e-3,
                   help="adaptive pre-decimation depth tolerance, relative to |z| (default sized to the "
                        "solver's refinement quantum; see stream/adaptive.py)")
    p.add_argument("--tear_ratio", type=float, default=0.95)
    p.add_argument("--color_scale", type=float, default=1.0)
    p.add_argument("--depth_scale", type=float, default=1.0)
    p.add_argument("--gamma_correction", type=float, default=2.2 / 1.8)
    p.add_argument("--run_conversion", type=_flag, default=True)
    p.add_argument("--fuse_strip", type=int, default=0,
                   help="number of strip files (ConvertToBinary.cpp:74); overrides --num_disks")
    p.add_argument("--num_disks", type=int, default=1)
    p.add_argument("--threads", type=int, default=-1)
    args = p.parse_args(argv)
    dev = resolve_device(device)

    rig = cam.filter_destinations(cam.load_rig(args.rig), args.cameras)
    formats = {f.strip() for f in args.output_formats.split(",") if f.strip()}
    frames = [io.frame_name(f) for f in range(int(args.first), int(args.last) + 1)]

    records, convert_s, fuse_s = [], 0.0, 0.0
    if args.run_conversion:
        t = time.perf_counter()
        tasks = [(rig.camera(i), cam_id, frame) for frame in frames for i, cam_id in enumerate(rig.ids)]
        workers = os.cpu_count() if args.threads < 0 else args.threads
        workers = max(1, min(workers or 1, len(tasks)))
        if workers == 1:
            records = [convert_one(args, *task, device=dev) for task in tasks]
        else:
            # per-(frame, camera) tasks, as the reference threads ConvertToBinary
            # (ThreadPool over frames/cameras, mesh_stream/ConvertToBinary.cpp)
            with ThreadPoolExecutor(workers) as pool:
                records = list(pool.map(lambda task: convert_one(args, *task, device=dev), tasks))
        for rec in records:
            log.info("%s", rec["message"])
        convert_s = time.perf_counter() - t

    if args.fused:
        t = time.perf_counter()
        exts = [f".{f}" for f in ("vtx", "idx", "bc7", "rgba") if f in formats]
        num_disks = args.fuse_strip if args.fuse_strip > 0 else args.num_disks
        fusion.fuse_frames(args.bin, args.fused, rig.ids, frames, exts, num_disks)
        fuse_s = time.perf_counter() - t
        log.info("fused %d frames into %s", len(frames), args.fused)
    return dict(tasks=records, convert_s=convert_s, fuse_s=fuse_s)


if __name__ == "__main__":
    main()
