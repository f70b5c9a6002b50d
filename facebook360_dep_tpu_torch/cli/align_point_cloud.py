"""AlignPointCloud equivalent: fit a similarity transform (R, t, s) aligning
the camera rig's reconstructed geometry to a LiDAR point cloud. The port of
``facebook360_dep_tpu/cli/align_point_cloud.py``.

Reference: ``rig/AlignPointCloud.cpp:34-53`` — projects the cloud into each
camera, ZNCC-matches against the captured images, and solves R/t/s with Ceres
under an outlier_factor * median rejection rule. Here the correspondence step
is geometric instead of photometric: each camera's estimated (background)
disparity is unprojected to world points on the card (or the caller's
``device``) and aligned to the cloud by trimmed ICP on the host — nearest
neighbors (scipy's KD-tree) + Umeyama similarity per iteration with the same
outlier rule — then the transform is applied to the rig.

    python -m facebook360_dep_tpu_torch.cli.align_point_cloud --point_cloud <cloud.xyz> \\
        --rig_in <rig.json> --disparity <disparity dir> --rig_out <aligned.json>
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from .. import resolve_device
from ..calib import rig_tools
from ..core import camera as cam, io
from ..ops import sampling

log = logging.getLogger("align_point_cloud")


def rig_world_points(rig: cam.Rig, disparity_dir: str, frame: str, max_points_per_cam: int = 20000):
    """Unproject every valid disparity pixel to world space (subsampled), on
    the device of the rig's tensors. Returns (P, 3) float64 numpy."""
    pts = []
    dev = rig.cameras.position.device
    for i, cam_id in enumerate(rig.ids):
        d = os.path.join(disparity_dir, cam_id)
        probe = io.first_image_in(d)
        if not probe:
            raise FileNotFoundError(f"no disparity images in {d}")
        disp = io.read_disparity(os.path.join(d, frame + os.path.splitext(probe)[1]))
        h, w = disp.shape
        c = cam.rescale(rig.camera(i).to(dtype=torch.float64), [w, h])
        grid = sampling.pixel_center_grid(h, w, device=dev)
        depth = torch.from_numpy(1.0 / np.maximum(disp, 1e-12)).to(dev)
        world = cam.rig_point(c, grid, depth).cpu().numpy()
        valid = np.isfinite(disp) & (disp > 0)
        p = world[valid]
        if len(p) > max_points_per_cam:
            sel = np.random.RandomState(i).choice(len(p), max_points_per_cam, replace=False)
            p = p[sel]
        pts.append(p)
        log.info("%s: %d world points", cam_id, len(p))
    return np.concatenate(pts).astype(np.float64)


def solve_similarity(src, dst, lock_rotation=False, lock_scale=False, lock_translation=False):
    """Umeyama similarity src->dst with optional locked components."""
    if lock_rotation and lock_translation and lock_scale:
        return np.eye(3), np.zeros(3), 1.0
    if lock_rotation:
        r = np.eye(3)
        if lock_scale:
            s = 1.0
        else:
            mu_s, mu_d = src.mean(0), dst.mean(0)
            num = np.sum((dst - mu_d) * (src - mu_s))
            den = np.sum((src - mu_s) ** 2)
            s = float(num / max(den, 1e-12))
        t = dst.mean(0) - s * (r @ src.mean(0)) if not lock_translation else np.zeros(3)
        return r, t, s
    r, t, s = rig_tools.umeyama(src, dst, with_scale=not lock_scale)
    if lock_translation:
        t = np.zeros(3)
    return r, t, s


def align_points_icp(
    rig_pts: np.ndarray,
    cloud: np.ndarray,
    iterations: int = 20,
    outlier_factor: float = 5.0,
    lock_rotation: bool = False,
    lock_scale: bool = False,
    lock_translation: bool = False,
):
    """Trimmed ICP: returns (R, t, s) with dst = s * R @ src + t mapping
    rig-frame points onto the cloud, plus the final median distance."""
    from scipy.spatial import cKDTree

    tree = cKDTree(cloud)
    r_total, t_total, s_total = np.eye(3), np.zeros(3), 1.0
    cur = rig_pts.copy()
    median = float("inf")
    for it in range(iterations):
        dist, idx = tree.query(cur, k=1)
        median = float(np.median(dist))
        keep = dist <= outlier_factor * max(median, 1e-12)
        if keep.sum() < 10:
            log.warning("iteration %d: only %d inliers", it, int(keep.sum()))
            break
        r, t, s = solve_similarity(
            cur[keep], cloud[idx[keep]], lock_rotation, lock_scale, lock_translation
        )
        cur = (s * (r @ cur.T)).T + t
        r_total = r @ r_total
        s_total = s * s_total
        t_total = s * (r @ t_total) + t
        log.info("iteration %d: median distance %.6f, inliers %d", it, median, int(keep.sum()))
    return r_total, t_total, s_total, median


def main(argv=None, *, device=None):
    """Parse ``argv``, align and write the rig; ``device`` None means the
    card. Returns the final median distance."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--point_cloud", required=True, help="xyz[+...] text point cloud (.pts/.xyz)")
    p.add_argument("--rig_in", required=True)
    p.add_argument("--rig_out", default="")
    p.add_argument("--output_rig", default="", help="alias of --rig_out (res/flags usage)")
    p.add_argument("--color", default="", help=(
        "color frames (reference scores lidar matches against color, "
        "AlignPointCloud.cpp:46-53; this implementation matches rendered "
        "depth so color is accepted for flag parity)"))
    p.add_argument("--disparity", required=True, help="per-camera disparity root")
    p.add_argument("--frame", default="000000")
    p.add_argument("--cameras", default="", help="comma-separated camera subset")
    p.add_argument("--outlier_factor", type=float, default=5.0)
    p.add_argument("--lock_rotation", action="store_true")
    p.add_argument("--lock_scale", action="store_true")
    p.add_argument("--lock_translation", action="store_true")
    p.add_argument("--iterations", type=int, default=20)
    p.add_argument("--max_points_per_cam", type=int, default=20000)
    args = p.parse_args(argv)
    dev = resolve_device(device)
    rig_out = args.rig_out or args.output_rig
    if not rig_out:
        raise ValueError("--rig_out (or --output_rig) is required")

    rig = cam.filter_destinations(cam.load_rig(args.rig_in), args.cameras)
    cloud = np.loadtxt(args.point_cloud)[:, :3].astype(np.float64)
    rig_pts = rig_world_points(rig._replace(cameras=rig.cameras.to(dev)), args.disparity, args.frame,
                               args.max_points_per_cam)

    r, t, s, median = align_points_icp(
        rig_pts, cloud, args.iterations, args.outlier_factor,
        args.lock_rotation, args.lock_scale, args.lock_translation,
    )
    log.info("final: scale %.6f, translation %s, median distance %.6f", s, t, median)
    aligned = rig_tools.transform_rig(rig, r, t, s)
    cam.save_rig(rig_out, aligned)
    log.info("wrote %s", rig_out)
    return median


if __name__ == "__main__":
    main()
