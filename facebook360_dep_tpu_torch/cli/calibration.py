"""Calibration CLIs: MatchCorners + GeometricCalibration + combined
Calibration binary equivalents. The port of
``facebook360_dep_tpu/cli/calibration.py``, with its flags, matches.json and
rig JSON contract and log lines.

Flags mirror ``calibration/GeometricCalibration.cpp:38-104`` (subset) and the
combined flow is ``CalibrationMain.cpp:34-44`` (matchCorners();
geometricCalibration();). Corner matching runs in float32 and the
triangulation and bundle adjustment in float64, on the card unless the
caller passes another ``device``:

    python -m facebook360_dep_tpu_torch.cli.calibration --color <root>/video/color_levels/level_0 \\
        --rig_in <rig.json> --matches <out>/matches.json --rig_out <out>/rig_calibrated.json
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np

from .. import resolve_device
from ..calib import calibration as geo
from ..calib import features
from ..core import camera as cam, io

log = logging.getLogger("calibration")


def _bool(v):
    return str(v).lower() in ("1", "true", "yes")


def load_green_channels(color_dir, rig, frame):
    grays = []
    for cam_id in rig.ids:
        d = os.path.join(color_dir, cam_id)
        probe = io.first_image_in(d)
        if not probe:
            raise FileNotFoundError(f"no images in {d}")
        img = io.read_color(os.path.join(d, frame + os.path.splitext(probe)[1]))
        grays.append(img[..., 1])  # green channel (MatchCorners loadChannels)
    return np.stack(grays)


def add_match_flags(p):
    p.add_argument("--color", required=True)
    p.add_argument("--rig_in", required=True)
    p.add_argument("--matches", required=True, help="output matches.json")
    p.add_argument("--frame", default="000000")
    p.add_argument("--max_corners", type=int, default=2000)
    p.add_argument("--min_depth_m", type=float, default=0.5)
    p.add_argument("--max_depth_m", type=float, default=1e4)


def _load_rig(path, dev) -> cam.Rig:
    rig = cam.load_rig(path)
    return rig._replace(cameras=rig.cameras.to(dev))


def run_match_corners(args, dev) -> dict:
    """Detect and match on ``dev``; writes and returns the matches.json dict."""
    rig = _load_rig(args.rig_in, dev)
    grays = load_green_channels(args.color, rig, args.frame)
    matches = features.match_corners(
        rig, grays, args.frame, args.min_depth_m, args.max_depth_m, args.max_corners
    )
    os.makedirs(os.path.dirname(os.path.abspath(args.matches)), exist_ok=True)
    with open(args.matches, "w") as f:
        json.dump(matches, f)
    total = sum(len(m["matches"]) for m in matches["all_matches"])
    log.info("wrote %d matches over %d pairs", total, len(matches["all_matches"]))
    return matches


def add_geo_flags(p, include_io=True):
    if include_io:
        p.add_argument("--rig_in", required=True)
        p.add_argument("--matches", default="", help="matches.json ('' = artificial points)")
    p.add_argument("--rig_out", required=True)
    p.add_argument("--pass_count", type=int, default=10)
    p.add_argument("--outlier_factor", type=float, default=5.0)
    p.add_argument("--robust", type=_bool, default=True)
    p.add_argument("--lock_positions", type=_bool, default=True)
    p.add_argument("--lock_rotations", type=_bool, default=False)
    p.add_argument("--lock_principals", type=_bool, default=False)
    p.add_argument("--lock_focal", type=_bool, default=False)
    p.add_argument("--lock_distortion", type=_bool, default=True)
    p.add_argument("--shared_distortion", type=_bool, default=True)
    p.add_argument("--shared_principal_and_focal", type=_bool, default=False)
    p.add_argument("--force_in_front", type=_bool, default=True)
    p.add_argument("--keep_invalid_traces", type=_bool, default=False)
    p.add_argument("--reference_camera", default="")
    p.add_argument("--max_error", type=float, default=0.5)
    p.add_argument("--match_score_threshold", type=float, default=0.75)
    p.add_argument("--point_count", type=int, default=10000)
    p.add_argument("--point_min_dist", type=float, default=1.0)
    p.add_argument("--point_error_stddev", type=float, default=0.5)
    p.add_argument("--perturb_positions", type=float, default=0.0)
    p.add_argument("--perturb_rotations", type=float, default=0.0)
    p.add_argument("--perturb_principals", type=float, default=0.0)
    p.add_argument("--perturb_focals", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--debug_dir", default="",
                   help="write match overlays + reprojection renders here (showMatches/showReprojections)")
    p.add_argument("--image_root", default="", help="imagery root for debug overlays")
    if include_io:
        # Calibration.cpp:11-14 defines these on the combined binary; the
        # standalone GeometricCalibration links the same TUs
        p.add_argument("--color", default="", help="imagery root (alias of --image_root)")
        p.add_argument("--frame", default="000000", help="frame for debug overlays")
    p.add_argument("--enable_timing", type=_bool, default=False,
                   help="log per-pass wall-clock (GeometricCalibration.cpp --enable_timing)")
    p.add_argument("--log_verbose", type=_bool, default=False,
                   help="DEBUG-level solver logging (ceres verbose equivalent)")


def run_geometric_calibration(args, dev, timings: dict | None = None) -> float:
    """The multi-pass solve on ``dev``; writes ``--rig_out`` and returns the
    final median reprojection error. ``timings`` as in
    :func:`geo.geometric_calibration`."""
    ground_truth = _load_rig(args.rig_in, dev)
    rig = ground_truth
    if any(
        v != 0
        for v in (args.perturb_positions, args.perturb_rotations, args.perturb_principals, args.perturb_focals)
    ):
        rig = cam.perturb_cameras(
            ground_truth,
            args.perturb_positions,
            args.perturb_rotations,
            args.perturb_principals,
            args.perturb_focals,
            seed=max(args.seed, 0),
        )

    if args.matches:
        feats, overlaps = geo.load_matches_json(args.matches, rig, args.match_score_threshold)
    else:
        log.info("no matches given: generating %d artificial points", args.point_count)
        feats, overlaps = geo.generate_artificial_points(
            ground_truth, args.point_count, args.point_min_dist, args.point_error_stddev,
            seed=max(args.seed, 0),
        )

    opts = geo.CalibrationOptions(
        pass_count=args.pass_count,
        outlier_factor=args.outlier_factor,
        robust=args.robust,
        lock_positions=args.lock_positions,
        lock_rotations=args.lock_rotations,
        lock_principals=args.lock_principals,
        lock_focal=args.lock_focal,
        lock_distortion=args.lock_distortion,
        shared_distortion=args.shared_distortion,
        shared_principal_and_focal=args.shared_principal_and_focal,
        force_in_front=args.force_in_front,
        keep_invalid_traces=args.keep_invalid_traces,
        reference_camera=args.reference_camera,
        max_error=args.max_error,
        match_score_threshold=args.match_score_threshold,
        debug_dir=args.debug_dir,
        image_root=args.image_root or getattr(args, "color", ""),
    )
    if getattr(args, "log_verbose", False):
        logging.getLogger("facebook360_dep_tpu_torch.calib").setLevel(logging.DEBUG)

    t0 = time.perf_counter()
    solved, median = geo.geometric_calibration(rig, feats, overlaps, opts, timings=timings)
    if getattr(args, "enable_timing", False):
        # reference format: boost::timer at GeometricCalibration.cpp:1196-1198
        log.info("-- Elapsed time: %.3f s (refine, %d passes)",
                 time.perf_counter() - t0, args.pass_count)
    cam.save_rig(args.rig_out, solved)
    report = geo.rig_rmse_report(solved, ground_truth)
    log.info("median reprojection error: %.4f px; rmse vs rig_in: %s", median, report)
    return median


def main_match_corners(argv=None, *, device=None):
    """MatchCorners; ``device`` None means the card. Returns the matches.json dict."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description="MatchCorners equivalent")
    add_match_flags(p)
    p.add_argument("--enable_timing", type=_bool, default=False,
                   help="log wall-clock (FeatureMatcher timing counters)")
    args = p.parse_args(argv)
    dev = resolve_device(device)

    t0 = time.perf_counter()
    matches = run_match_corners(args, dev)
    if args.enable_timing:
        log.info("-- Elapsed time: %.3f s (matchCorners)", time.perf_counter() - t0)
    return matches


def main_geometric(argv=None, *, device=None, timings: dict | None = None):
    """GeometricCalibration; ``device`` None means the card. Returns the
    final median reprojection error."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description="GeometricCalibration equivalent")
    add_geo_flags(p)
    args = p.parse_args(argv)
    return run_geometric_calibration(args, resolve_device(device), timings)


def main(argv=None, *, device=None, timings: dict | None = None):
    """Combined Calibration binary: matchCorners(); geometricCalibration();
    ``device`` None means the card. Returns the final median reprojection
    error; with ``timings`` a dict, also the seconds of ``match`` there."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    add_match_flags(p)
    add_geo_flags(p, include_io=False)
    args = p.parse_args(argv)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    run_match_corners(args, dev)
    if timings is not None:
        timings["match"] = time.perf_counter() - t0
    return run_geometric_calibration(args, dev, timings)


if __name__ == "__main__":
    main()
