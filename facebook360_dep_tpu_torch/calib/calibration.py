"""Geometric rig calibration: the GeometricCalibration equivalent. The port
of ``facebook360_dep_tpu/calib/calibration.py``.

Pipeline per pass (GeometricCalibration.cpp:995-1205 ``refine``):
  remove outlier matches -> assemble traces (union-find over pairwise
  matches) -> triangulate -> remove outlier traces -> re-assemble ->
  drop invalid traces (two features of one camera) -> triangulate (and,
  unlike the JAX package, drop the traces whose triangulation failed) ->
  bundle-adjust with the pass's locking schedule (focal/distortion locked in
  pass 0; distortion locked by default; positions locked by default, else
  reference-camera gauge) -> report median reprojection error.

Matches come from matches.json (``loadFeatureMap``/``loadOverlaps`` schema) or
from the artificial-points simulation mode (``generateArtificalPoints``,
GeometricCalibration.cpp, used with perturb_* flags to verify solver recovery
— the reference's ground-truth harness and ours).

The camera math (artificial points, outlier errors, triangulation, the
bundle adjustment) runs in float64 on the device of the rig's tensors; the
union-find and the trace bookkeeping stay host Python and numpy.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core import camera as cam
from . import ba

log = logging.getLogger("calibration")


@dataclass
class CalibrationOptions:
    """Mirrors GeometricCalibration.cpp:38-104 flags (subset)."""

    pass_count: int = 10
    outlier_factor: float = 5.0
    robust: bool = True
    lock_positions: bool = True
    lock_rotations: bool = False
    lock_principals: bool = False
    lock_focal: bool = False
    lock_distortion: bool = True
    shared_distortion: bool = True
    shared_principal_and_focal: bool = False
    force_in_front: bool = True
    keep_invalid_traces: bool = False
    reference_camera: str = ""
    min_traces: int = 10
    max_error: float = 0.5
    point_count: int = 10000
    point_min_dist: float = 1.0
    point_error_stddev: float = 0.5
    match_score_threshold: float = 0.75
    debug_dir: str = ""  # showMatches/showReprojections trigger (FLAGS_debug_dir)
    image_root: str = ""  # where debug imagery lives (black canvas if absent)
    extra: dict = field(default_factory=dict)


def _f64(rig: cam.Rig) -> cam.Camera:
    return rig.cameras.to(dtype=torch.float64)


# ---------------------------------------------------------------------------
# Matches: load / synthesize
# ---------------------------------------------------------------------------


def camera_id_from_image_path(path: str, rig: cam.Rig) -> int | None:
    """An image id contains exactly one camera id as a path component
    (getCameraIndex in the reference)."""
    parts = path.replace("\\", "/").split("/")
    stems = [p.rsplit(".", 1)[0] for p in parts]
    for i, cam_id in enumerate(rig.ids):
        if cam_id in parts or cam_id in stems:
            return i
    return None


def load_matches_json(path: str, rig: cam.Rig, score_threshold: float = 0.75):
    """Parse matches.json -> (features per image, overlap list).

    Schema (Keypoint.h:66-121 / loadFeatureMap / loadOverlaps): ``images`` maps
    image path -> [{x, y}, ...]; ``all_matches`` lists {image1, image2,
    matches: [{idx1, idx2, score}]}.
    """
    with open(path) as f:
        parsed = json.load(f)
    features = {}
    for image, feats in parsed["images"].items():
        if camera_id_from_image_path(image, rig) is None:
            log.info("ignoring image id %s", image)
            continue
        features[image] = np.asarray([[f["x"], f["y"]] for f in feats], np.float64)
    overlaps = []
    for ov in parsed["all_matches"]:
        i0, i1 = ov["image1"], ov["image2"]
        if i0 not in features or i1 not in features:
            continue
        pairs = [
            (int(m["idx1"]), int(m["idx2"]))
            for m in ov["matches"]
            if score_threshold == 0 or m.get("score", 1.0) >= score_threshold
        ]
        overlaps.append((i0, i1, pairs))
    return features, overlaps


def generate_artificial_points(
    rig: cam.Rig, count: int = 10000, min_dist: float = 1.0, error_stddev: float = 0.5, seed: int = 0
):
    """Synthetic observations with known ground truth
    (generateArtificalPoints, GeometricCalibration.cpp). The draws are the
    JAX package's, in its order; the projections run on the rig's device."""
    rng = np.random.RandomState(seed)
    n = len(rig.ids)
    features = {cam_id: [] for cam_id in rig.ids}
    overlaps_map = {}

    longitude = rng.uniform(-np.pi, np.pi, count)
    z = rng.uniform(-1, 1, count)
    xy = np.sqrt(1 - z * z)
    pts = np.stack([xy * np.cos(longitude), xy * np.sin(longitude), z], axis=-1)
    disparity = rng.uniform(0, 1 / min_dist, count)
    pts = pts / np.maximum(disparity, 1e-9)[:, None]

    cams = _f64(rig)
    pix, valid = cam.sees(cams, torch.as_tensor(pts, device=cams.position.device)[None])
    pix_all, valid_all = pix.cpu().numpy(), valid.cpu().numpy()  # (N, count, ...)
    noise = rng.normal(0, error_stddev, (n, count, 2)) if error_stddev > 0 else 0

    for p in range(count):
        seen = np.nonzero(valid_all[:, p])[0]
        idxs = {}
        for i in seen:
            features[rig.ids[i]].append(pix_all[i, p] + (noise[i, p] if error_stddev else 0))
            idxs[i] = len(features[rig.ids[i]]) - 1
        for a in range(len(seen)):
            for b in range(a):
                key = (rig.ids[seen[b]], rig.ids[seen[a]])
                overlaps_map.setdefault(key, []).append((idxs[seen[b]], idxs[seen[a]]))

    features = {k: np.asarray(v, np.float64).reshape(-1, 2) for k, v in features.items()}
    overlaps = [(i0, i1, pairs) for (i0, i1), pairs in overlaps_map.items()]
    return features, overlaps


# ---------------------------------------------------------------------------
# Traces (assembleTraces / removeInvalidTraces)
# ---------------------------------------------------------------------------


class _UnionFind:
    def __init__(self):
        self.parent = {}

    def find(self, x):
        p = self.parent.setdefault(x, x)
        while p != x:
            self.parent[x] = p = self.parent.setdefault(p, p)
            x, p = p, self.parent[p]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def assemble_traces(features, overlaps, rig: cam.Rig, keep_invalid=False):
    """Union-find over matches -> traces; drop traces with two features from
    the same camera unless keep_invalid. Returns observation arrays
    (obs_cam, obs_trace, obs_pixel) and the trace count."""
    uf = _UnionFind()
    for i0, i1, pairs in overlaps:
        for a, b in pairs:
            uf.union((i0, a), (i1, b))

    groups = {}
    for i0, i1, pairs in overlaps:
        for a, b in pairs:
            root = uf.find((i0, a))
            g = groups.setdefault(root, set())
            g.add((i0, a))
            g.add((i1, b))

    camera_of = {img: camera_id_from_image_path(img, rig) for img in features}
    obs_cam, obs_trace, obs_pixel = [], [], []
    trace_id = 0
    for members in groups.values():
        cams_seen = [camera_of[img] for img, _ in members]
        if len(members) < 2:
            continue
        if not keep_invalid and len(set(cams_seen)) != len(cams_seen):
            continue  # two features from one camera -> invalid trace
        for (img, feat_idx), ci in zip(members, cams_seen):
            obs_cam.append(ci)
            obs_trace.append(trace_id)
            obs_pixel.append(features[img][feat_idx])
        trace_id += 1
    return (
        np.asarray(obs_cam, np.int32),
        np.asarray(obs_trace, np.int32),
        np.asarray(obs_pixel, np.float64).reshape(-1, 2),
        trace_id,
    )


def triangulate_traces(rig: cam.Rig, obs_cam, obs_trace, obs_pixel, n_traces, force_in_front=True):
    """Pad each trace's observations to the longest trace and run the
    batched GN triangulator on the rig's device. Returns (n_traces, 3)
    float64 points there."""
    order = np.argsort(obs_trace, kind="stable")
    oc, ot, op = obs_cam[order], obs_trace[order], obs_pixel[order]
    counts = np.bincount(ot, minlength=n_traces)
    max_obs = max(int(counts.max()), 2)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(ot)) - starts[ot]
    pad_cam = np.zeros((n_traces, max_obs), np.int32)
    pad_pix = np.zeros((n_traces, max_obs, 2), np.float64)
    pad_valid = np.zeros((n_traces, max_obs), bool)
    pad_cam[ot, slot] = oc
    pad_pix[ot, slot] = op
    pad_valid[ot, slot] = True
    return ba.triangulate(_f64(rig), pad_cam, pad_pix, pad_valid, force_in_front=force_in_front)


def remove_outlier_observations(rig, obs_cam, obs_trace, obs_pixel, points, factor):
    """Drop observations whose reprojection error exceeds factor x the
    per-camera median (removeOutliersFromCameras). The errors are formed on
    the rig's device, the medians on the host."""
    cams = _f64(rig)
    dev = cams.position.device
    c = cams.index(torch.as_tensor(np.asarray(obs_cam), dtype=torch.int64, device=dev))
    pts = torch.as_tensor(points, dtype=torch.float64, device=dev)[
        torch.as_tensor(np.asarray(obs_trace), dtype=torch.int64, device=dev)]
    pred = cam.pixel(c, pts)
    errs = torch.linalg.vector_norm(pred - torch.as_tensor(obs_pixel, device=dev), dim=-1).cpu().numpy()
    keep = np.ones(len(obs_cam), bool)
    for i in range(len(rig.ids)):
        sel = obs_cam == i
        if not sel.any():
            continue
        # failed triangulations yield NaN errors: exclude them from the
        # median and always reject them
        med = np.nanmedian(errs[sel]) if np.isfinite(errs[sel]).any() else np.inf
        keep[sel] = np.isfinite(errs[sel]) & (errs[sel] <= factor * max(med, 1e-12))
    return keep


# ---------------------------------------------------------------------------
# The pass loop
# ---------------------------------------------------------------------------


def _keep_observations(obs_cam, obs_trace, obs_pixel, n_traces, keep):
    """The observations ``keep`` selects, with the traces that keep >= 2 of
    them re-indexed in order. Returns the arrays, the new trace count and
    which old traces survived."""
    obs_cam, obs_trace, obs_pixel = obs_cam[keep], obs_trace[keep], obs_pixel[keep]
    counts = np.bincount(obs_trace, minlength=n_traces)
    alive = counts >= 2
    remap = -np.ones(n_traces, np.int64)
    remap[alive] = np.arange(alive.sum())
    sel = alive[obs_trace]
    return obs_cam[sel], remap[obs_trace[sel]].astype(np.int32), obs_pixel[sel], int(alive.sum()), alive


def _free_mask(problem: ba.Problem, opts: CalibrationOptions, pass_idx: int, ref_idx: int):
    s = problem.slices()
    mask = np.ones(problem.theta_size, bool)

    def lock(name):
        a, b = s[name]
        mask[a:b] = False

    positions_unlocked = (not opts.lock_positions) and pass_idx != 0
    if not positions_unlocked:
        lock("position")
    else:
        mask[s["position"][0] + 3 * ref_idx : s["position"][0] + 3 * ref_idx + 3] = False
    if opts.lock_rotations:
        lock("rotvec")
    if positions_unlocked:  # reference camera rotation also locked
        mask[s["rotvec"][0] + 3 * ref_idx : s["rotvec"][0] + 3 * ref_idx + 3] = False
    if opts.lock_principals:
        lock("principal")
    if pass_idx == 0 or opts.lock_focal:
        lock("focal")
    if pass_idx == 0 or opts.lock_distortion:
        lock("distortion")
    return mask


@contextlib.contextmanager
def _lap(timings: dict | None, device: torch.device, name: str):
    """Adds the block's wall seconds, the device's queue drained, to
    ``timings[name]`` when ``timings`` is a dict."""
    t0 = time.perf_counter()
    yield
    if timings is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


def geometric_calibration(
    rig_in: cam.Rig,
    features,
    overlaps,
    opts: CalibrationOptions | None = None,
    timings: dict | None = None,
) -> tuple[cam.Rig, float]:
    """Full multi-pass calibration on the device of ``rig_in``'s tensors.
    Returns (calibrated rig, median error px). With ``timings`` a dict, adds
    the seconds of each stage to it: ``assemble`` (host bookkeeping),
    ``triangulate`` (both triangulations and the outlier test) and ``lm``
    (the bundle adjustment), and each pass's median to ``pass_medians``."""
    opts = opts or CalibrationOptions()
    rig = rig_in
    median = float("nan")
    ref_idx = rig.ids.index(opts.reference_camera) if opts.reference_camera else 0
    rel_idx = (ref_idx + 1) % len(rig.ids)
    dev = rig.cameras.position.device

    if opts.debug_dir:
        from . import overlays

        overlays.save_match_overlays(
            opts.debug_dir, 0, rig, features, overlaps, image_root=opts.image_root
        )

    for pass_idx in range(opts.pass_count):
        with _lap(timings, dev, "assemble"):
            obs_cam, obs_trace, obs_pixel, n_traces = assemble_traces(
                features, overlaps, rig, keep_invalid=opts.keep_invalid_traces
            )
        if n_traces == 0:
            raise RuntimeError("no traces assembled — no matches?")
        with _lap(timings, dev, "triangulate"):
            points = triangulate_traces(
                rig, obs_cam, obs_trace, obs_pixel, n_traces, opts.force_in_front
            )
            keep = remove_outlier_observations(
                rig, obs_cam, obs_trace, obs_pixel, points, opts.outlier_factor
            )
        obs_cam, obs_trace, obs_pixel, n_traces, _ = _keep_observations(
            obs_cam, obs_trace, obs_pixel, n_traces, keep)
        if n_traces == 0:
            raise RuntimeError(
                "all traces rejected as outliers — check rig initialization / match quality"
            )
        with _lap(timings, dev, "triangulate"):
            points = triangulate_traces(
                rig, obs_cam, obs_trace, obs_pixel, n_traces, opts.force_in_front
            )
            # a trace whose second triangulation failed would make every LM
            # step non-finite (the JAX package then reports a NaN median):
            # drop it
            finite = torch.isfinite(points).all(1).cpu().numpy()
            if not finite.all():
                log.info("pass %d: dropped %d traces whose triangulation failed", pass_idx, int((~finite).sum()))
                obs_cam, obs_trace, obs_pixel, n_traces, alive = _keep_observations(
                    obs_cam, obs_trace, obs_pixel, n_traces, finite[obs_trace])
                points = points[torch.as_tensor(alive, device=points.device)]
                if n_traces == 0:
                    raise RuntimeError("every trace's triangulation failed")

        with _lap(timings, dev, "lm"):
            problem = ba.make_problem(
                rig,
                obs_cam,
                obs_trace,
                obs_pixel,
                shared_principal_and_focal=opts.shared_principal_and_focal,
                shared_distortion=opts.shared_distortion,
            )
            theta0 = ba.pack_theta(problem, rig)
            free = _free_mask(problem, opts, pass_idx, ref_idx)
            baseline = None
            if (not opts.lock_positions) and pass_idx != 0:
                positions = rig.cameras.position.to(torch.float64)
                radius = float(torch.linalg.vector_norm(positions[rel_idx] - positions[ref_idx]))
                baseline = (ref_idx, rel_idx, radius)
            theta, points, cost = ba.solve_lm(
                problem, theta0, points, free, robust=opts.robust, baseline_lock=baseline
            )
            rig = ba.unpack_rig(problem, rig, theta)
            norms = ba.residual_norms(problem, theta, points)
        median = float(np.median(norms))
        if timings is not None:
            timings.setdefault("pass_medians", []).append(median)
        log.info(
            "pass %d: %d traces, %d observations, median reprojection error %.4f px",
            pass_idx,
            n_traces,
            len(obs_cam),
            median,
        )

    if opts.debug_dir:
        # per-camera reprojection renders after the final pass
        # (showReprojections, GeometricCalibration.cpp:849-872)
        from . import overlays

        cams = _f64(rig)
        c = cams.index(torch.as_tensor(obs_cam, dtype=torch.int64, device=dev))
        pix, valid = cam.sees(c, points[torch.as_tensor(obs_trace, dtype=torch.int64, device=dev)])
        reproj = torch.where(valid[:, None], pix, float("nan")).cpu().numpy()
        image_ids = {}
        for image in features:
            ci = camera_id_from_image_path(image, rig)
            if ci is not None:
                image_ids[ci] = image
        overlays.save_reprojection_renders(
            opts.debug_dir, rig, image_ids, np.asarray(obs_cam), np.asarray(obs_pixel),
            reproj, image_root=opts.image_root,
        )

    if median > opts.max_error:
        log.warning("Final pass median error too high: %.4f", median)
    return rig, median


def rig_rmse_report(rig: cam.Rig, ground_truth: cam.Rig) -> dict:
    """Per-quantity RMSE vs a reference rig (getCameraRmseReport / RigCompare)."""
    a = cam.camera_to_numpy(rig.cameras)
    b = cam.camera_to_numpy(ground_truth.cameras)

    def rmse(x, y):
        return float(np.sqrt(np.mean(np.sum((x - y) ** 2, axis=-1))))

    return {
        "position": rmse(a.position, b.position),
        "forward": rmse(-a.rotation[:, 2], -b.rotation[:, 2]),
        "up": rmse(a.rotation[:, 1], b.rotation[:, 1]),
        "principal": rmse(a.principal, b.principal),
        "focal": rmse(a.focal, b.focal),
    }
