"""Calibration debug imagery: match overlays + reprojection renders. The port
of ``facebook360_dep_tpu/calib/overlays.py``: host numpy and OpenCV, as
there.

Reference: ``calibration/GeometricCalibration.cpp:821-872`` — ``showMatches``
writes per-pair overlap images with matched feature lines per pass, and
``showReprojections`` writes per-camera renders of observed features vs their
traces' reprojections (error vectors). Written when ``--debug_dir`` is set;
same trigger here. OpenCV is imported only here; where it is missing, the
debug branch raises and names it.
"""

from __future__ import annotations

import logging
import os

import numpy as np

log = logging.getLogger("calibration")


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("the calibration's --debug_dir imagery needs OpenCV (cv2), "
                           "which is not installed") from e
    return cv2


def _canvas(image_id: str, camera_res, image_root: str = "") -> np.ndarray:
    """The source image if it can be found, else a black canvas at camera
    resolution (artificial-point runs have no imagery)."""
    cv2 = _cv2()
    for root in ([image_root] if image_root else []) + [""]:
        p = os.path.join(root, image_id) if root else image_id
        if os.path.isfile(p):
            img = cv2.imread(p, cv2.IMREAD_COLOR)
            if img is not None:
                return img
    w, h = int(camera_res[0]), int(camera_res[1])
    return np.zeros((h, w, 3), np.uint8)


def render_match_overlay(img0, img1, pts0, pts1, pairs) -> np.ndarray:
    """Side-by-side pair with a line per match (renderOverlap equivalent)."""
    cv2 = _cv2()
    h = max(img0.shape[0], img1.shape[0])
    w0, w1 = img0.shape[1], img1.shape[1]
    out = np.zeros((h, w0 + w1, 3), np.uint8)
    out[: img0.shape[0], :w0] = img0
    out[: img1.shape[0], w0:] = img1
    rng = np.random.RandomState(0)
    for i0, i1 in pairs:
        p0 = tuple(np.round(pts0[i0]).astype(int))
        p1 = tuple(np.round(pts1[i1]).astype(int) + np.array([w0, 0]))
        color = tuple(int(c) for c in rng.randint(64, 255, 3))
        cv2.circle(out, p0, 3, color, 1, cv2.LINE_AA)
        cv2.circle(out, p1, 3, color, 1, cv2.LINE_AA)
        cv2.line(out, p0, p1, color, 1, cv2.LINE_AA)
    return out


def render_reprojections(img, obs_px, reproj_px, error_scale: float = 1.0) -> np.ndarray:
    """Observed features (green circles) vs reprojected trace points (red),
    connected by the error vector, error-magnified by ``error_scale``
    (renderReprojections equivalent)."""
    cv2 = _cv2()
    out = img.copy()
    for o, r in zip(np.asarray(obs_px), np.asarray(reproj_px)):
        if not (np.isfinite(o).all() and np.isfinite(r).all()):
            continue
        tip = o + (r - o) * error_scale
        po = tuple(np.round(o).astype(int))
        pt = tuple(np.round(tip).astype(int))
        err = float(np.linalg.norm(r - o))
        # green (small error) -> red (>= 2 px)
        t = min(err / 2.0, 1.0)
        color = (0, int(255 * (1 - t)), int(255 * t))
        cv2.circle(out, po, 3, (0, 255, 0), 1, cv2.LINE_AA)
        cv2.line(out, po, pt, color, 1, cv2.LINE_AA)
        cv2.circle(out, pt, 1, (0, 0, 255), -1, cv2.LINE_AA)
    return out


def _resolutions(rig) -> np.ndarray:
    return rig.cameras.resolution.detach().cpu().numpy()


def save_match_overlays(debug_dir, pass_idx, rig, features, overlaps,
                        image_root: str = "", min_matches: int = 1) -> list[str]:
    """One PNG per camera pair with matches (showMatches file naming:
    ``pass<N>_<cam0>-<cam1>.png``)."""
    cv2 = _cv2()
    from .calibration import camera_id_from_image_path

    os.makedirs(debug_dir, exist_ok=True)
    res = _resolutions(rig)
    written = []
    for i0, i1, pairs in overlaps:
        if len(pairs) < min_matches:
            continue
        c0 = camera_id_from_image_path(i0, rig)
        c1 = camera_id_from_image_path(i1, rig)
        if c0 is None or c1 is None:
            continue
        img0 = _canvas(i0, res[c0], image_root)
        img1 = _canvas(i1, res[c1], image_root)
        out = render_match_overlay(img0, img1, features[i0], features[i1], pairs)
        fn = os.path.join(debug_dir, f"pass{pass_idx}_{rig.ids[c0]}-{rig.ids[c1]}.png")
        cv2.imwrite(fn, out)
        written.append(fn)
    log.info("wrote %d match overlays to %s", len(written), debug_dir)
    return written


def save_reprojection_renders(debug_dir, rig, image_ids, obs_cam, obs_pixel,
                              reproj_pixel, image_root: str = "",
                              error_scale: float = 1.0) -> list[str]:
    """One PNG per camera: features vs reprojections (showReprojections file
    naming: ``<cam_id>.png``)."""
    cv2 = _cv2()
    os.makedirs(debug_dir, exist_ok=True)
    res = _resolutions(rig)
    written = []
    for ci, cam_id in enumerate(rig.ids):
        sel = obs_cam == ci
        if not sel.any():
            continue
        img = _canvas(image_ids.get(ci, cam_id) if isinstance(image_ids, dict) else cam_id,
                      res[ci], image_root)
        out = render_reprojections(img, obs_pixel[sel], reproj_pixel[sel], error_scale)
        fn = os.path.join(debug_dir, f"{cam_id}.png")
        cv2.imwrite(fn, out)
        written.append(fn)
    log.info("wrote %d reprojection renders to %s", len(written), debug_dir)
    return written
