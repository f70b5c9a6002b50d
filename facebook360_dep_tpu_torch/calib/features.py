"""Corner detection and epipolar ZNCC matching for rig calibration. The port
of ``facebook360_dep_tpu/calib/features.py``.

Reference: ``calibration/FeatureDetector.cpp:55-183`` (cv::goodFeaturesToTrack
per octave inside the FOV circle), ``calibration/FeatureMatcher.cpp`` (walk
depth samples along the epipolar curve, reproject the corner patch, ZNCC >=
0.75, mutual best match), ``calibration/MatchCorners.cpp`` (orchestration +
matches.json).

The Shi-Tomasi response, the patches, the epipolar depth sweep and the ZNCC
of all corner pairs (one float32 matmul) run in float32 on the device of the
cameras and images. The non-max suppression, the ranking and the subpixel
refine stay on the host with the JAX package's numpy and scipy calls, so
that the corner lists keep its order.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from ..core import camera as cam
from ..ops import sampling

log = logging.getLogger("features")

MATCH_SCORE_THRESHOLD = 0.75  # FeatureMatcher flag default
PATCH_RADIUS = 5  # ZNCC patch 11x11 (Keypoint.h)
EPIPOLAR_RADIUS_PX = 4.0
NUM_DEPTH_SAMPLES = 32


class Corners(NamedTuple):
    xy: np.ndarray  # (N, 2) pixel centers, full-resolution units
    score: np.ndarray  # (N,)


def _central_difference(gray: torch.Tensor, dim: int) -> torch.Tensor:
    """(next - previous) / 2 along ``dim`` with reflect-101 borders, OpenCV's
    default and so the reference's: zero on the first and last row or
    column."""
    out = torch.zeros_like(gray)
    n = gray.shape[dim]
    out.narrow(dim, 1, n - 2).copy_((gray.narrow(dim, 2, n - 2) - gray.narrow(dim, 0, n - 2)) * 0.5)
    return out


def shi_tomasi_response(gray: torch.Tensor, window_radius: int = 1) -> torch.Tensor:
    """Min-eigenvalue corner response (what goodFeaturesToTrack maximizes).

    The JAX package takes the central differences with ``jnp.roll``, which
    wraps around: on the border they compare opposite edges of the image,
    and the image corners become its strongest "corners". With the
    threshold at ``quality_level`` times the maximum, that drops every
    interior corner of a smooth 2K image (8 corners a camera on the 2K
    sphere scene). The port takes them with reflect-101 borders, as the
    reference does, and equals the JAX response two pixels and more from
    the border.
    """
    gx = _central_difference(gray, 1)
    gy = _central_difference(gray, 0)
    ixx = sampling.box_mean(gx * gx, window_radius)
    iyy = sampling.box_mean(gy * gy, window_radius)
    ixy = sampling.box_mean(gx * gy, window_radius)
    tr = ixx + iyy
    det = ixx * iyy - ixy * ixy
    disc = torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    return tr / 2.0 - disc  # min eigenvalue


def detect_corners(
    gray,
    max_corners: int = 2000,
    quality_level: float = 0.01,
    min_distance: int = 5,
    octaves: int = 1,
) -> Corners:
    """Top-N corners with NMS, optionally over a scale pyramid
    (FeatureDetector.cpp:55-183). ``gray`` (H, W): a tensor, whose device
    computes the response, or a numpy array (the CPU)."""
    from scipy.ndimage import maximum_filter

    all_xy, all_score = [], []
    img = torch.as_tensor(gray).to(torch.float32)
    scale = 1.0
    for _ in range(max(octaves, 1)):
        resp = shi_tomasi_response(img).cpu().numpy()
        # NMS: keep local maxima over a (2r+1)^2 window
        r = max(min_distance, 1)
        local_max = resp == maximum_filter(resp, size=2 * r + 1, mode="nearest")
        thresh = quality_level * np.nanmax(np.where(np.isfinite(resp), resp, 0))
        ys, xs = np.nonzero(local_max & (resp > thresh))
        scores = resp[ys, xs]
        order = np.argsort(-scores)[:max_corners]
        ys, xs = ys[order], xs[order]
        # subpixel refine: 1D quadratic fit through the response peak per axis
        # (the reference runs cv::cornerSubPix, FeatureDetector.cpp:55-183)
        rf = np.where(np.isfinite(resp), resp, 0.0)
        hgt, wid = rf.shape
        interior = (ys > 0) & (ys < hgt - 1) & (xs > 0) & (xs < wid - 1)
        yc, xc = np.clip(ys, 1, hgt - 2), np.clip(xs, 1, wid - 2)
        dx = 0.5 * (rf[yc, xc + 1] - rf[yc, xc - 1])
        dy = 0.5 * (rf[yc + 1, xc] - rf[yc - 1, xc])
        dxx = rf[yc, xc + 1] - 2 * rf[yc, xc] + rf[yc, xc - 1]
        dyy = rf[yc + 1, xc] - 2 * rf[yc, xc] + rf[yc - 1, xc]
        off_x = np.where(interior & (dxx < 0), -dx / np.where(dxx < 0, dxx, -1.0), 0.0)
        off_y = np.where(interior & (dyy < 0), -dy / np.where(dyy < 0, dyy, -1.0), 0.0)
        off_x, off_y = np.clip(off_x, -0.5, 0.5), np.clip(off_y, -0.5, 0.5)
        all_xy.append(np.stack([(xs + 0.5 + off_x) * scale, (ys + 0.5 + off_y) * scale], -1))
        all_score.append(scores[order])
        if img.shape[0] < 64 or img.shape[1] < 64:
            break
        img = img[::2, ::2]
        scale *= 2.0
    xy = np.concatenate(all_xy)
    score = np.concatenate(all_score)
    order = np.argsort(-score)[:max_corners]
    return Corners(xy[order], score[order])


def extract_patches(gray: torch.Tensor, xy: torch.Tensor, radius: int = PATCH_RADIUS) -> torch.Tensor:
    """(N, (2r+1)^2) zero-mean unit-norm patches (Keypoint ZNCC form)."""
    ar = torch.arange(-radius, radius + 1, dtype=torch.float32, device=gray.device)
    offs = torch.stack(torch.meshgrid(ar, ar, indexing="xy"), dim=-1).reshape(-1, 2)
    coords = xy[:, None, :] + offs[None, :, :]  # (N, P^2, 2)
    patches = sampling.bilinear_sample(gray, coords)  # (N, P^2)
    patches = patches - patches.mean(dim=1, keepdim=True)
    norm = torch.linalg.vector_norm(patches, dim=1, keepdim=True)
    return patches / torch.clamp(norm, min=1e-12)


def epipolar_proximity(
    cam_a: cam.Camera,
    cam_b: cam.Camera,
    xy_a: torch.Tensor,  # (Na, 2) full-res pixels
    xy_b: torch.Tensor,  # (Nb, 2)
    min_depth: float = 0.5,
    max_depth: float = 1e4,
    num_samples: int = NUM_DEPTH_SAMPLES,
    radius_px: float = EPIPOLAR_RADIUS_PX,
) -> torch.Tensor:
    """(Na, Nb) bool: does corner b lie near the projection of corner a's ray
    at any sampled depth (the reference's getNextDepthSample walk, batched).

    The minimum over the depth samples runs one depth at a time, so the
    largest temporary is one (Na, Nb) float map, not the (Na, Nb, D, 2)
    differences.
    """
    fractions = torch.arange(num_samples, dtype=torch.float32, device=xy_a.device) / (num_samples - 1)
    disparities = fractions * (1.0 / max_depth) + (1 - fractions) * (1.0 / min_depth)
    depths = 1.0 / disparities  # (D,)
    world = cam.rig_point(cam_a, xy_a[:, None, :], depths[None, :])  # (Na, D, 3)
    proj, valid = cam.sees(cam_b, world)  # (Na, D, 2)
    bx, by = xy_b[None, :, 0], xy_b[None, :, 1]
    best = None
    for d in range(num_samples):
        dx = proj[:, d, 0:1] - bx
        dy = proj[:, d, 1:2] - by
        d2 = torch.where(valid[:, d, None], dx * dx + dy * dy, torch.inf)  # (Na, Nb)
        best = d2 if best is None else torch.minimum(best, d2)
    return best <= radius_px * radius_px


def camera_overlap(cam_a: cam.Camera, cam_b: cam.Camera, probe_count: int = 10) -> float:
    """Fraction of cam_a's frame seen by cam_b at infinity (Camera::overlap,
    util/Camera.h:198-211). The probe grid is float64 and the mean float32,
    the dtypes they have in the JAX package under its x64 mode; the mean is
    the count times the float32 reciprocal of the probe count, as XLA forms
    it."""
    probes = torch.linspace(0, 1, probe_count, dtype=torch.float64, device=cam_a.position.device)
    res = cam_a.resolution.to(torch.float64)
    ys, xs = probes * res[1], probes * res[0]
    pix = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1).reshape(-1, 2)
    inside = ~cam.is_outside_image_circle(cam_a, pix)
    world = cam.rig_near_infinity(cam_a, pix)
    _, seen = cam.sees(cam_b, world)
    return float(np.float32(int((inside & seen).sum())) * np.float32(1.0 / pix.shape[0]))


def match_pair(
    cam_a, cam_b, gray_a, gray_b, corners_a: Corners, corners_b: Corners,
    min_depth=0.5, max_depth=1e4, score_threshold=MATCH_SCORE_THRESHOLD,
):
    """Mutual-best ZNCC matches gated by the epipolar depth sweep, on the
    device of the images. Returns (idx_a, idx_b, score) numpy arrays."""
    dev = gray_a.device
    xy_a = torch.as_tensor(corners_a.xy, dtype=torch.float32, device=dev)
    xy_b = torch.as_tensor(corners_b.xy, dtype=torch.float32, device=dev)
    pa = extract_patches(gray_a.to(torch.float32), xy_a)
    pb = extract_patches(gray_b.to(torch.float32), xy_b)
    zncc = pa @ pb.T  # (Na, Nb)
    near = epipolar_proximity(cam_a, cam_b, xy_a, xy_b, min_depth, max_depth)
    score = torch.where(near, zncc, -torch.inf)

    best_b = torch.argmax(score, dim=1)  # (Na,), the first of equal maxima
    best_a = torch.argmax(score, dim=0)  # (Nb,)
    ia = torch.arange(score.shape[0], device=dev)
    mutual = best_a[best_b] == ia
    best_score = torch.take_along_dim(score, best_b[:, None], dim=1)[:, 0]
    keep = (mutual & (best_score >= score_threshold)).cpu().numpy()

    idx_a = np.nonzero(keep)[0]
    idx_b = best_b.cpu().numpy()[idx_a]
    return idx_a, idx_b, best_score.cpu().numpy()[idx_a]


def match_corners(
    rig: cam.Rig,
    grays,  # (N, H, W) float gray images (green channel per ref)
    frame: str = "000000",
    min_depth: float = 0.5,
    max_depth: float = 1e4,
    max_corners: int = 2000,
    min_overlap: float = 0.05,
) -> dict:
    """Detect + match over all overlapping pairs on the device of the rig's
    tensors; returns the matches.json dict (MatchCorners.cpp:258 schema)."""
    n = len(rig.ids)
    dev = rig.cameras.position.device
    grays = torch.as_tensor(np.asarray(grays), dtype=torch.float32).to(dev)
    h, w = grays.shape[1:3]
    # cameras rescaled to image resolution: pixel units flow end to end
    cams = cam.rescale(rig.cameras.to(dtype=torch.float64), [w, h]).to(dtype=torch.float32)

    corners = []
    for i in range(n):
        c = detect_corners(grays[i], max_corners=max_corners, octaves=2)
        corners.append(c)
        log.info("%s: %d corners", rig.ids[i], len(c.xy))

    def image_id(i):
        return f"video/color/{rig.ids[i]}/{frame}.png"

    images = {
        image_id(i): [{"x": float(x), "y": float(y)} for x, y in corners[i].xy]
        for i in range(n)
    }
    all_matches = []
    for a in range(n):
        for b in range(a + 1, n):
            if camera_overlap(cams.index(a), cams.index(b)) < min_overlap:
                continue
            idx_a, idx_b, score = match_pair(
                cams.index(a), cams.index(b), grays[a], grays[b], corners[a], corners[b],
                min_depth, max_depth,
            )
            if len(idx_a) == 0:
                continue
            log.info("%s-%s: %d matches", rig.ids[a], rig.ids[b], len(idx_a))
            all_matches.append(
                {
                    "image1": image_id(a),
                    "image2": image_id(b),
                    "matches": [
                        {"idx1": int(i1), "idx2": int(i2), "score": float(s)}
                        for i1, i2, s in zip(idx_a, idx_b, score)
                    ],
                }
            )
    return {"images": images, "all_matches": all_matches}
