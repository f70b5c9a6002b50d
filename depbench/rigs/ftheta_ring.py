"""An outward ring of FTHETA fisheyes and an up-facing top camera: the
production rig's shape (RigSimulator makeHorizontalRingOfFThetaCameras +
addTopCamera).

Frozen copy of ``facebook360_dep_tpu_torch/render/synthetic.py::make_ftheta_ring_rig``
(and ``_looking_camera``, ``_ftheta_focal``) at commit
73fe11c54864db6ce32ac485256a11aec4484c40. Parameters (a configuration's
``rig``): num_cameras (the ring), ring_radius, resolution [w, h],
circle_fov_deg, image_circle_scale (the circle's radius over half the
shorter side), distortion, top_offset.
"""

from __future__ import annotations

import numpy as np

from depbench.reference import camera as cam


def _looking_camera(fwd, position, resolution, focal, distortion, cos_fov):
    fwd = np.asarray(fwd, np.float64)
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(up, fwd)) > 0.99:
        up = np.array([1.0, 0.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    return cam.make_camera(type_code=cam.FTHETA, position=position, rotation=np.stack([right, up, -fwd], axis=0),
                           resolution=list(resolution), focal=focal, distortion=distortion, cos_fov=cos_fov)


def make(p: dict):
    """(cameras, ids) of the rig, host float64."""
    w, h = p["resolution"]
    r_px = p["image_circle_scale"] * min(w, h) / 2
    f = 2.0 * r_px / np.radians(p["circle_fov_deg"])
    cos_fov = float(np.cos(np.radians(p["circle_fov_deg"]) / 2))
    dist = p["distortion"]
    n = p["num_cameras"]
    cams, ids = [], []
    for k in range(n):
        a = -2 * np.pi * k / n
        fwd = np.array([np.cos(a), np.sin(a), 0.0])
        cams.append(_looking_camera(fwd, p["ring_radius"] * fwd, (w, h), [f, -f], dist, cos_fov))
        ids.append(f"cam{k}")
    cams.append(_looking_camera((0.0, 0.0, 1.0), (0.0, 0.0, p["top_offset"]), (w, h), [f, -f], dist, cos_fov))
    ids.append(f"cam{n}")
    return cams, ids
