"""A forward-facing ring: cameras on a circle in the XY plane, all looking -Z.

Frozen copy of ``facebook360_dep_tpu_torch/render/synthetic.py::make_test_rig``
at commit 73fe11c54864db6ce32ac485256a11aec4484c40. Parameters (a
configuration's ``rig``): num_cameras, resolution [w, h], ring_radius,
focal_scale, type ("RECTILINEAR" by default).
"""

from __future__ import annotations

import numpy as np

from depbench.reference import camera as cam


def make(p: dict):
    """(cameras, ids) of the rig, host float64."""
    w, h = p["resolution"]
    cams, ids = [], []
    for i in range(p["num_cameras"]):
        angle = 2 * np.pi * i / p["num_cameras"]
        r = p["ring_radius"]
        cams.append(cam.make_camera(
            type_code=cam.TYPE_NAMES.index(p.get("type", "RECTILINEAR")),
            position=[r * np.cos(angle), r * np.sin(angle), 0.0],
            rotation=np.eye(3),
            resolution=[w, h],
            focal=[p["focal_scale"] * w, -p["focal_scale"] * w],
        ))
        ids.append(f"cam{i}")
    return cams, ids
