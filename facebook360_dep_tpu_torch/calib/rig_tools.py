"""Rig geometry tools: similarity alignment, comparison, transformation.
The port of ``facebook360_dep_tpu/calib/rig_tools.py``: host numpy, as
there.

Reference: ``rig/RigAligner.cpp`` (similarity R,t,s fit of one rig onto a
reference, Ceres-based there — closed-form Umeyama here), ``rig/RigCompare.cpp``
(per-camera position/forward/up/principal/focal diffs).
"""

from __future__ import annotations

import logging

import numpy as np

from ..core import camera as cam

log = logging.getLogger("rig")


def transform_rig(rig: cam.Rig, rotation, translation, scale: float) -> cam.Rig:
    """Apply the similarity p' = s * R p + t to every camera pose.

    Camera rotation matrices are world-to-camera with basis-vector rows, so
    the new matrix is rows @ R^T. The result keeps the rig's device and
    float dtype.
    """
    rotation = np.asarray(rotation, np.float64)
    translation = np.asarray(translation, np.float64)
    c = cam.camera_to_numpy(rig.cameras)
    cams = c._replace(
        position=scale * c.position @ rotation.T + translation,
        rotation=c.rotation @ rotation.T,
    )
    ref = rig.cameras.position
    return rig._replace(cameras=cam.camera_from_numpy(cams, device=ref.device, dtype=ref.dtype))


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Closed-form similarity aligning src points onto dst (Umeyama 1991)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    rotation = u @ s @ vt
    var_s = (sc**2).sum() / len(src)
    scale = float(np.trace(np.diag(d) @ s) / var_s) if (with_scale and var_s > 0) else 1.0
    translation = mu_d - scale * rotation @ mu_s
    return rotation, translation, scale


def align_rig(
    rig: cam.Rig,
    reference: cam.Rig,
    lock_rotation: bool = False,
    lock_translation: bool = False,
    lock_scale: bool = False,
) -> cam.Rig:
    """Fit (R, t, s) taking this rig's camera positions onto the reference's
    (matched by camera id), then apply it (RigAligner.cpp:34-45)."""
    ids = [i for i in rig.ids if i in reference.ids]
    if len(ids) < 3:
        raise ValueError("need at least 3 shared cameras to align")
    positions = cam.camera_to_numpy(rig.cameras).position
    ref_positions = cam.camera_to_numpy(reference.cameras).position
    src = np.stack([positions[rig.find(i)] for i in ids])
    dst = np.stack([ref_positions[reference.find(i)] for i in ids])
    rotation, translation, scale = umeyama(src, dst, with_scale=not lock_scale)
    if lock_rotation:
        rotation = np.eye(3)
        translation = dst.mean(0) - scale * src.mean(0)
    if lock_translation:
        translation = np.zeros(3)
    log.info("align: scale %.6f translation %s", scale, translation)
    return transform_rig(rig, rotation, translation, scale)


def compare_rigs(rig: cam.Rig, reference: cam.Rig) -> dict:
    """Per-camera + average diffs (RigCompare.cpp:34-72). Returns the averages
    in the reference's log order."""
    a = cam.camera_to_numpy(rig.cameras)
    b = cam.camera_to_numpy(reference.cameras)
    diffs = {"position": [], "forward": [], "up": [], "principal": [], "focal": []}
    for i, cam_id in enumerate(rig.ids):
        j = reference.find(cam_id)
        diffs["position"].append(np.linalg.norm(a.position[i] - b.position[j]))
        diffs["forward"].append(
            np.arccos(np.clip(np.dot(-a.rotation[i, 2], -b.rotation[j, 2]), -1, 1))
        )
        diffs["up"].append(np.arccos(np.clip(np.dot(a.rotation[i, 1], b.rotation[j, 1]), -1, 1)))
        diffs["principal"].append(np.linalg.norm(a.principal[i] - b.principal[j]))
        diffs["focal"].append(float(a.focal[i, 0] - b.focal[j, 0]))
        log.info(
            "%s: position %.6f forward %.6f up %.6f principal %.6f focal %.6f",
            cam_id,
            diffs["position"][-1],
            diffs["forward"][-1],
            diffs["up"][-1],
            diffs["principal"][-1],
            diffs["focal"][-1],
        )
    avg = {k: float(np.mean(v)) for k, v in diffs.items()}
    log.info(
        "Average: position %.6f forward %.6f up %.6f principal %.6f focal %.6f",
        avg["position"], avg["forward"], avg["up"], avg["principal"], avg["focal"],
    )
    return avg
