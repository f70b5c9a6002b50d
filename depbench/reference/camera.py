"""The camera model of the plain reference, and the rig JSON it reads and writes.

Frozen copy of ``facebook360_dep_tpu_torch/core/camera.py`` at commit
73fe11c54864db6ce32ac485256a11aec4484c40 (the reference's scalar camera,
``util/Camera.h:32-419``): the four projections, polynomial radial
distortion with its 10-step Newton undistort, the FOV cone and image-circle
tests, and rig JSON (de)serialization, with the arithmetic kept op for op so
that the reference and the program read one rig file alike. Trimmed to what
the benchmark uses; nothing here imports the program.

A :class:`Camera` holds one camera or a batch: every field carries the same
leading batch shape (``type_code.shape``); point arrays have that batch
shape first, then point axes, then the coordinate axis.
"""

from __future__ import annotations

import json
import math
from typing import Any, NamedTuple

import numpy as np
import torch

FTHETA = 0
RECTILINEAR = 1
EQUISOLID = 2
ORTHOGRAPHIC = 3
TYPE_NAMES = ["FTHETA", "RECTILINEAR", "EQUISOLID", "ORTHOGRAPHIC"]

_UNDISTORT_ITERS = 10  # util/Camera.h:265 kMaxSteps


class Camera(NamedTuple):
    """``rotation`` is world-to-camera, rows = (right, up, backward)."""

    type_code: torch.Tensor
    position: torch.Tensor
    rotation: torch.Tensor
    resolution: torch.Tensor
    principal: torch.Tensor
    focal: torch.Tensor
    distortion: torch.Tensor
    distortion_max: torch.Tensor
    cos_fov: torch.Tensor

    @property
    def forward(self):
        return -self.rotation[..., 2, :]

    @property
    def backward(self):
        return self.rotation[..., 2, :]

    @property
    def batch_ndim(self) -> int:
        return self.type_code.ndim

    def to(self, device=None, dtype=None) -> "Camera":
        return Camera(*(f.to(device=device, dtype=dtype if f.is_floating_point() else None) for f in self))

    def index(self, i) -> "Camera":
        return Camera(*(f[i] for f in self))

    def unsqueeze(self) -> "Camera":
        """The batch (N,) as (1, N): broadcasts against (D, 1, ...) points."""
        return Camera(*(f[None] for f in self))


def _bcast(a, batch_ndim, extra):
    return a.reshape(a.shape[:batch_ndim] + (1,) * extra + a.shape[batch_ndim:])


def _scalar_field(cam, a, like):
    b = cam.batch_ndim
    return _bcast(a, b, like.ndim - b)


def _vec_field(cam, a, pts):
    b = cam.batch_ndim
    return _bcast(a, b, pts.ndim - 1 - b)


def dot3(a, v):
    return a[..., 0] * v[..., 0] + a[..., 1] * v[..., 1] + a[..., 2] * v[..., 2]


def _rotate(rotation, v):
    return torch.stack([dot3(rotation[..., i, :], v) for i in range(3)], dim=-1)


def distort_factor(cam, distortion, r_squared):
    d0 = _scalar_field(cam, distortion[..., 0], r_squared)
    d1 = _scalar_field(cam, distortion[..., 1], r_squared)
    d2 = _scalar_field(cam, distortion[..., 2], r_squared)
    return 1.0 + r_squared * (d0 + r_squared * (d1 + r_squared * d2))


def distort(cam, r):
    r = torch.minimum(r, _scalar_field(cam, cam.distortion_max, r))
    return distort_factor(cam, cam.distortion, r * r) * r


def _distort_derivative(cam, x):
    s = x * x
    d0 = _scalar_field(cam, cam.distortion[..., 0], x)
    d1 = _scalar_field(cam, cam.distortion[..., 1], x)
    d2 = _scalar_field(cam, cam.distortion[..., 2], x)
    return 1.0 + s * (3.0 * d0 + s * (5.0 * d1 + s * 7.0 * d2))


def undistort(cam, y):
    dmax_b = torch.broadcast_to(_scalar_field(cam, cam.distortion_max, y), y.shape)
    finite_max = torch.isfinite(dmax_b)
    at_max = torch.where(finite_max, dmax_b, torch.ones_like(dmax_b))
    y_max = torch.where(finite_max, distort_factor(cam, cam.distortion, at_max * at_max) * at_max, math.inf)
    x = y
    for _ in range(_UNDISTORT_ITERS):
        fx = distort_factor(cam, cam.distortion, x * x) * x
        dfx = _distort_derivative(cam, x)
        x = x + (y - fx) / torch.where(dfx == 0, torch.ones_like(dfx), dfx)
    return torch.where(y >= y_max, dmax_b, x)


def _np_dtype(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def camera_to_sensor(cam, v):
    """Camera-space direction (..., 3) -> distorted sensor coords (..., 2);
    all four projections computed and selected by type, as in the program."""
    xy = v[..., :2]
    z = v[..., 2]
    xy_sq = xy[..., 0] * xy[..., 0] + xy[..., 1] * xy[..., 1]
    xy_norm = torch.sqrt(xy_sq)
    full_norm = torch.sqrt(xy_sq + z * z)
    tiny = torch.finfo(v.dtype).tiny
    xy_safe = torch.clamp(xy_norm, min=tiny)
    full_safe = torch.clamp(full_norm, min=tiny)
    r_ftheta = torch.atan2(xy_norm, -z)
    tan_half_pi = math.tan(float(np.asarray(np.pi / 2, dtype=_np_dtype(v.dtype))))
    front = -z > 0
    r_rect = torch.where(front, xy_norm / torch.where(front, -z, torch.ones_like(z)), tan_half_pi)
    r_equi = 2.0 * torch.sqrt(torch.clamp((1.0 + z / full_safe) / 2.0, min=0.0))
    tc = _scalar_field(cam, cam.type_code, z)
    r = torch.where(tc == FTHETA, r_ftheta, torch.where(tc == RECTILINEAR, r_rect, r_equi))
    sensor_std = (distort(cam, r) / xy_safe)[..., None] * xy
    pre = torch.where((z < 0)[..., None], xy / full_safe[..., None], xy / xy_safe[..., None])
    pre_sq = pre[..., 0] * pre[..., 0] + pre[..., 1] * pre[..., 1]
    sensor_ortho = distort_factor(cam, cam.distortion, pre_sq)[..., None] * pre
    return torch.where((tc == ORTHOGRAPHIC)[..., None], sensor_ortho, sensor_std)


def sensor_to_camera(cam, sensor):
    sq = sensor[..., 0] * sensor[..., 0] + sensor[..., 1] * sensor[..., 1]
    norm = torch.sqrt(sq)
    norm_safe = torch.clamp(norm, min=torch.finfo(sensor.dtype).tiny)
    r = undistort(cam, norm)
    theta_rect = torch.atan(r)
    theta_equi = torch.where(r <= 2.0, 2.0 * torch.asin(torch.clamp(r / 2.0, -1.0, 1.0)), math.pi)
    theta_ortho = torch.where(r <= 1.0, torch.asin(torch.clamp(r, -1.0, 1.0)), math.pi / 2.0)
    tc = _scalar_field(cam, cam.type_code, sq)
    theta = torch.where(tc == FTHETA, r, torch.where(tc == RECTILINEAR, theta_rect,
                                                     torch.where(tc == EQUISOLID, theta_equi, theta_ortho)))
    unit_xy = (torch.sin(theta) / norm_safe)[..., None] * sensor
    unit_z = -torch.cos(theta)
    unit = torch.cat([unit_xy, unit_z[..., None]], dim=-1)
    straight = torch.zeros_like(unit)
    straight[..., 2] = -1.0
    return torch.where((sq == 0)[..., None], straight, unit)


def pixel(cam, rig_pts):
    v = _rotate(_vec_field(cam, cam.rotation, rig_pts), rig_pts - _vec_field(cam, cam.position, rig_pts))
    sensor = camera_to_sensor(cam, v)
    return _vec_field(cam, cam.focal, sensor) * sensor + _vec_field(cam, cam.principal, sensor)


def ray_dir(cam, pix):
    sensor = (pix - _vec_field(cam, cam.principal, pix)) / _vec_field(cam, cam.focal, pix)
    unit = sensor_to_camera(cam, sensor)
    rot_t = cam.rotation.transpose(-1, -2)
    return _rotate(_vec_field(cam, rot_t, unit), unit)


def is_outside_fov(cam, rig_pts):
    v = rig_pts - _vec_field(cam, cam.position, rig_pts)
    dot = dot3(_vec_field(cam, cam.forward, rig_pts), v)
    cf = _scalar_field(cam, cam.cos_fov, dot)
    outside = dot * torch.abs(dot) <= cf * torch.abs(cf) * dot3(v, v)
    return outside & (cf != -1.0)


def is_outside_sensor(cam, pix):
    res = _vec_field(cam, cam.resolution, pix)
    return (pix[..., 0] < 0) | (pix[..., 0] >= res[..., 0]) | (pix[..., 1] < 0) | (pix[..., 1] >= res[..., 1])


def sees(cam, rig_pts):
    pix = pixel(cam, rig_pts)
    return pix, ~is_outside_fov(cam, rig_pts) & ~is_outside_sensor(cam, pix)


def default_cos_fov(type_code: int) -> float:
    return 0.0 if type_code in (RECTILINEAR, ORTHOGRAPHIC) else -1.0


def is_default_fov(cam):
    hemisphere = (cam.type_code == RECTILINEAR) | (cam.type_code == ORTHOGRAPHIC)
    return cam.cos_fov == torch.where(hemisphere, 0.0, -1.0).to(cam.cos_fov.dtype)


def is_outside_image_circle(cam, pix):
    cf = cam.cos_fov
    sin_fov = torch.sqrt(torch.clamp(1.0 - cf * cf, min=0.0))
    edge = camera_to_sensor(cam, torch.stack([torch.zeros_like(sin_fov), sin_fov, -cf], dim=-1))
    edge_sq = edge[..., 0] * edge[..., 0] + edge[..., 1] * edge[..., 1]
    sensor = (pix - _vec_field(cam, cam.principal, pix)) / _vec_field(cam, cam.focal, pix)
    sensor_sq = sensor[..., 0] * sensor[..., 0] + sensor[..., 1] * sensor[..., 1]
    outside = sensor_sq >= _scalar_field(cam, edge_sq, sensor_sq)
    return outside & ~_scalar_field(cam, is_default_fov(cam), sensor_sq)


def normalize(cam):
    """Resolution-independent form (resolution == [1, 1]), util/Camera.cpp:225-229."""
    return cam._replace(principal=cam.principal / cam.resolution, focal=cam.focal / cam.resolution,
                        resolution=torch.ones_like(cam.resolution))


# ---- host-side construction and rig JSON (util/Camera.cpp:30-313) ---------


def _solve_distortion_max(distortion) -> float:
    d = np.asarray(distortion, dtype=np.float64)
    if not d.any():
        return np.inf
    count = len(d)
    while count > 0 and d[count - 1] == 0:
        count -= 1
    coeffs = [1.0] + [d[i] * (2 * i + 3) for i in range(count)]
    best = np.inf
    for root in np.roots(coeffs[::-1]):
        if abs(root.imag) < 1e-12 and root.real > 0:
            best = min(best, root.real)
    return float(np.sqrt(best)) if np.isfinite(best) else np.inf


def _orthonormalize(rotation):
    u, _, vt = np.linalg.svd(rotation)
    r = u @ vt
    if np.linalg.det(r) < 0:
        u[:, -1] *= -1
        r = u @ vt
    return r


def make_camera(type_code, position, rotation, resolution, focal, principal=None,
                distortion=(0.0, 0.0, 0.0), cos_fov=None) -> Camera:
    """Host constructor (float64, CPU): rotation orthonormalized, distortionMax solved."""
    f64 = np.float64
    resolution = np.asarray(resolution, f64)
    distortion = np.asarray(distortion, f64)
    if distortion.shape[0] < 3:
        distortion = np.pad(distortion, (0, 3 - distortion.shape[0]))
    fields = dict(
        type_code=np.int32(type_code),
        position=np.asarray(position, f64),
        rotation=_orthonormalize(np.asarray(rotation, f64)),
        resolution=resolution,
        principal=resolution / 2 if principal is None else np.asarray(principal, f64),
        focal=np.asarray(focal, f64),
        distortion=distortion,
        distortion_max=np.float64(_solve_distortion_max(distortion)),
        cos_fov=np.float64(default_cos_fov(type_code) if cos_fov is None else cos_fov),
    )
    out = {}
    for name in Camera._fields:
        a = torch.as_tensor(np.array(fields[name]))
        out[name] = a.to(torch.int32) if name == "type_code" else a
    return Camera(**out)


def camera_from_json(obj: dict) -> tuple[Camera, str]:
    if float(obj["version"]) < 1.0:
        raise ValueError("unsupported rig version")
    forward, up, right = (np.asarray(obj[k], np.float64) for k in ("forward", "up", "right"))
    if not np.cross(right, up).dot(forward) < 0:
        raise ValueError("rotation must be right-handed")
    cam = make_camera(
        type_code=TYPE_NAMES.index(obj["type"]),
        position=obj["origin"],
        rotation=np.stack([right, up, -forward]),
        resolution=obj["resolution"],
        focal=obj["focal"],
        principal=obj.get("principal"),
        distortion=obj.get("distortion", (0.0, 0.0, 0.0)),
        cos_fov=np.cos(float(obj["fov"])) if "fov" in obj else None,
    )
    return cam, obj["id"]


def camera_to_json(cam: Camera, cam_id: str) -> dict:
    c = Camera(*(f.detach().cpu().to(torch.float64 if f.is_floating_point() else torch.int64).numpy() for f in cam))
    out: dict[str, Any] = {
        "version": 1,
        "type": TYPE_NAMES[int(c.type_code)],
        "origin": c.position.tolist(),
        "forward": (-c.rotation[2]).tolist(),
        "up": c.rotation[1].tolist(),
        "right": c.rotation[0].tolist(),
        "resolution": c.resolution.tolist(),
        "focal": c.focal.tolist(),
        "id": cam_id,
    }
    if not np.array_equal(c.principal, c.resolution / 2):
        out["principal"] = c.principal.tolist()
    if c.distortion.any():
        out["distortion"] = c.distortion.tolist()
    if float(c.cos_fov) != default_cos_fov(int(c.type_code)):
        out["fov"] = float(np.arccos(c.cos_fov))
    return out


def stack_cameras(cams) -> Camera:
    return Camera(*(torch.stack(fs) for fs in zip(*cams)))


def rig_json_text(cams, ids) -> str:
    """The rig file the program reads (rigs/rig_calibrated.json), as its save_rig writes it."""
    return json.dumps({"cameras": [camera_to_json(c, i) for c, i in zip(cams, ids)]}, indent=2, sort_keys=True)


def load_rig_text(text: str) -> tuple[Camera, tuple[str, ...]]:
    """(stacked cameras, ids) of a rig file's text."""
    parsed = [camera_from_json(c) for c in json.loads(text)["cameras"]]
    return stack_cameras([p[0] for p in parsed]), tuple(p[1] for p in parsed)
