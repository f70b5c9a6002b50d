"""Camera model on tensors: the port of ``facebook360_dep_tpu/core/camera.py``.

The reference's scalar camera (``util/Camera.h:32-419``): four projections
(FTHETA, RECTILINEAR, EQUISOLID, ORTHOGRAPHIC), polynomial radial distortion
``r + d0 r^3 + d1 r^5 (+ d2 r^7)`` with a 10-step Newton undistort, FOV cone
tests, and rig JSON (de)serialization.

A :class:`Camera` holds one camera or a batch of them: every field carries
the same leading batch shape (``type_code.shape``). Point and pixel arrays
have that batch shape first, then any number of point axes, then the
coordinate axis; a batch axis of size 1 broadcasts. So ``sees(src_cams,
world[None])`` projects an ``(H, W, 3)`` image of world points into ``N``
sources at once, where the JAX package uses ``vmap``.
"""

from __future__ import annotations

import json
import math
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

KNEAR_INFINITY = 1e4  # util/Camera.cpp:19

# Type codes match the reference enum order (util/Camera.h:43).
FTHETA = 0
RECTILINEAR = 1
EQUISOLID = 2
ORTHOGRAPHIC = 3

_TYPE_NAMES = ["FTHETA", "RECTILINEAR", "EQUISOLID", "ORTHOGRAPHIC"]

_UNDISTORT_ITERS = 10  # util/Camera.h:265 kMaxSteps


class Camera(NamedTuple):
    """A camera, or a batch of cameras with a common leading shape.

    ``rotation`` is world-to-camera, rows = (right, up, backward), matching
    ``util/Camera.h:76-84``. Camera ids live in :class:`Rig`.
    """

    type_code: torch.Tensor  # (...) int32
    position: torch.Tensor  # (..., 3)
    rotation: torch.Tensor  # (..., 3, 3)
    resolution: torch.Tensor  # (..., 2)
    principal: torch.Tensor  # (..., 2)
    focal: torch.Tensor  # (..., 2)
    distortion: torch.Tensor  # (..., 3)
    distortion_max: torch.Tensor  # (...)
    cos_fov: torch.Tensor  # (...)

    @property
    def forward(self):
        return -self.rotation[..., 2, :]

    @property
    def up(self):
        return self.rotation[..., 1, :]

    @property
    def right(self):
        return self.rotation[..., 0, :]

    @property
    def backward(self):
        return self.rotation[..., 2, :]

    @property
    def batch_ndim(self) -> int:
        return self.type_code.ndim

    def to(self, device=None, dtype=None) -> "Camera":
        """Move every field to ``device``; cast the float fields to ``dtype``."""
        return Camera(*(
            f.to(device=device, dtype=dtype if f.is_floating_point() else None)
            for f in self
        ))

    def index(self, i) -> "Camera":
        """Select along the leading batch axis."""
        return Camera(*(f[i] for f in self))


def _bcast(a: torch.Tensor, batch_ndim: int, extra: int) -> torch.Tensor:
    """Insert ``extra`` point axes after the batch axes of a camera field."""
    return a.reshape(a.shape[:batch_ndim] + (1,) * extra + a.shape[batch_ndim:])


def _scalar_field(cam: Camera, a: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-camera scalar shaped to broadcast against the map ``like``."""
    b = cam.batch_ndim
    return _bcast(a, b, like.ndim - b)


def _vec_field(cam: Camera, a: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """A per-camera vector/matrix field shaped to broadcast against points
    ``pts`` of shape batch + point axes + (k,)."""
    b = cam.batch_ndim
    return _bcast(a, b, pts.ndim - 1 - b)


def _dot3(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * v[..., 0] + a[..., 1] * v[..., 1] + a[..., 2] * v[..., 2]


def _rotate(rotation: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``einsum('...ij,...j->...i', rotation, v)`` with a fixed summation order."""
    return torch.stack([_dot3(rotation[..., i, :], v) for i in range(3)], dim=-1)


def distort_factor(cam: Camera, distortion: torch.Tensor, r_squared: torch.Tensor) -> torch.Tensor:
    """Horner evaluation of 1 + s*(d0 + s*(d1 + s*d2)). util/Camera.h:238-245."""
    d0 = _scalar_field(cam, distortion[..., 0], r_squared)
    d1 = _scalar_field(cam, distortion[..., 1], r_squared)
    d2 = _scalar_field(cam, distortion[..., 2], r_squared)
    return 1.0 + r_squared * (d0 + r_squared * (d1 + r_squared * d2))


def distort(cam: Camera, r: torch.Tensor) -> torch.Tensor:
    """distort(r) = r * distortFactor(r^2), clamped at distortionMax. util/Camera.h:250-253."""
    r = torch.minimum(r, _scalar_field(cam, cam.distortion_max, r))
    return distort_factor(cam, cam.distortion, r * r) * r


def _distort_derivative(cam: Camera, x: torch.Tensor) -> torch.Tensor:
    s = x * x
    d0 = _scalar_field(cam, cam.distortion[..., 0], x)
    d1 = _scalar_field(cam, cam.distortion[..., 1], x)
    d2 = _scalar_field(cam, cam.distortion[..., 2], x)
    return 1.0 + s * (3.0 * d0 + s * (5.0 * d1 + s * 7.0 * d2))


def undistort(cam: Camera, y: torch.Tensor) -> torch.Tensor:
    """Invert distort() by 10 fixed Newton steps from x0 = y. util/Camera.h:255-284."""
    dmax_b = torch.broadcast_to(_scalar_field(cam, cam.distortion_max, y), y.shape)
    # distortionMax is inf for the default (zero) distortion: unclamped
    finite_max = torch.isfinite(dmax_b)
    at_max = torch.where(finite_max, dmax_b, torch.ones_like(dmax_b))
    y_max = torch.where(
        finite_max, distort_factor(cam, cam.distortion, at_max * at_max) * at_max, math.inf
    )
    x = y
    for _ in range(_UNDISTORT_ITERS):
        fx = distort_factor(cam, cam.distortion, x * x) * x
        dfx = _distort_derivative(cam, x)
        x = x + (y - fx) / torch.where(dfx == 0, torch.ones_like(dfx), dfx)
    # y past the distortion maximum clamps to distortionMax (util/Camera.h:260-262)
    return torch.where(y >= y_max, dmax_b, x)


def camera_to_sensor(cam: Camera, v: torch.Tensor) -> torch.Tensor:
    """Camera-space direction (..., 3) -> distorted sensor coords (..., 2).

    util/Camera.h:301-341. All four projections are computed and selected by
    type, so a batch may mix types.
    """
    xy = v[..., :2]
    z = v[..., 2]
    xy_sq = xy[..., 0] * xy[..., 0] + xy[..., 1] * xy[..., 1]
    xy_norm = torch.sqrt(xy_sq)
    full_norm = torch.sqrt(xy_sq + z * z)
    tiny = torch.finfo(v.dtype).tiny
    xy_safe = torch.clamp(xy_norm, min=tiny)
    full_safe = torch.clamp(full_norm, min=tiny)

    # FTHETA: r = theta = atan2(|xy|, -z)
    r_ftheta = torch.atan2(xy_norm, -z)
    # RECTILINEAR: r = |xy| / -z, or tan(pi/2) when behind (util/Camera.h:317-324)
    tan_half_pi = math.tan(float(np.asarray(np.pi / 2, dtype=_np_dtype(v.dtype))))
    front = -z > 0
    r_rect = torch.where(front, xy_norm / torch.where(front, -z, torch.ones_like(z)), tan_half_pi)
    # EQUISOLID: r = 2 sqrt((1 + z/|v|) / 2)
    r_equi = 2.0 * torch.sqrt(torch.clamp((1.0 + z / full_safe) / 2.0, min=0.0))

    tc = _scalar_field(cam, cam.type_code, z)
    r = torch.where(tc == FTHETA, r_ftheta, torch.where(tc == RECTILINEAR, r_rect, r_equi))
    sensor_std = (distort(cam, r) / xy_safe)[..., None] * xy

    # ORTHOGRAPHIC: pre = xy/|v| in front, xy/|xy| behind; no clamp on factor
    pre = torch.where((z < 0)[..., None], xy / full_safe[..., None], xy / xy_safe[..., None])
    pre_sq = pre[..., 0] * pre[..., 0] + pre[..., 1] * pre[..., 1]
    sensor_ortho = distort_factor(cam, cam.distortion, pre_sq)[..., None] * pre

    return torch.where((tc == ORTHOGRAPHIC)[..., None], sensor_ortho, sensor_std)


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def sensor_to_camera(cam: Camera, sensor: torch.Tensor) -> torch.Tensor:
    """Distorted sensor coords -> unit camera-space direction. util/Camera.h:344-378."""
    sq = sensor[..., 0] * sensor[..., 0] + sensor[..., 1] * sensor[..., 1]
    norm = torch.sqrt(sq)
    norm_safe = torch.clamp(norm, min=torch.finfo(sensor.dtype).tiny)
    r = undistort(cam, norm)

    theta_ftheta = r
    theta_rect = torch.atan(r)
    theta_equi = torch.where(r <= 2.0, 2.0 * torch.asin(torch.clamp(r / 2.0, -1.0, 1.0)), math.pi)
    theta_ortho = torch.where(r <= 1.0, torch.asin(torch.clamp(r, -1.0, 1.0)), math.pi / 2.0)

    tc = _scalar_field(cam, cam.type_code, sq)
    theta = torch.where(
        tc == FTHETA,
        theta_ftheta,
        torch.where(tc == RECTILINEAR, theta_rect, torch.where(tc == EQUISOLID, theta_equi, theta_ortho)),
    )
    unit_xy = (torch.sin(theta) / norm_safe)[..., None] * sensor
    unit_z = -torch.cos(theta)
    unit = torch.cat([unit_xy, unit_z[..., None]], dim=-1)
    # degenerate center pixel -> straight ahead (util/Camera.h:351-354)
    straight = torch.zeros_like(unit)
    straight[..., 2] = -1.0
    return torch.where((sq == 0)[..., None], straight, unit)


def pixel(cam: Camera, rig_pts: torch.Tensor) -> torch.Tensor:
    """World (rig-space) points (..., 3) -> pixel coords (..., 2). util/Camera.h:121-128."""
    v = _rotate(_vec_field(cam, cam.rotation, rig_pts), rig_pts - _vec_field(cam, cam.position, rig_pts))
    sensor = camera_to_sensor(cam, v)
    return _vec_field(cam, cam.focal, sensor) * sensor + _vec_field(cam, cam.principal, sensor)


def ray_dir(cam: Camera, pix: torch.Tensor) -> torch.Tensor:
    """Pixel coords (..., 2) -> unit ray direction in rig space. util/Camera.h:131-138."""
    sensor = (pix - _vec_field(cam, cam.principal, pix)) / _vec_field(cam, cam.focal, pix)
    unit = sensor_to_camera(cam, sensor)
    rot_t = cam.rotation.transpose(-1, -2)
    return _rotate(_vec_field(cam, rot_t, unit), unit)


def is_outside_fov(cam: Camera, rig_pts: torch.Tensor) -> torch.Tensor:
    """FOV cone test. util/Camera.h:154-164 (general form covers cosFov == 0)."""
    v = rig_pts - _vec_field(cam, cam.position, rig_pts)
    dot = _dot3(_vec_field(cam, cam.forward, rig_pts), v)
    cf = _scalar_field(cam, cam.cos_fov, dot)
    outside = dot * torch.abs(dot) <= cf * torch.abs(cf) * _dot3(v, v)
    return outside & (cf != -1.0)


def is_outside_sensor(cam: Camera, pix: torch.Tensor) -> torch.Tensor:
    res = _vec_field(cam, cam.resolution, pix)
    return (
        (pix[..., 0] < 0)
        | (pix[..., 0] >= res[..., 0])
        | (pix[..., 1] < 0)
        | (pix[..., 1] >= res[..., 1])
    )


def sees(cam: Camera, rig_pts: torch.Tensor):
    """Project and validity-test in one pass. util/Camera.h:184-190.

    Returns (pix, valid); invalid pixels still hold the projected value.
    """
    pix = pixel(cam, rig_pts)
    valid = ~is_outside_fov(cam, rig_pts) & ~is_outside_sensor(cam, pix)
    return pix, valid


def default_cos_fov(type_code: int) -> float:
    """util/Camera.cpp:190-198: hemisphere for RECTILINEAR/ORTHOGRAPHIC, else sphere."""
    return 0.0 if type_code in (RECTILINEAR, ORTHOGRAPHIC) else -1.0


def is_default_fov(cam: Camera) -> torch.Tensor:
    hemisphere = (cam.type_code == RECTILINEAR) | (cam.type_code == ORTHOGRAPHIC)
    default = torch.where(hemisphere, 0.0, -1.0).to(cam.cos_fov.dtype)
    return cam.cos_fov == default


def is_outside_image_circle(cam: Camera, pix: torch.Tensor) -> torch.Tensor:
    """util/Camera.h:166-178: compare sensor radius to the FOV-cone edge radius."""
    cf = cam.cos_fov
    sin_fov = torch.sqrt(torch.clamp(1.0 - cf * cf, min=0.0))
    edge = camera_to_sensor(cam, torch.stack([torch.zeros_like(sin_fov), sin_fov, -cf], dim=-1))
    edge_sq = edge[..., 0] * edge[..., 0] + edge[..., 1] * edge[..., 1]
    sensor = (pix - _vec_field(cam, cam.principal, pix)) / _vec_field(cam, cam.focal, pix)
    sensor_sq = sensor[..., 0] * sensor[..., 0] + sensor[..., 1] * sensor[..., 1]
    outside = sensor_sq >= _scalar_field(cam, edge_sq, sensor_sq)
    return outside & ~_scalar_field(cam, is_default_fov(cam), sensor_sq)


def rescale(cam: Camera, new_resolution) -> Camera:
    """util/Camera.cpp:217-223."""
    new_res = torch.as_tensor(new_resolution, dtype=cam.resolution.dtype, device=cam.resolution.device)
    new_res = torch.broadcast_to(new_res, cam.resolution.shape)
    scale = new_res / cam.resolution
    return cam._replace(principal=cam.principal * scale, focal=cam.focal * scale, resolution=new_res)


def normalize(cam: Camera) -> Camera:
    """Resolution-independent form (resolution == [1,1]). util/Camera.cpp:225-229."""
    return cam._replace(
        principal=cam.principal / cam.resolution,
        focal=cam.focal / cam.resolution,
        resolution=torch.ones_like(cam.resolution),
    )


def camera_from_numpy(fields, device=None, dtype=None) -> Camera:
    """A port camera from numpy-convertible fields: the JAX package's
    ``Camera`` NamedTuple or a mapping of field names."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    out = {}
    for name in Camera._fields:
        a = torch.as_tensor(np.array(fields[name]))
        if name == "type_code":
            a = a.to(torch.int32)
        elif dtype is not None:
            a = a.to(dtype)
        out[name] = a.to(device) if device is not None else a
    return Camera(**out)


# ---------------------------------------------------------------------------
# Host-side construction & JSON rig IO (mirrors util/Camera.cpp:30-75,244-313)
# ---------------------------------------------------------------------------


def _solve_distortion_max(distortion: np.ndarray) -> float:
    """Smallest r>0 where distort'(r) = 0, via the derivative polynomial in
    y=r^2: 1 + 3 d0 y + 5 d1 y^2 + 7 d2 y^3. util/Camera.cpp:119-154."""
    d = np.asarray(distortion, dtype=np.float64)
    if not d.any():
        return np.inf
    count = len(d)
    while count > 0 and d[count - 1] == 0:
        count -= 1
    coeffs = [1.0] + [d[i] * (2 * i + 3) for i in range(count)]
    roots = np.roots(coeffs[::-1])  # np.roots wants highest-degree first
    best = np.inf
    for root in roots:
        if abs(root.imag) < 1e-12 and root.real > 0:
            best = min(best, root.real)
    return float(np.sqrt(best)) if np.isfinite(best) else np.inf


def _orthonormalize(rotation: np.ndarray) -> np.ndarray:
    """Project to the nearest rotation matrix (the reference round-trips
    through AngleAxis for the same effect, util/Camera.cpp:77-87)."""
    u, _, vt = np.linalg.svd(rotation)
    r = u @ vt
    if np.linalg.det(r) < 0:
        u[:, -1] *= -1
        r = u @ vt
    return r


def make_camera(
    type_code: int,
    position,
    rotation,
    resolution,
    focal,
    principal=None,
    distortion=(0.0, 0.0, 0.0),
    cos_fov: float | None = None,
) -> Camera:
    """Host-side constructor (float64, CPU) with rotation orthonormalization
    and the distortionMax root-solve."""
    f64 = np.float64
    position = np.asarray(position, f64)
    rotation = _orthonormalize(np.asarray(rotation, f64))
    resolution = np.asarray(resolution, f64)
    focal = np.asarray(focal, f64)
    principal = resolution / 2 if principal is None else np.asarray(principal, f64)
    distortion = np.asarray(distortion, f64)
    if distortion.shape[0] < 3:
        distortion = np.pad(distortion, (0, 3 - distortion.shape[0]))
    if cos_fov is None:
        cos_fov = default_cos_fov(type_code)
    return camera_from_numpy(dict(
        type_code=np.int32(type_code),
        position=position,
        rotation=rotation,
        resolution=resolution,
        principal=principal,
        focal=focal,
        distortion=distortion,
        distortion_max=np.float64(_solve_distortion_max(distortion)),
        cos_fov=np.float64(cos_fov),
    ))


def camera_from_json(obj: dict) -> tuple[Camera, str, str]:
    """Parse one camera dict (rig JSON schema, util/Camera.cpp:30-75).

    Returns (camera, id, group).
    """
    if float(obj["version"]) < 1.0:
        raise ValueError("unsupported rig version")
    type_code = _TYPE_NAMES.index(obj["type"])
    forward = np.asarray(obj["forward"], np.float64)
    up = np.asarray(obj["up"], np.float64)
    right = np.asarray(obj["right"], np.float64)
    # rows: right, up, -forward (util/Camera.cpp:77-81); must be right-handed
    if not np.cross(right, up).dot(forward) < 0:
        raise ValueError("rotation must be right-handed")
    cos_fov = np.cos(float(obj["fov"])) if "fov" in obj else None
    cam = make_camera(
        type_code=type_code,
        position=obj["origin"],
        rotation=np.stack([right, up, -forward]),
        resolution=obj["resolution"],
        focal=obj["focal"],
        principal=obj.get("principal"),
        distortion=obj.get("distortion", (0.0, 0.0, 0.0)),
        cos_fov=cos_fov,
    )
    return cam, obj["id"], obj.get("group", "")


def camera_to_json(cam: Camera, cam_id: str, group: str = "") -> dict:
    """Serialize one camera. util/Camera.cpp:158-177."""
    c = Camera(*(f.detach().cpu().to(torch.float64 if f.is_floating_point() else torch.int64).numpy() for f in cam))
    out: dict[str, Any] = {
        "version": 1,
        "type": _TYPE_NAMES[int(c.type_code)],
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
    if group:
        out["group"] = group
    return out


class Rig(NamedTuple):
    """A stacked rig: ``cameras`` has a leading axis of size len(ids)."""

    cameras: Camera
    ids: tuple[str, ...]
    groups: tuple[str, ...]

    # NOTE: no __len__ — NamedTuple._replace validates field count with len()
    @property
    def num_cameras(self) -> int:
        return len(self.ids)

    def camera(self, i: int) -> Camera:
        return self.cameras.index(i)

    def find(self, cam_id: str) -> int:
        return self.ids.index(cam_id)

    def subset(self, indices: Sequence[int]) -> "Rig":
        idx = torch.as_tensor(list(indices), dtype=torch.long)
        return Rig(
            cameras=self.cameras.index(idx),
            ids=tuple(self.ids[i] for i in indices),
            groups=tuple(self.groups[i] for i in indices),
        )


def stack_cameras(cams: Sequence[Camera]) -> Camera:
    return Camera(*(torch.stack(fs) for fs in zip(*cams)))


def load_rig_from_json_str(text: str) -> Rig:
    parsed = [camera_from_json(c) for c in json.loads(text)["cameras"]]
    return Rig(
        cameras=stack_cameras([p[0] for p in parsed]),
        ids=tuple(p[1] for p in parsed),
        groups=tuple(p[2] for p in parsed),
    )


def load_rig(path) -> Rig:
    with open(path) as f:
        return load_rig_from_json_str(f.read())


def save_rig(path, rig: Rig, comments: Sequence[str] = ()) -> None:
    cams = [camera_to_json(rig.camera(i), rig.ids[i], rig.groups[i]) for i in range(len(rig.ids))]
    obj: dict[str, Any] = {"cameras": cams}
    if comments:
        obj["comments"] = list(comments)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)


def normalize_rig(rig: Rig) -> Rig:
    return rig._replace(cameras=normalize(rig.cameras))


def filter_destinations(rig: Rig, destinations: str) -> Rig:
    """Comma-separated id subset, preserving request order. util/ImageUtil.cpp:110-125."""
    if not destinations:
        return rig
    wanted = [d for d in destinations.split(",") if d]
    return rig.subset([rig.find(d) for d in wanted if d in rig.ids])


def map_src_to_dst_indexes(rig_src: Rig, rig_dst: Rig) -> np.ndarray:
    """For each dst camera, its index in the src rig. DerpUtil.cpp:75-88."""
    return np.asarray([rig_src.find(d) for d in rig_dst.ids], np.int32)
