"""Depth-image-based rendering: the port of ``facebook360_dep_tpu/render/dibr.py``.

Novel-view cubemaps and equirects from per-camera color + disparity, as the
JAX package renders them in place of the reference's GL rasterization
(``render/CanopyScene.h:19-74``, ``render/RigScene.cpp``):

  1. forward-splat every camera's per-pixel world points into the target
     view's z-buffer (scatter-min over ray distance),
  2. close small z-buffer holes with a 3x3 min fill, twice,
  3. inverse-gather color: unproject each target pixel at the splatted depth,
     sample every camera that sees the point (K4, one launch for all
     cameras, color and disparity together), weight by the reference's
     radial cone alpha gated by per-camera occlusion.

The JAX package runs this as one jitted program scanned over cameras; here
stage 1 runs batched over cameras and stage 2 loops over them for the
projection (bounding memory at 2K) around a single K4 launch. Results stay
on the device of the inputs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import default_device
from ..core import camera as cam
from ..ops import sampling
from ..ops import warp_cuda

# GL cubemap face order: +x, -x, +y, -y, +z, -z
_FACE_AXES = [
    # (major axis, sign, u expression index+sign, v expression index+sign)
    (0, +1, (2, -1), (1, -1)),
    (0, -1, (2, +1), (1, -1)),
    (1, +1, (0, +1), (2, +1)),
    (1, -1, (0, +1), (2, -1)),
    (2, +1, (0, +1), (1, -1)),
    (2, -1, (0, -1), (1, -1)),
]


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, summed in axis order."""
    sq = v[..., 0] * v[..., 0]
    for k in range(1, v.shape[-1]):
        sq = sq + v[..., k] * v[..., k]
    return torch.sqrt(sq)


def dir_to_cube(v: torch.Tensor, face_size: int):
    """Directions (..., 3) -> (face, x, y) cube coordinates (pixel centers).
    The major axis is the first maximum of |v| (torch.argmax, like jnp.argmax)."""
    av = torch.abs(v)
    major = torch.argmax(av, dim=-1)
    sign = torch.take_along_dim(torch.sign(v), major[..., None], dim=-1)[..., 0]
    face = major * 2 + (sign < 0).to(major.dtype)
    m = torch.take_along_dim(av, major[..., None], dim=-1)[..., 0]
    m = torch.clamp(m, min=1e-20)

    u = torch.zeros_like(m)
    w = torch.zeros_like(m)
    for f, (axis, s, (ui, us), (vi, vs)) in enumerate(_FACE_AXES):
        sel = face == f
        u = torch.where(sel, us * v[..., ui] / m, u)
        w = torch.where(sel, vs * v[..., vi] / m, w)
    x = (u + 1.0) * 0.5 * face_size
    y = (w + 1.0) * 0.5 * face_size
    return face, x, y


def cube_dirs(face_size: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """(6, S, S, 3) unit view directions for every cube pixel."""
    grid = sampling.pixel_center_grid(face_size, face_size, device, dtype)
    u = grid[..., 0] / face_size * 2.0 - 1.0
    w = grid[..., 1] / face_size * 2.0 - 1.0
    faces = []
    for axis, s, (ui, us), (vi, vs) in _FACE_AXES:
        v = [None, None, None]
        v[axis] = torch.full_like(u, float(s))
        v[ui] = us * u
        v[vi] = vs * w
        faces.append(torch.stack(v, dim=-1))
    d = torch.stack(faces)
    return d / _norm(d)[..., None]


def equirect_dirs(width: int, height: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """(H, W, 3) directions matching worldToEquirect (util/ImageUtil.cpp:127-140)."""
    grid = sampling.pixel_center_grid(height, width, device, dtype)
    u = grid[..., 0] / width
    v = grid[..., 1] / height
    theta = -u * 2.0 * math.pi
    phi = v * math.pi
    return torch.stack(
        [torch.sin(phi) * torch.cos(theta), torch.sin(phi) * torch.sin(theta), torch.cos(phi)], dim=-1
    )


def world_to_equirect(v: torch.Tensor, width: int, height: int):
    depth = _norm(v)
    d = v / torch.clamp(depth, min=1e-20)[..., None]
    phi = torch.arccos(torch.clamp(d[..., 2], -1.0, 1.0))
    theta = torch.atan2(d[..., 1], d[..., 0])
    theta = torch.where(theta > 0, theta - 2 * math.pi, theta)
    return (-theta / (2 * math.pi)) * width, (phi / math.pi) * height


def _splat_depth(flat_idx, dist, valid, num_pixels):
    """Scatter-min of ``dist`` into a z-buffer of ``num_pixels`` (a min is
    order-free, so this is exact whatever order the scatter runs in)."""
    zbuf = torch.full((num_pixels,), math.inf, dtype=dist.dtype, device=dist.device)
    idx = torch.where(valid, flat_idx, 0)
    d = torch.where(valid, dist, math.inf)
    return zbuf.scatter_reduce_(0, idx.reshape(-1), d.reshape(-1), reduce="amin")


def _fill_holes(zbuf2d: torch.Tensor, iterations: int = 2) -> torch.Tensor:
    """Replace inf holes with the min of their 3x3 neighborhood, iterated.
    The window runs over the whole 2-D image, so on a stacked (6S, S)
    cubemap it crosses face seams along rows, as the JAX package's does."""
    z = zbuf2d
    for _ in range(iterations):
        hole = torch.isinf(z)
        neg = torch.where(hole, -math.inf, -z)
        grown = -F.max_pool2d(neg[None, None], 3, stride=1, padding=1)[0, 0]
        z = torch.where(hole, grown, z)
    return z


# --- Omni-directional-stereo (ODS) IPD warp --------------------------------
#
# The reference renders stereo by warping mono geometry per vertex so each
# viewing ray originates on a pupil circle in the equatorial plane whose
# diameter fades with latitude (RigScene.cpp:86-131; CanopyScene.cpp:77-133
# for the offline tbstereo/lr180 exports, fed halfIpdM = +-0.032 by
# SimpleMeshRenderer.cpp:407-427). ``ipd_m`` below is that uniform:
# positive = left eye, negative = right.

_IPD_FALLOFF_SHARPNESS = 25.0  # kA (RigScene.cpp:89)
_IPD_FALLOFF_ONSET = 0.17  # kB: rolloff begins ~60 deg from the equator


def ods_ipd(lat, ipd_m):
    """Latitude-dependent pupil-circle diameter: ``ipd_m`` on an equatorial
    band, double-exponential rolloff to 0 at both poles (RigScene.cpp:88-95).
    ``lat`` in radians, +pi/2 = +z pole."""
    a, b = _IPD_FALLOFF_SHARPNESS, _IPD_FALLOFF_ONSET
    t = lat / math.pi
    return ipd_m * torch.exp(-torch.exp(a * (b - 0.5 - t)) - torch.exp(a * (b - 0.5 + t)))


def ods_eye_offset(points, ipd_m):
    """Per-point ODS pupil position (viewer-centered coords, z up): the eye
    on the circle of radius ipd(lat)/2 in the z=0 plane whose view ray to the
    point is tangent to the circle. Initial estimate, two Newton iterations
    on the tangency residual (RigScene.cpp:97-131), then the pole-stable
    closed form e = s*(s*p.x - d*p.y, d*p.x + s*p.y)/(s^2+d^2).
    Returns (..., 3) eye positions with z = 0."""
    p = torch.as_tensor(points, dtype=torch.float32)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rxy2 = x * x + y * y

    def half_ipd(d):
        return 0.5 * ods_ipd(torch.atan2(z, d), ipd_m)

    def residual(d):
        e = half_ipd(d)
        return rxy2 - e * e - d * d

    e0 = half_ipd(torch.sqrt(rxy2))
    d = torch.sqrt(torch.clamp(rxy2 - e0 * e0, min=1e-12))
    for _ in range(2):  # the reference's iteration count (RigScene.cpp:113)
        step = 1e-3 * d + 1e-12
        slope = (residual(d + step) - residual(d)) / step
        # residual' ~ -2d for slowly-varying ipd; never divide by ~0
        slope = torch.where(torch.abs(slope) > 1e-12, slope, -2.0 * torch.clamp(d, min=1e-6))
        d = torch.clamp(d - residual(d) / slope, min=0.0)

    s = half_ipd(d)
    denom = torch.clamp(s * s + d * d, min=1e-20)
    ex = s * (s * x - d * y) / denom
    ey = s * (d * x + s * y) / denom
    return torch.stack([ex, ey, torch.zeros_like(ex)], dim=-1)


def ods_warp(points, ipd_m):
    """Mono -> stereo geometry: p' = p - eye(p) (cameraVS, RigScene.cpp:152-155)."""
    return points - ods_eye_offset(points, ipd_m)


def ods_unwarp(warped, ipd_m, iterations: int = 2):
    """Inverse of :func:`ods_warp` by fixed point: p = p' + eye(p)."""
    p = warped
    for _ in range(iterations):
        p = warped + ods_eye_offset(p, ipd_m)
    return p


def exp_alpha(cone):
    """RigScene's exponential accumulation weight ``a' = exp(30 a) - 1``
    (exponentialFS, RigScene.cpp:281-292). cone in [0, 1]."""
    return torch.exp(30.0 * cone) - 1.0


def resolve_fade(displacement_m):
    """Displacement-based resolve fade (RigScene::render :1087-1095)."""
    k_begin, k_end, k_min = 0.5, 0.75, 0.05
    d = torch.as_tensor(displacement_m, dtype=torch.float32)
    f = k_min + (1.0 - k_min) * torch.clamp((d - k_end) / (k_begin - k_end), 0.0, 1.0)
    return f * f


def accumulate_resolve(colors, cones, fade=1.0):
    """updateAccumulation + resolveAccumulation (RigScene.cpp:1009-1035):
    per-subframe weight exp(30*cone)-1, premultiplied additive blend, resolve
    divide by accumulated alpha with ``fade``. colors (N, H, W, 3); cones
    (N, H, W) in [0, 1] (0 = no coverage). Returns (rgb (H, W, 3), alpha (H, W))."""
    colors = torch.as_tensor(colors, dtype=torch.float32)
    cones = torch.as_tensor(cones, dtype=torch.float32)
    w = torch.where(cones > 0.0, exp_alpha(cones), 0.0)
    acc_rgb = torch.sum(w[..., None] * colors, dim=0)
    acc_a = torch.sum(w, dim=0)
    rgb = torch.where(acc_a[..., None] > 0.0,
                      fade * acc_rgb / torch.clamp(acc_a, min=1e-20)[..., None], 0.0)
    return rgb, acc_a


class Target(NamedTuple):
    """The view rendered: a stacked (6S, S) cubemap or an (H, W) equirect."""

    mode: str  # "cube" or "equirect"
    face_size: int = 0
    width: int = 0
    height: int = 0

    @property
    def hw(self) -> tuple[int, int]:
        if self.mode == "cube":
            return 6 * self.face_size, self.face_size
        return self.height, self.width

    def dirs(self, device) -> torch.Tensor:
        """(H, W, 3) view direction of every target pixel."""
        if self.mode == "cube":
            return cube_dirs(self.face_size, device).reshape(self.hw + (3,))
        return equirect_dirs(self.width, self.height, device)

    def project(self, v: torch.Tensor):
        """World-offset vectors -> (flat pixel index, in-bounds). The int
        conversion truncates toward zero, as astype(int32) does."""
        if self.mode == "cube":
            s = self.face_size
            face, x, y = dir_to_cube(v, s)
            xi = torch.clamp(x.to(torch.int32), 0, s - 1)
            yi = torch.clamp(y.to(torch.int32), 0, s - 1)
            return (face * s + yi) * s + xi, torch.isfinite(x) & torch.isfinite(y)
        x, y = world_to_equirect(v, self.width, self.height)
        xi = torch.clamp(x.to(torch.int32), 0, self.width - 1)
        yi = torch.clamp(y.to(torch.int32), 0, self.height - 1)
        return yi * self.width + xi, torch.isfinite(x) & torch.isfinite(y)


def splat_zbuffer(rig_cams: cam.Camera, disparities, center, target: Target, ipd: float = 0.0):
    """Stage 1: every camera's pixels at their disparity, scatter-min'd by
    distance from ``center`` into the target view, holes filled. ``ipd``
    warps the geometry for one ODS eye first. Returns the (H, W) z-buffer."""
    n, h, w = disparities.shape
    dev = disparities.device
    grid = sampling.pixel_center_grid(h, w, dev) / torch.tensor([w, h], dtype=torch.float32, device=dev)
    depth = 1.0 / torch.clamp(disparities, min=1e-12)
    v = cam.rig_point(rig_cams, grid[None], depth) - center
    if ipd:
        v = ods_warp(v, ipd)
    dist = _norm(v)
    valid = torch.isfinite(dist) & (disparities > 0)
    idx, ok = target.project(v)
    zbuf = _splat_depth(idx.long(), dist, valid & ok, target.hw[0] * target.hw[1])
    return _fill_holes(zbuf.reshape(target.hw))


def target_points(zbuf, center, target: Target, ipd: float = 0.0):
    """(H, W, 3) world point of every target pixel at its z-buffer depth;
    for an ODS eye, unwarped back to the mono scene the cameras see."""
    world = center + target.dirs(zbuf.device) * zbuf[..., None]
    if ipd:
        world = center + ods_unwarp(world - center, ipd)
    return world


def gather_coords(rig_cams: cam.Camera, world, size_hw):
    """Per camera: the source pixel coords of every target point (N, H, W, 2)
    for an (h, w) image, and the cone weight exp_alpha(cone) where the camera
    sees the point, else 0 (N, H, W). One camera at a time, so the
    projection's temporaries stay at one camera's size."""
    h, w = size_hw
    n = rig_cams.type_code.shape[0]
    scale = torch.tensor([w, h], dtype=torch.float32, device=world.device)
    coords = torch.empty((n,) + world.shape[:-1] + (2,), dtype=torch.float32, device=world.device)
    cone_w = torch.empty((n,) + world.shape[:-1], dtype=torch.float32, device=world.device)
    for i in range(n):
        pix, sees_ok = cam.sees(rig_cams.index(i), world)
        coords[i] = pix * scale
        # radial cone alpha: 1 at image center -> ~0 at the image edge
        # (cameraFS), then the exponential accumulation weight
        cone = torch.clamp(1.0 - 2.0 * _norm(pix - 0.5), min=1.0 / 255.0)
        cone_w[i] = torch.where(sees_ok, exp_alpha(cone), 0.0)
    return coords, cone_w


def planar_stack(colors, disparities) -> torch.Tensor:
    """(N, H, W, 3) colors + (N, H, W) disparities -> the (N, 4, H, W)
    channel-planar stack that K4 samples."""
    return torch.cat([colors.permute(0, 3, 1, 2), disparities[:, None]], dim=1).contiguous()


def render_view(
    rig_cams: cam.Camera,  # stacked (N,), normalized, float32
    colors: torch.Tensor,  # (N, H, W, 3)
    disparities: torch.Tensor,  # (N, H, W)
    center,  # (3,)
    face_size: int = 0,
    mode: str = "cube",
    width: int = 0,
    height: int = 0,
    ipd: float = 0.0,
):
    """Render (color, disparity, alpha) of the scene seen from ``center``.

    mode="cube": returns (6, S, S, ...) faces; mode="equirect": (H, W, ...).
    Nonzero ``ipd`` renders one ODS stereo eye (positive = left): geometry
    is warped by :func:`ods_warp` before the splat and camera
    correspondence/occlusion run on the unwarped mono points."""
    n, h, w = colors.shape[:3]
    dev = colors.device
    center = torch.as_tensor(center, dtype=torch.float32, device=dev)
    target = Target(mode, face_size, width, height)

    zbuf = splat_zbuffer(rig_cams, disparities, center, target, ipd)

    # --- stage 2: inverse gather colors (K4: colors and disparity at once) ---
    world = target_points(zbuf, center, target, ipd)
    alpha_valid = torch.isfinite(zbuf)
    coords, cone_w = gather_coords(rig_cams, world, (h, w))
    sampled, valid = warp_cuda.warp_sample_planar(planar_stack(colors, disparities), coords)
    del coords

    sum_w = torch.zeros(target.hw, dtype=torch.float32, device=dev)
    sum_wc = torch.zeros(target.hw + (3,), dtype=torch.float32, device=dev)
    for i in range(n):
        color = sampled[i, :3].permute(1, 2, 0)
        # occlusion: the camera's own surface along this ray must agree; a
        # NaN disparity tap fails it
        cam_depth = 1.0 / torch.clamp(sampled[i, 3], min=1e-12)
        point_depth = _norm(world - rig_cams.position[i])
        visible = cam_depth >= 0.9 * point_depth
        ok = valid[i] & visible & torch.isfinite(color[..., 0])
        wgt = torch.where(ok, cone_w[i], 0.0)
        sum_w = sum_w + wgt
        sum_wc = sum_wc + wgt[..., None] * torch.nan_to_num(color)
    color_out = sum_wc / torch.clamp(sum_w, min=1e-12)[..., None]
    alpha = alpha_valid & (sum_w > 0)
    disparity_out = torch.where(alpha, 1.0 / torch.clamp(zbuf, min=1e-12), math.nan)
    color_out = torch.where(alpha[..., None], color_out, 0.0)

    if mode == "cube":
        s = face_size
        return color_out.reshape(6, s, s, 3), disparity_out.reshape(6, s, s), alpha.reshape(6, s, s)
    return color_out, disparity_out, alpha


def _render_inputs(rig: cam.Rig, colors, disparities, center):
    """Normalized float32 cameras, colors, disparities and center on one
    device: that of ``colors`` if it is a tensor, else the card."""
    dev = colors.device if torch.is_tensor(colors) else default_device()
    nrig = cam.normalize_rig(rig) if not cam.is_normalized(rig.camera(0)) else rig
    cams = nrig.cameras.to(dev, torch.float32)
    return (cams, *(torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (colors, disparities, center)))


def render_cubemap(rig: cam.Rig, colors, disparities, center, face_size: int):
    """Rig (normalized or not) -> (6, S, S) cubemap color, disparity, alpha
    tensors on the device of the inputs."""
    return render_view(*_render_inputs(rig, colors, disparities, center), face_size=face_size, mode="cube")


def render_equirect(rig: cam.Rig, colors, disparities, center, width: int, height: int,
                    ipd: float = 0.0):
    return render_view(*_render_inputs(rig, colors, disparities, center), mode="equirect",
                       width=width, height=height, ipd=float(ipd))
