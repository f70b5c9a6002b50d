"""Synthetic ground-truth scenes: the port of ``render/synthetic.py``.

Ray casting against a procedurally textured sphere or box room with the same
camera model the solver uses, giving (color, ground-truth disparity) per
camera (the reference's RigSimulator, ``rig/RigSimulator.cpp:37-64``), the
rig builders of RigSimulator's modes (forward ring, outward ring, FTHETA
ring, platonic solids; host float64, as ``make_camera`` builds them) and
the equirect truths (mono from the rig center, omni-directional stereo).
Renders run on the device of ``device`` (None: the rig's, the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import camera as cam
from ..ops import sampling


def procedural_texture(dirs: torch.Tensor, seed: int = 7, octaves: int = 6) -> torch.Tensor:
    """Smooth multi-frequency RGB texture over unit directions (..., 3) ->
    (..., 3) in [0,1]. The octave vectors come from np.random.RandomState(seed),
    so the texture is the JAX package's."""
    rng = np.random.RandomState(seed)
    color = torch.zeros(dirs.shape[:-1] + (3,), dtype=dirs.dtype, device=dirs.device)
    total = 0.0
    for octave in range(octaves):
        freq = 2.0 ** octave
        amp = 1.0 / (octave + 1)
        vecs = torch.as_tensor(rng.randn(3, 3) * freq, dtype=dirs.dtype, device=dirs.device)
        phase = torch.as_tensor(rng.rand(3) * 2 * np.pi, dtype=dirs.dtype, device=dirs.device)
        proj = torch.stack([cam._dot3(dirs, vecs[k]) for k in range(3)], dim=-1)  # dirs @ vecs.T
        color = color + amp * torch.sin(proj * 3.0 + phase)
        total += amp
    return (color / total + 1.0) * 0.5


def ray_sphere_depth(origins, dirs, center, radius):
    """Distance along each ray to a sphere (rays start inside).

    origins/dirs: (..., 3); returns (...,) t > 0 (NaN if no hit).
    """
    oc = origins - torch.as_tensor(center, dtype=dirs.dtype, device=dirs.device)
    b = cam._dot3(oc, dirs)
    c0 = cam._dot3(oc, oc) - radius * radius
    disc = b * b - c0
    t = -b + torch.sqrt(torch.clamp(disc, min=0.0))
    return torch.where(disc >= 0, t, float("nan"))


def render_sphere_scene(rig: cam.Rig, size_wh, radius: float = 5.0, center=(0.0, 0.0, 0.0),
                        seed: int = 7, device=None):
    """Render every rig camera against a textured sphere on ``device``.

    Returns (colors (N, H, W, 3), gt_disparity (N, H, W)) float32 tensors.
    Cameras must sit inside the sphere; disparity = 1 / (camera-to-hit
    distance), the solver's definition (DerpUtil.cpp:38-52).
    """
    w, h = int(size_wh[0]), int(size_wh[1])
    cams = cam.normalize_rig(rig).cameras.to(device, torch.float32)
    dev = cams.position.device
    grid = sampling.pixel_center_grid(h, w, device=dev) / torch.tensor([w, h], dtype=torch.float32, device=dev)
    center_t = torch.tensor(center, dtype=torch.float32, device=dev)
    colors, disparity = [], []
    for i in range(len(rig.ids)):  # one camera at a time bounds the 2K temporaries
        c = cams.index(i)
        d = cam.ray_dir(c, grid)
        t = ray_sphere_depth(c.position, d, center_t, radius)
        hit = c.position + d * t[..., None]
        tex_dir = hit - center_t
        tex_dir = tex_dir / torch.sqrt(cam._dot3(tex_dir, tex_dir))[..., None]
        colors.append(procedural_texture(tex_dir, seed))
        disparity.append(1.0 / t)
    return torch.stack(colors), torch.stack(disparity)


def make_test_rig(
    num_cameras: int = 4,
    resolution=(64, 48),
    focal_scale: float = 0.45,
    ring_radius: float = 0.15,
    type_name: str = "RECTILINEAR",
) -> cam.Rig:
    """A forward-facing ring rig with parallax, for solver tests: cameras on
    a circle in the XY plane, all looking -Z."""
    w, h = resolution
    cams, ids = [], []
    for i in range(num_cameras):
        angle = 2 * np.pi * i / num_cameras
        cams.append(cam.make_camera(
            type_code=getattr(cam, type_name),
            position=[ring_radius * np.cos(angle), ring_radius * np.sin(angle), 0.0],
            rotation=np.eye(3),  # right=+x, up=+y, backward=+z (looking -z)
            resolution=[w, h],
            focal=[focal_scale * w, -focal_scale * w],
        ))
        ids.append(f"cam{i}")
    return cam.Rig(cameras=cam.stack_cameras(cams), ids=tuple(ids), groups=("",) * num_cameras)


def make_outward_ring_rig(
    num_cameras: int = 16,
    resolution=(64, 48),
    focal_scale: float = 0.45,
    ring_radius: float = 0.3,
) -> cam.Rig:
    """The production 360 rig shape: cameras on a ring facing radially
    outward (the reference's 6DoF capture rigs). Only adjacent cameras
    overlap."""
    w, h = resolution
    cams, ids = [], []
    up = np.array([0.0, 0.0, 1.0])
    for k in range(num_cameras):
        a = 2 * np.pi * k / num_cameras
        fwd = np.array([np.cos(a), np.sin(a), 0.0])
        cams.append(cam.make_camera(
            type_code=cam.RECTILINEAR,
            position=ring_radius * fwd,
            rotation=np.stack([np.cross(up, fwd), up, -fwd], axis=0),
            resolution=[w, h],
            focal=[focal_scale * w, -focal_scale * w],
        ))
        ids.append(f"cam{k}")
    return cam.Rig(cameras=cam.stack_cameras(cams), ids=tuple(ids), groups=("",) * num_cameras)


def _looking_camera(type_code, fwd, position, resolution, focal,
                    distortion=(0.0, 0.0, 0.0), cos_fov=None):
    """Camera with rotation rows [right, up, -fwd] from a forward direction
    and world-up z (ringOfClones / makeFThetaCameraOnSphere, RigSimulator)."""
    fwd = np.asarray(fwd, np.float64)
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(up, fwd)) > 0.99:
        up = np.array([1.0, 0.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    return cam.make_camera(
        type_code=type_code,
        position=position,
        rotation=np.stack([right, up, -fwd], axis=0),
        resolution=list(resolution),
        focal=focal,
        distortion=distortion,
        cos_fov=cos_fov,
    )


# reference production-rig distortion (res/test/rigs/rig.json, 16-cam FTHETA):
# sensor-unit radial polynomial coefficients, resolution independent
PRODUCTION_FTHETA_DISTORTION = (-0.03413328161902581, 0.0004374554953464843,
                                -0.0018843963208481174)


def _ftheta_focal(resolution, image_circle_radius_px, circle_fov_deg):
    """makeGenericFTheta (RigSimulator.cpp:389-398): focal such that the
    image circle radius lands at half the circle FOV: f = 2 R / fov_rad."""
    f = 2.0 * image_circle_radius_px / np.radians(circle_fov_deg)
    return [f, -f]


def make_ftheta_ring_rig(
    num_cameras: int = 14,
    ring_radius: float = 0.33,
    resolution=(300, 400),
    image_circle_radius_px: float | None = None,
    circle_fov_deg: float = 166.667,
    distortion=(0.0, 0.0, 0.0),
    add_top: bool = True,
    top_offset: float = 0.13,
) -> cam.Rig:
    """Outward FTHETA fisheye ring + optional up-facing top camera: the
    reference's production rig shape (RigSimulator makeHorizontalRingOf
    FThetaCameras + addTopCamera; res/test/rigs/rig.json is this with 16
    side cameras). The image circle spans 166.7 deg, so adjacent cameras
    share wide overlap bands where the FTHETA Jacobian stretches."""
    w, h = resolution
    r_px = image_circle_radius_px if image_circle_radius_px is not None else 0.83 * min(w, h) / 2
    focal = _ftheta_focal(resolution, r_px, circle_fov_deg)
    cos_fov = float(np.cos(np.radians(circle_fov_deg) / 2))
    cams, ids = [], []
    for k in range(num_cameras):
        a = -2 * np.pi * k / num_cameras  # clockwise, ringOfClones
        fwd = np.array([np.cos(a), np.sin(a), 0.0])
        cams.append(_looking_camera(cam.FTHETA, fwd, ring_radius * fwd, resolution, focal, distortion, cos_fov))
        ids.append(f"cam{k}")
    if add_top:
        cams.append(_looking_camera(cam.FTHETA, (0.0, 0.0, 1.0), (0.0, 0.0, top_offset), resolution,
                                    focal, distortion, cos_fov))
        ids.append(f"cam{num_cameras}")
    return cam.Rig(cameras=cam.stack_cameras(cams), ids=tuple(ids), groups=("",) * len(ids))


# icosahedron vertices: cyclic permutations of (0, +-1, +-phi)
_PHI = (1.0 + np.sqrt(5.0)) / 2.0
ICOSAHEDRON_VERTS = np.array(
    [(0, s1, s2 * _PHI) for s1 in (-1, 1) for s2 in (-1, 1)]
    + [(s2 * _PHI, 0, s1) for s1 in (-1, 1) for s2 in (-1, 1)]
    + [(s1, s2 * _PHI, 0) for s1 in (-1, 1) for s2 in (-1, 1)],
    np.float64,
)
# dodecahedron vertices: (+-1,+-1,+-1) + cyclic perms of (0, +-1/phi, +-phi)
DODECAHEDRON_VERTS = np.array(
    [(a, b, c) for a in (-1, 1) for b in (-1, 1) for c in (-1, 1)]
    + [(0, s1 / _PHI, s2 * _PHI) for s1 in (-1, 1) for s2 in (-1, 1)]
    + [(s2 * _PHI, 0, s1 / _PHI) for s1 in (-1, 1) for s2 in (-1, 1)]
    + [(s1 / _PHI, s2 * _PHI, 0) for s1 in (-1, 1) for s2 in (-1, 1)],
    np.float64,
)


def make_polyhedron_rig(
    kind: str = "dodecahedron",
    sphere_radius: float = 0.25,
    resolution=(300, 400),
    image_circle_radius_px: float | None = None,
    circle_fov_deg: float = 166.667,
    distortion=(0.0, 0.0, 0.0),
) -> cam.Rig:
    """FTHETA cameras at platonic-solid vertices pointing outward
    (RigSimulator makeDodecahedronOfFThetaCameras: 12 cameras at the
    icosahedron's vertices; makeIcosahedronOfFThetaCameras: 20 at the
    dodecahedron's)."""
    verts = ICOSAHEDRON_VERTS if kind == "dodecahedron" else DODECAHEDRON_VERTS
    w, h = resolution
    r_px = image_circle_radius_px if image_circle_radius_px is not None else 0.83 * min(w, h) / 2
    focal = _ftheta_focal(resolution, r_px, circle_fov_deg)
    cos_fov = float(np.cos(np.radians(circle_fov_deg) / 2))
    cams, ids = [], []
    for k, v in enumerate(verts):
        n = v / np.linalg.norm(v)
        cams.append(_looking_camera(cam.FTHETA, n, sphere_radius * n, resolution, focal, distortion, cos_fov))
        ids.append(f"cam{k}")
    return cam.Rig(cameras=cam.stack_cameras(cams), ids=tuple(ids), groups=("",) * len(ids))


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(cam._dot3(v, v))


def _scene_depth(origins, dirs, scene: str, radius: float, half_extents):
    if scene == "box":
        return ray_box_depth(origins, dirs, half_extents)
    return ray_sphere_depth(origins, dirs, (0.0, 0.0, 0.0), radius)


def render_ods_equirect(width: int, height: int, ipd_radius: float = 0.032,
                        scene: str = "sphere", radius: float = 5.0,
                        half_extents=(6.0, 6.0, 3.0), seed: int = 7, device=None):
    """Omni-directional-stereo equirect pair (RigSimulator stereo_eqr mode,
    renderStereoEquirect): each column's eye sits on the view circle of
    radius ``ipd_radius``, offset along the local horizontal tangent.
    Returns (left, right) (H, W, 3) float32 tensors on ``device``."""
    from . import dibr

    dirs = dibr.equirect_dirs(width, height, device=device)  # (H, W, 3) unit
    # up x dirs with up = +z, written out: (-dy, dx, 0)
    tang = torch.stack([-dirs[..., 1], dirs[..., 0], torch.zeros_like(dirs[..., 0])], dim=-1)
    tn = _norm(tang)[..., None]
    tang = torch.where(tn > 1e-6, tang / torch.clamp(tn, min=1e-6), 0.0)  # poles: mono

    def eye(sign):
        origins = sign * ipd_radius * tang
        t = _scene_depth(origins, dirs, scene, radius, half_extents)
        hit = origins + dirs * t[..., None]
        tex = hit / torch.clamp(_norm(hit), min=1e-9)[..., None]
        return procedural_texture(tex, seed, octaves=7 if scene == "box" else 6)

    return eye(-1.0), eye(1.0)


def ray_box_depth(origins, dirs, half_extents=(6.0, 6.0, 3.0), center=(0.0, 0.0, 0.0)):
    """Distance along each ray to the inside of an axis-aligned box (rays
    start inside; the reference's textured box/ceiling world,
    rig/RigSimulator.cpp:37-64). origins/dirs: (..., 3); returns (...,) t > 0."""
    he = torch.as_tensor(half_extents, dtype=dirs.dtype, device=dirs.device)
    oc = origins - torch.as_tensor(center, dtype=dirs.dtype, device=dirs.device)
    # exit distance per axis: the positive root of |oc + t d| = he
    safe_d = torch.where(dirs.abs() < 1e-12, 1e-12, dirs)
    t_exit = torch.maximum((he - oc) / safe_d, (-he - oc) / safe_d)
    return torch.amin(t_exit, dim=-1)


def render_box_scene(rig: cam.Rig, size_wh, half_extents=(6.0, 6.0, 3.0), center=(0.0, 0.0, 0.0),
                     seed: int = 7, device=None):
    """Render every rig camera against a procedurally textured box room
    (RigSimulator's box/ceiling world) on ``device``. Returns (colors (N, H,
    W, 3), gt_disparity (N, H, W)) float32 tensors."""
    w, h = int(size_wh[0]), int(size_wh[1])
    cams = cam.normalize_rig(rig).cameras.to(device, torch.float32)
    dev = cams.position.device
    grid = sampling.pixel_center_grid(h, w, device=dev) / torch.tensor([w, h], dtype=torch.float32, device=dev)
    center_t = torch.tensor(center, dtype=torch.float32, device=dev)
    he = torch.tensor(half_extents, dtype=torch.float32, device=dev)
    colors, disparity = [], []
    for i in range(len(rig.ids)):
        c = cams.index(i)
        d = cam.ray_dir(c, grid)
        t = ray_box_depth(c.position, d, he, center_t)
        hit = c.position + d * t[..., None]
        # texture by position on the box surface (the direction from the
        # center gives seams at edges only)
        tex_dir = hit - center_t
        tex_dir = tex_dir / torch.clamp(_norm(tex_dir), min=1e-9)[..., None]
        colors.append(procedural_texture(tex_dir, seed, octaves=7))
        disparity.append(1.0 / t)
    return torch.stack(colors), torch.stack(disparity)


def ground_truth_equirect(rig: cam.Rig | None, width: int, height: int, scene: str = "sphere",
                          radius: float = 5.0, half_extents=(6.0, 6.0, 3.0), seed: int = 7, device=None):
    """True (color (H, W, 3), disparity (H, W)) equirects from the rig
    center, float32 tensors on ``device``: the reference RigSimulator's
    equirect truth outputs. ``rig`` is not read (the JAX signature)."""
    from . import dibr

    dirs = dibr.equirect_dirs(width, height, device=device)
    origin = torch.zeros(3, dtype=torch.float32, device=dirs.device)
    t = _scene_depth(origin, dirs, scene, radius, half_extents)
    hit = dirs * t[..., None]
    tex = hit / torch.clamp(_norm(hit), min=1e-9)[..., None]
    color = procedural_texture(tex, seed, octaves=7 if scene == "box" else 6)
    return color, 1.0 / t
