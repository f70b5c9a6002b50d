"""Synthetic ground-truth scenes: the port of ``render/synthetic.py`` (sphere scene).

Ray casting against a procedurally textured sphere with the same camera
model the solver uses, giving (color, ground-truth disparity) per camera
(the reference's RigSimulator, ``rig/RigSimulator.cpp:37-64``).
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
