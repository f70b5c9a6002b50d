"""The sphere of ``sphere.py`` with a textured disk in front of a forward ring: a foreground pass.

The disk, of radius 0.5 m, lies in the plane z = -2 m and faces the ring
(which looks -Z); its centre is at x = 3 cm a frame, so it moves along +X
from frame to frame, its texture with it. The texture is drawn from
(seed, frame) as the sphere's is. Colours and truth are those of the nearer
hit. ``render_inputs`` gives the layers a foreground pass reads beside the
colours: the foreground masks (the rays that hit the disk before the sphere)
and the background plate's disparity (the sphere's alone; the harness asks
for it at frame 0).
"""

from __future__ import annotations

import numpy as np
import torch

from depbench.reference import camera as cam
from depbench.scenes import sphere

DISK_Z_M = -2.0
DISK_RADIUS_M = 0.5
DISK_STEP_M = 0.03  # along +X, a frame


def _disk_hits(cams, size_wh, frame: int):
    """(N, H, W) distance along each unit ray to the disk, inf where it misses, and the hit's
    offset from the disk's centre (N, H, W, 3)."""
    w, h = int(size_wh[0]), int(size_wh[1])
    dev = cams.position.device
    ys = torch.arange(h, device=dev, dtype=torch.float32) + 0.5
    xs = torch.arange(w, device=dev, dtype=torch.float32) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1) / torch.tensor([w, h], dtype=torch.float32, device=dev)
    centre = torch.tensor([DISK_STEP_M * frame, 0.0, DISK_Z_M], dtype=torch.float32, device=dev)
    dist, offset = [], []
    for i in range(cams.type_code.shape[0]):
        c = cams.index(i)
        d = cam.ray_dir(c, grid)
        t = (DISK_Z_M - c.position[2]) / d[..., 2]
        off = c.position + d * t[..., None] - centre
        hit = (t > 0) & (cam.dot3(off, off) <= DISK_RADIUS_M * DISK_RADIUS_M)
        dist.append(torch.where(hit, t, float("inf")))
        offset.append(off)
    return torch.stack(dist), torch.stack(offset)


def _disk_parts(cams, size_wh, seed: int, frame: int):
    """(colors (N, H, W, 3), disparity (N, H, W), mask (N, H, W)) of the disk over the sphere."""
    rgb, sphere_disp = sphere.render(cams, size_wh, seed, frame)
    dist, offset = _disk_hits(cams, size_wh, frame)
    disk_disp = 1.0 / dist
    mask = disk_disp > sphere_disp
    # the texture in the disk's own coordinates, so that it moves with the disk
    local = torch.cat([offset[..., :2] / DISK_RADIUS_M, torch.ones_like(offset[..., :1])], dim=-1)
    tex = sphere.procedural_texture(local, np.random.default_rng([int(seed) & (2**64 - 1), int(frame), 1]))
    colors = torch.where(mask[..., None], tex, rgb)
    return colors, torch.where(mask, disk_disp, sphere_disp), mask


def render(cams, size_wh, seed: int, frame: int):
    """(colors (N, H, W, 3), true disparity (N, H, W)) float32 of the
    normalized float32 cameras ``cams`` (N,), on their device."""
    colors, disparity, _ = _disk_parts(cams, size_wh, seed, frame)
    return colors, disparity


def render_inputs(cams, size_wh, seed: int, frame: int) -> dict:
    """{image type: (N, H, W)}: the foreground masks of ``frame`` (bool) and the background's
    disparity (float32), the sphere without the disk."""
    _, sphere_disp = sphere.render(cams, size_wh, seed, frame)
    dist, _ = _disk_hits(cams, size_wh, frame)
    return {"foreground_masks_levels": 1.0 / dist > sphere_disp, "background_disp_levels": sphere_disp}
