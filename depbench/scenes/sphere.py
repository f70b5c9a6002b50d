"""A procedurally textured sphere of radius 5 m around the rig.

Frozen copy of ``facebook360_dep_tpu_torch/render/synthetic.py``'s
``render_sphere_scene``, ``ray_sphere_depth`` and ``procedural_texture`` at
commit 73fe11c54864db6ce32ac485256a11aec4484c40, with the texture's octave
vectors drawn from (seed, frame) so that every seed and frame gives a
distinct texture on the same geometry, hence the same work.
"""

from __future__ import annotations

import numpy as np
import torch

from depbench.reference import camera as cam

RADIUS_M = 5.0
OCTAVES = 6


def procedural_texture(dirs, rng, octaves=OCTAVES):
    """Smooth multi-frequency RGB texture over unit directions (..., 3) -> (..., 3) in [0, 1]."""
    color = torch.zeros(dirs.shape[:-1] + (3,), dtype=dirs.dtype, device=dirs.device)
    total = 0.0
    for octave in range(octaves):
        freq = 2.0 ** octave
        amp = 1.0 / (octave + 1)
        vecs = torch.as_tensor(rng.standard_normal((3, 3)) * freq, dtype=dirs.dtype, device=dirs.device)
        phase = torch.as_tensor(rng.random(3) * 2 * np.pi, dtype=dirs.dtype, device=dirs.device)
        proj = torch.stack([cam.dot3(dirs, vecs[k]) for k in range(3)], dim=-1)
        color = color + amp * torch.sin(proj * 3.0 + phase)
        total += amp
    return (color / total + 1.0) * 0.5


def render(cams, size_wh, seed: int, frame: int):
    """(colors (N, H, W, 3), true disparity (N, H, W)) float32 of the
    normalized float32 cameras ``cams`` (N,), on their device."""
    w, h = int(size_wh[0]), int(size_wh[1])
    dev = cams.position.device
    ys = torch.arange(h, device=dev, dtype=torch.float32) + 0.5
    xs = torch.arange(w, device=dev, dtype=torch.float32) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1) / torch.tensor([w, h], dtype=torch.float32, device=dev)
    entropy = [int(seed) & (2**64 - 1), int(frame)]
    colors, disparity = [], []
    for i in range(cams.type_code.shape[0]):  # a camera at a time bounds the temporaries
        c = cams.index(i)
        d = cam.ray_dir(c, grid)
        b = cam.dot3(c.position, d)
        disc = b * b - (cam.dot3(c.position, c.position) - RADIUS_M * RADIUS_M)
        t = torch.where(disc >= 0, -b + torch.sqrt(torch.clamp(disc, min=0.0)), float("nan"))
        hit = c.position + d * t[..., None]
        tex_dir = hit / torch.sqrt(cam.dot3(hit, hit))[..., None]
        colors.append(procedural_texture(tex_dir, np.random.default_rng(entropy)))
        disparity.append(1.0 / t)
    return torch.stack(colors), torch.stack(disparity)
