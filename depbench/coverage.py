"""What the cost kernels' inputs need at one level, and K1's and K3's least work from it.

A camera sees only part of a frame: an FTHETA fisheye's image circle covers
about half of its sensor, and a source on the far side of the ring sees
nothing of a destination. K1 and K3 never project a destination pixel
outside its camera's field of view, and never sample a source where no
projection lands. So their least work is counted from the geometry of the
level, at the scene's true disparity:

- a destination pixel is *in view* where it lies inside its image circle;
- a (destination pixel, source) pair is *valid* where the pixel is in view,
  its disparity is positive and its world point projects inside the
  source's field of view and sensor, as the reference's cost decides it;
- a source pixel is *needed* where it is one of the four bilinear taps
  (clamped to the image) of a valid pair.

:func:`level_needs` counts them on the device; :func:`k1_work` and
:func:`k3_work` turn them into bytes and FLOPs, each needed input read once
and each output written once, with the per-pair operation counts of
``roofline.py``. K2 reads K1's outputs, every pixel of them, so its work is
``roofline.k2_work``.
"""

from __future__ import annotations

import torch

from depbench import roofline
from depbench.reference import camera as cam

PROJECT_FLOPS = 70  # roofline.k1_flops: the projection of a pair
SAMPLE_FLOPS_PER_CHANNEL = 6  # roofline.k1_flops: a bilinear lerp of one channel


def level_needs(cams_norm, size_wh, disparity) -> dict:
    """The counts of one level: ``cams_norm`` the rig's normalized cameras
    (N,), ``size_wh`` the level's (w, h), ``disparity`` (N, h, w) the true
    disparity on the device where the counting runs.

    ``k1_*`` are sums over the whole rig, one K1 launch's work (every
    destination against every source, itself included); ``k3_*`` are means
    over the destinations of one K3 launch's work (one destination against
    the other sources)."""
    w, h = int(size_wh[0]), int(size_wh[1])
    dev = disparity.device
    n = disparity.shape[0]
    cams = cams_norm.to(dev, torch.float32)
    ys = torch.arange(h, device=dev, dtype=torch.float32) + 0.5
    xs = torch.arange(w, device=dev, dtype=torch.float32) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = (torch.stack([gx, gy], dim=-1) / torch.tensor([w, h], dtype=torch.float32, device=dev)).expand(n, h, w, 2)
    in_view = ~cam.is_outside_image_circle(cams, grid)
    rays = cam.ray_dir(cams, grid)
    srcs = cams.unsqueeze()
    size = torch.tensor([w, h], dtype=torch.float32, device=dev)
    lanes = torch.arange(n, device=dev)
    union = torch.zeros(n * h * w, dtype=torch.bool, device=dev)
    k3_src_px = valid_all = valid_other = 0
    for d in range(n):  # a destination at a time bounds the temporaries
        disp = disparity[d]
        world = cams.position[d] + rays[d] / torch.clamp(disp, min=1e-12)[..., None]
        pix, valid = cam.sees(srcs, world[None, None])
        coords, valid = pix[0] * size, valid[0]
        valid = valid & (in_view[d] & (disp > 0))[None] & torch.isfinite(coords).all(dim=-1)
        x0 = torch.floor(torch.nan_to_num(coords[..., 0]) - 0.5).to(torch.int64)
        y0 = torch.floor(torch.nan_to_num(coords[..., 1]) - 0.5).to(torch.int64)
        base = (lanes * (h * w))[:, None, None]
        needed = torch.zeros(n * h * w, dtype=torch.bool, device=dev)
        for dy in (0, 1):
            for dx in (0, 1):
                idx = base + (y0 + dy).clamp(0, h - 1) * w + (x0 + dx).clamp(0, w - 1)
                needed[idx[valid]] = True
        union |= needed
        per_src = needed.view(n, h * w).sum(dim=1)
        k3_src_px += int(per_src.sum() - per_src[d])
        per_pair = valid.view(n, -1).sum(dim=1)
        valid_all += int(per_pair.sum())
        valid_other += int(per_pair.sum() - per_pair[d])
    in_view_px = int(in_view.sum())
    return {"cameras": n, "pixels": h * w,
            "k1_src_px": int(union.sum()), "k1_in_view_pairs": in_view_px * n, "k1_valid_pairs": valid_all,
            "k3_src_px": k3_src_px / n, "k3_in_view_px": in_view_px / n,
            "k3_in_view_pairs": in_view_px * (n - 1) / n, "k3_valid_pairs": valid_other / n}


def k1_work(g: dict, c: int):
    """(bytes, FLOPs) of one K1 launch of every destination map over the
    rig's sources of ``c`` channels: the needed source pixels, the cameras,
    each map's rays and disparity, and every sample and validity written."""
    n, hw = g["cameras"], g["pixels"]
    nbytes = 4 * c * g["k1_src_px"] + n * roofline.PARAM_BYTES + n * (12 + 16 * hw) + n * n * (4 * c + 1) * hw
    flops = PROJECT_FLOPS * g["k1_in_view_pairs"] + SAMPLE_FLOPS_PER_CHANNEL * c * g["k1_valid_pairs"]
    return nbytes, flops


def k3_work(g: dict):
    """(bytes, FLOPs) of one K3 launch (one destination, three channels):
    the needed pixels of the other sources, the cameras, the rays and
    disparity of every pixel, the color and variance of the pixels in view,
    cost and confidence written; the projection of each in-view pair, the
    sample and the patch SSD and fold of each valid one."""
    n, hw = g["cameras"], g["pixels"]
    nbytes = (4 * 3 * g["k3_src_px"] + n * roofline.PARAM_BYTES + 12 + 16 * hw
              + 16 * g["k3_in_view_px"] + 8 * hw)
    flops = (PROJECT_FLOPS * g["k3_in_view_pairs"]
             + (SAMPLE_FLOPS_PER_CHANNEL * 3 + roofline.k2_flops(3)) * g["k3_valid_pairs"])
    return nbytes, flops
