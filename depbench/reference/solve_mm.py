"""Plain reference of the mismatch stage: ``derp_cli --mismatches_start_level L``.

The solve of ``solve.py`` (imported from it: the level, its cost, the
draws, the filters) with the cross-camera consistency stage that the
program runs after ping-pong at every level ``0 <= level <= L`` below the
coarsest (``depth/solver.py::handle_mismatches`` of the program at commit
9f230eb13e59b4034c523b405ad8f5239a1b1de8; handleDisparityMismatches,
Derp.cpp:553-748). For each pixel of each destination:

- its depth, the inverse of its disparity, is projected into every other
  camera, as the cost projects a candidate (``solve.Level.cost``), and that
  camera's disparity map is sampled there, clamp-to-edge bilinear as
  ``solve.bilinear_sample_sources`` samples colours;
- a sample votes where the camera sees the point and the sample is finite;
  it is a match within +-10% of the pixel's disparity (kFractionChange),
  else a mismatch;
- the pixel is kept where it has no vote, at least
  ``MIN_OVERLAPPING_CAMS - 1`` matches, or a variance outside
  [``var_noise_floor``, ``var_high_thresh``];
- elsewhere inside the FOV it is replaced: it takes the smaller of its
  disparity and the median of the farther mismatched disparities (those
  below its own), counted from the far end, the ``k // 2``-th smallest of
  ``k``; the pixel is then set in the mismatch mask.

``MISMATCHES_START_LEVEL`` is the flag's value, a constant because the
harness hands the reference no flags; it is the value of the cell that
names this module (``cells/sphere16.mismatch2k.json``).

Where this module departs, or may depart, from the C++ (SURVEY.md:132
summarises its loop; the C++ source is not in this repository):

- every pixel of a block of destinations is decided at once, against every
  source in one tensor, where the C++ loops over pixels and sources;
- a source votes only where its bilinear sample is finite: a NaN tap (a
  pixel outside that camera's FOV) voids the sample even where its weight
  is zero;
- a pixel with mismatches, none of them farther, is "replaced" by itself
  (the median of an empty set is +inf here, and the smaller of the two is
  its own disparity), so it is set in the mask with its value unchanged;
- the median's rank is ``k // 2`` of the ``k`` farther samples sorted
  from the far end (the lower middle where ``k`` is even), as the program
  counts it;
- the foreground masks are not read: the configurations that name this
  module run no foreground pass.

Every elementwise expression is the program's, in its order, so the
float32 reference gives the program's bits where the program runs its
plain twins. The median is a sort of the farther mismatched samples alone.
Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from depbench.reference import camera as cam
from depbench.reference import solve as base

MISMATCHES_START_LEVEL = 0
FRACTION_CHANGE = 0.1  # kFractionChange, Derp.cpp:594


def runs_stage(level: int, num_levels: int) -> bool:
    """Whether the stage runs at ``level``: below the coarsest, at or under ``MISMATCHES_START_LEVEL``."""
    return level != num_levels - 1 and 0 <= level <= MISMATCHES_START_LEVEL


def sample_disparities(lv: base.Level, disparity, sl: slice):
    """Each camera's map of ``disparity`` (N, H, W) sampled where the pixels
    of the destinations ``sl`` project at their own disparity: (B, N, H, W)
    samples, 0 where a camera does not see the point, and (B, N, H, W) valid."""
    src_cams = lv.cams.unsqueeze()
    size = torch.tensor([lv.w, lv.h], dtype=lv.dtype, device=lv.device)
    disp = disparity[sl]
    depth = 1.0 / torch.clamp(disp, min=1e-12)
    world = (lv.cams.position[sl][:, :, None, None] + lv.rays[sl] * depth[:, None]).permute(0, 2, 3, 1)
    pix, valid = cam.sees(src_cams, world[:, None])
    coords = pix * size
    valid = valid & (disp > 0)[:, None] & torch.isfinite(coords).all(dim=-1)
    sampled = base.bilinear_sample_sources(disparity[..., None], coords)[..., 0]
    return torch.where(valid, sampled, 0.0), valid


def handle_mismatches(lv: base.Level, disparity):
    """The stage on (D, H, W) maps, a block of destinations at a time:
    (new maps, mismatch mask)."""
    n = disparity.shape[0]
    frac = FRACTION_CHANGE
    lanes = torch.arange(n, device=lv.device)[None, :, None, None]
    out, masks = [], []
    for b0 in range(0, n, lv.block):
        sl = slice(b0, min(n, b0 + lv.block))
        d_srcs, valid = sample_disparities(lv, disparity, sl)
        disp = disparity[sl]
        own = torch.arange(sl.start, sl.stop, device=lv.device)[:, None, None, None]
        votes = valid & (lanes != own) & torch.isfinite(d_srcs)
        lo, hi = ((1 - frac) * disp)[:, None], ((1 + frac) * disp)[:, None]
        is_match = votes & (d_srcs >= lo) & (d_srcs <= hi)
        is_mismatch = votes & ~is_match
        num_match = is_match.sum(dim=1)
        total = num_match + is_mismatch.sum(dim=1)
        farther = is_mismatch & (d_srcs < disp[:, None])
        k = farther.sum(dim=1)
        ordered = torch.sort(torch.where(farther, d_srcs, math.inf), dim=1).values
        median = torch.gather(ordered, 1, (k // 2)[:, None])[:, 0]
        variance = lv.variance[sl]
        keep = ((total == 0) | (num_match >= base.MIN_OVERLAPPING_CAMS - 1)
                | (variance > lv.var_high_thresh) | (variance < lv.var_noise_floor))
        replace = ~keep & lv.fov[sl]
        out.append(torch.where(replace, torch.minimum(disp, median), disp))
        masks.append(replace)
        del d_srcs, valid, ordered
    return torch.cat(out), torch.cat(masks)


def solve_level(lv: base.Level, init, num_levels, min_depth, max_depth, random_proposal_count=2):
    """process_level with derp_cli's default flags and the mismatch stage:
    (D, H, W) disparity, NaN outside the FOV, and the mismatch mask."""
    d, h, w = lv.fov.shape
    mask = torch.zeros((d, h, w), dtype=torch.bool, device=lv.device)
    if lv.level == num_levels - 1 or init is None:
        disparity, _, _ = base.brute_force(lv, min_depth, max_depth)
    else:
        uniforms = base.draw_uniforms(lv.level, d, random_proposal_count, h, w, lv.device)
        disparity, costs, confs = base.random_proposals(lv, init.to(lv.dtype), uniforms, min_depth, max_depth)
        del uniforms
        disparity, _, _ = base.ping_pong(lv, disparity, costs, confs)
        if runs_stage(lv.level, num_levels):
            disparity, mask = handle_mismatches(lv, disparity)
    radius = max(math.ceil(base.BILATERAL_SPACE_RADIUS_MAX * base.LEVEL_SCALE ** lv.level),
                 base.BILATERAL_SPACE_RADIUS_MIN)
    disparity = base.joint_bilateral(disparity, lv.colors[..., :3], lv.fov, radius)
    disparity = base.masked_median(disparity, lv.fov, radius=1)
    return torch.where(lv.fov, disparity, float("nan")), mask


def solve_pyramid(cams_norm, colors_by_level, sizes, full_height, min_depth, max_depth, device,
                  dtype=torch.float32, keep=(), reverse_sum=False, masks=None):
    """Every level of one frame, coarsest first, as ``solve.solve_pyramid``,
    with the mismatch stage; returns {level: (D, H, W) float32 numpy} for
    the levels in ``keep``. A dict given as ``masks`` receives {level:
    (D, H, W) bool numpy}, the mismatch mask of every level kept."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        levels = sorted(colors_by_level, reverse=True)
        num_levels = max(sizes) + 1
        out, prev = {}, None
        for level in levels:
            u16 = colors_by_level[level]
            colors = torch.from_numpy(u16.astype(np.float32) / np.float32(65535.0)).to(device)
            lv = base.Level(cams_norm, colors, level, full_height, dtype, reverse_sum)
            init = None
            if prev is not None:
                init = base.resize_lanczos4(torch.nan_to_num(prev.to(lv.dtype), nan=1e-4), sizes[level])
            prev, mask = solve_level(lv, init, num_levels, min_depth, max_depth)
            if level in keep:
                out[level] = prev.to(torch.float32).cpu().numpy()
                if masks is not None:
                    masks[level] = mask.cpu().numpy()
            del lv, colors, init, mask
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
