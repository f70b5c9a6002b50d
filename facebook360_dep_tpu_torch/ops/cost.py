"""Plane-sweep matching cost — the port of ``ops/cost.py``.

The reference's per-pixel patch SSD (``Derp.cpp:104-226`` computeCost +
``DerpUtil.cpp:126-162`` computeSSD) for all pixels of a destination camera
at once:

  1. unproject every dst pixel at the hypothesis disparity and project it
     into each source camera (Derp.cpp:144-162),
  2. bilinear-sample the source there,
  3. biased 3x3 patch SSD and the bias-compensated ``unbiased = biased -
     n * |patch-mean diff|^2`` (DerpUtil.cpp:136-152),
  4. across sources: drop the two worst biased SSDs, average the rest, divide
     by keep^2 and by the local variance (Derp.cpp:203-225).

The semantics are the JAX package's exact XLA path (no source windows, no
quantization). ``cost_for_disparity`` evaluates all the destination maps of
a level at once through the wrappers of :mod:`.warp_cuda`: on CUDA tensors
the kernels (one K1 launch for all maps then K2 a map below 512x384, the
fused K3 a map from there up), on CPU tensors their plain twins.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import camera as cam
from . import sampling
from . import warp_cuda

# Algorithm constants (Derp.h:26-48)
SEARCH_WINDOW_RADIUS = 1
MIN_OVERLAPPING_CAMS = 2
# minimum valid members of a bias-compensated 3x3 patch (cost.py:47-52)
MIN_PATCH_SUPPORT = 5
NUM_DEPTHS = 150
RANDOM_PROP_MAX_COST = 5.0
RANDOM_PROP_HIGH_VAR_DEVIATION = 0.1
MIN_VAR = 1.0 / 12.0 / 65025.0
LEVEL_SCALE = 0.9
FLT_MAX = float(np.finfo(np.float32).max)

# Pixel count from which cost_for_disparity runs the fused kernel K3; below
# it K1 then K2 (the TPU path's split, cost.py:403). Both give the same
# costs, so the split only decides which kernels a level launches.
FUSED_MIN_PIXELS = 512 * 384


class CostContext(NamedTuple):
    """Device-resident state for evaluating costs of D destination cameras
    of one level at once, in the layouts the kernels read."""

    cam_dst: cam.Camera  # (D,) normalized, float32
    src_params: torch.Tensor  # (N, 24) packed source cameras (warp_cuda.pack_camera_params)
    dst_planar: torch.Tensor  # (D, 3, H, W) float in [0,1], what K2 and K3 read
    variance: torch.Tensor  # (D, H, W) dst color variance
    exclude_idx: tuple  # (D,) int: each dst's index within the src rig
    dst_rays: torch.Tensor  # (D, 3, H, W) unit ray dirs of the dst pixels
    src_rgba: torch.Tensor  # (N, Hs, Ws, 4) RGB + pad (warp_cuda.rgba_stack), what K1 and K3 read


def dst_ray_dirs(cam_dst: cam.Camera, h: int, w: int) -> torch.Tensor:
    """(..., H, W, 3) unit rays through the dst pixel centers (normalized
    pixel units); ``cam_dst`` may be a batch. The disparity-independent half
    of dstToWorldPoint (DerpUtil.cpp:38-52)."""
    dev = cam_dst.position.device
    grid = sampling.pixel_center_grid(h, w, device=dev) / torch.tensor([w, h], dtype=torch.float32, device=dev)
    return cam.ray_dir(cam_dst, grid.expand(tuple(cam_dst.type_code.shape) + grid.shape))


def probe_disparities(num: int, min_disparity: float, max_disparity: float) -> np.ndarray:
    """Uniform-in-disparity probe schedule (float32), probe 0 = closest
    depth. util/ImageUtil.cpp:100-107."""
    fraction = np.arange(num, dtype=np.float32) / np.float32(num - 1)
    return fraction * np.float32(min_disparity) + (np.float32(1) - fraction) * np.float32(max_disparity)


def _disparity_map(disparity, shape, device) -> torch.Tensor:
    """A scalar hypothesis or a map -> a contiguous float32 map of ``shape``."""
    if isinstance(disparity, torch.Tensor):
        return torch.broadcast_to(disparity.to(device=device, dtype=torch.float32), shape).contiguous()
    return torch.full(shape, float(disparity), dtype=torch.float32, device=device)


def reproject_rays(dst_position, dst_rays, cam_src: cam.Camera, disparity, src_hw):
    """Per-pixel src sampling coords for a disparity map (or scalar).

    dst_rays is channel-planar (3, H, W); ``cam_src`` one camera or a batch
    (N,). Returns ((..., H, W, 2) coords in src pixel units, (..., H, W)
    validity). Derp.cpp:144-162 (dstToWorldPoint -> worldToSrcPoint).
    """
    hs, ws = src_hw
    h, w = dst_rays.shape[-2:]
    disparity = _disparity_map(disparity, (h, w), dst_rays.device)
    depth = 1.0 / torch.clamp(disparity, min=1e-12)
    world = (dst_position[:, None, None] + dst_rays * depth).permute(1, 2, 0)
    world = world.reshape((1,) * cam_src.batch_ndim + world.shape)
    src_pix, valid = cam.sees(cam_src, world)
    coords = src_pix * torch.tensor([ws, hs], dtype=torch.float32, device=src_pix.device)
    valid = valid & (disparity > 0) & torch.isfinite(coords).all(dim=-1)
    return coords, valid


def ssd_planar(dst_img, sampled_planar, valid, radius=SEARCH_WINDOW_RADIUS):
    """Biased/unbiased patch SSD stacks from channel-planar samples.

    dst_img: (H, W, C); sampled_planar: (N, C, H, W); valid: (N, H, W).
    Channel sums run in channel order, as in the kernels."""
    n_patch = (2 * radius + 1) ** 2
    dst_planar = dst_img.permute(2, 0, 1)
    diff = torch.where(valid[:, None], dst_planar[None] - sampled_planar, 0.0)  # (N, C, H, W)
    cnt = sampling.box_sum_planar(valid.to(dst_img.dtype), radius)
    cnt_safe = torch.clamp(cnt, min=1.0)
    scale = n_patch / cnt_safe
    c = diff.shape[1]
    d2 = diff[:, 0] * diff[:, 0]
    for ch in range(1, c):
        d2 = d2 + diff[:, ch] * diff[:, ch]
    biased = sampling.box_sum_planar(d2, radius) * scale
    mean_diff = sampling.box_sum_planar(diff, radius) / cnt_safe[:, None]
    md_sq = mean_diff[:, 0] * mean_diff[:, 0]
    for ch in range(1, c):
        md_sq = md_sq + mean_diff[:, ch] * mean_diff[:, ch]
    unbiased = torch.clamp(biased - n_patch * md_sq, min=0.0)
    return biased, unbiased, valid & (cnt >= MIN_PATCH_SUPPORT)


def per_src_ssd(ctx_pos_rays, cam_src, dst_img, src_img, disparity, radius=SEARCH_WINDOW_RADIUS):
    """Biased & bias-compensated patch SSD maps for one src camera.

    ``ctx_pos_rays`` is (dst_position, planar dst_rays). Returns (biased,
    unbiased, valid), each (H, W).
    """
    dst_position, dst_rays = ctx_pos_rays
    coords, valid = reproject_rays(dst_position, dst_rays, cam_src, disparity, src_img.shape[:2])
    sampled = sampling.bilinear_sample(src_img[..., :3], coords).permute(2, 0, 1)
    biased, unbiased, v = ssd_planar(dst_img[..., :3], sampled[None], valid[None], radius)
    return biased[0], unbiased[0], v[0]


def combine_top2(biased, unbiased, valid, variance):
    """Cross-camera drop-2-worst reduction without a sort (cost.py:229-264).

    biased/unbiased/valid: (N, H, W); variance: (H, W). Keeps the two
    largest biased SSDs (first index wins ties) and subtracts their unbiased
    values from the total: keep = clip(max(count-2, 1), 1, n). Returns
    (cost, confidence); cost is FLT_MAX where no camera counts.
    """
    n = biased.shape[0]
    neg = -FLT_MAX
    b = torch.where(valid, biased, neg)
    u = torch.where(valid, unbiased, 0.0)

    i1 = torch.argmax(b, dim=0, keepdim=True)  # worst source
    u1 = torch.gather(u, 0, i1)[0]
    lane = torch.arange(n, device=b.device)[:, None, None]
    i2 = torch.argmax(torch.where(lane == i1, neg, b), dim=0, keepdim=True)  # second worst
    u2 = torch.gather(u, 0, i2)[0]

    count = valid.sum(dim=0)
    total_u = u[0]
    for i in range(1, n):
        total_u = total_u + u[i]
    min_keep = MIN_OVERLAPPING_CAMS - 1
    keep = torch.clamp(torch.clamp(count - 2, min=min_keep), 1, n)
    drop = count - keep  # 0, 1, or 2
    cost_sum = total_u - torch.where(drop >= 1, u1, 0.0) - torch.where(drop >= 2, u2, 0.0)
    keepf = keep.to(torch.float32)
    confidence = torch.clamp(variance, min=MIN_VAR)
    cost = cost_sum / (keepf * keepf) / confidence

    enough = count >= min_keep
    cost = torch.where(enough, cost, FLT_MAX)
    confidence = torch.where(enough, confidence, 0.0)
    return cost, confidence


def cost_for_disparity(ctx: CostContext, disparity):
    """Cost + confidence maps (D, H, W) of the context's D destinations for a
    (D, H, W) disparity map or a scalar hypothesis. Below FUSED_MIN_PIXELS
    one K1 launch samples all D maps, then K2 runs a map; from there up K3
    runs a map. Each map's result is the bits of its own single-destination
    call."""
    d, _, h, w = ctx.dst_planar.shape
    disp = _disparity_map(disparity, (d, h, w), ctx.dst_planar.device)
    position = ctx.cam_dst.position
    if h * w >= FUSED_MIN_PIXELS:
        out = [warp_cuda.cost_fused(ctx.src_rgba, ctx.src_params, position[i], disp[i], ctx.dst_rays[i],
                                    ctx.dst_planar[i], ctx.variance[i], ctx.exclude_idx[i]) for i in range(d)]
    else:
        sampled, valid = warp_cuda.project_sample(ctx.src_rgba, ctx.src_params, position, disp, ctx.dst_rays)
        out = [warp_cuda.ssd_combine(sampled[i], valid[i], ctx.dst_planar[i], ctx.variance[i], ctx.exclude_idx[i])
               for i in range(d)]
    return torch.stack([c for c, _ in out]), torch.stack([f for _, f in out])


def brute_force_disparity(
    ctx: CostContext,
    min_depth: float,
    max_depth: float,
    fov_mask: torch.Tensor,
    fg_mask: torch.Tensor,
    bg_disparity: torch.Tensor,
    has_fg_masks: bool,
    num_depths: int = NUM_DEPTHS,
):
    """Plane sweep of all D destinations at once: scan ``num_depths``
    hypotheses with a running argmin; the strict ``<`` keeps the first of
    equal costs (cost.py:469-516, Derp.cpp:230-401). The masks and the
    background disparity are (D, H, W). Returns (disparity, cost,
    confidence), each (D, H, W).
    """
    disparities = probe_disparities(num_depths, 1.0 / max_depth, 1.0 / min_depth)
    shape = fov_mask.shape
    dev = ctx.dst_planar.device
    best_cost = torch.full(shape, FLT_MAX, dtype=torch.float32, device=dev)
    # min disparity fallback (Derp.cpp:349)
    best_disp = torch.full(shape, float(disparities[-1]), dtype=torch.float32, device=dev)
    best_conf = torch.zeros(shape, dtype=torch.float32, device=dev)
    for d in disparities.tolist():
        cost, conf = cost_for_disparity(ctx, d)
        # Foreground pixels must be closer than the background (Derp.cpp:240-242)
        if has_fg_masks:
            cost = torch.where(bg_disparity < d, cost, FLT_MAX)
        better = cost < best_cost
        best_cost = torch.where(better, cost, best_cost)
        best_disp = torch.where(better, d, best_disp)
        best_conf = torch.where(better, conf, best_conf)

    # Masking semantics of Derp.cpp:310-321
    disparity = torch.where(fov_mask, best_disp, float("nan"))
    if has_fg_masks:
        disparity = torch.where(fg_mask | ~fov_mask, disparity, bg_disparity)
    cost = torch.where(best_cost == FLT_MAX, float("nan"), best_cost)
    return disparity, cost, best_conf
