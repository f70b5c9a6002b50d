"""Per-level disparity solver: the port of ``depth/solver.py``.

The reference's processLevel (``depth_estimation/Derp.cpp:1005-1034``) per
pyramid level:

  brute force (coarsest only) -> randomProposals -> pingPongPropagation ->
  handleDisparityMismatches -> bilateralFilter -> medianFilter -> maskFov

Every stage runs over whole destination maps on the context's device, one
destination camera at a time; the matching cost of each candidate map is one
:func:`..ops.cost.cost_for_disparity` call, which is where the CUDA kernels
run.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import camera as cam
from ..ops import cost as cost_ops
from ..ops import filters, sampling, warp_cuda
from ..ops.cost import CostContext


class LevelContext(NamedTuple):
    """Device-resident state for one (frame, level). Rays and the sampling
    stack are channel-planar, the layout the kernels read."""

    src_cams: cam.Camera  # stacked (N,), normalized, float32
    dst_cams: cam.Camera  # stacked (D,), normalized, float32
    dst2src: tuple  # (D,) int: each dst camera's index among the sources
    src_imgs: torch.Tensor  # (N, H, W, 3) float32 [0,1]
    src_planar: torch.Tensor  # (N, 3, H, W) the same colors, channel-planar
    src_params: torch.Tensor  # (N, 24) packed source cameras
    src_variance: torch.Tensor  # (N, H, W)
    dst_fov_masks: torch.Tensor  # (D, H, W) bool
    dst_fg_masks: torch.Tensor  # (D, H, W) bool
    dst_bg_disp: torch.Tensor  # (D, H, W)
    var_noise_floor: float  # level-scaled, a float32 value (PyramidLevel.h:232-236)
    var_high_thresh: float  # a float32 value
    dst_rays: torch.Tensor  # (D, 3, H, W) dst pixel ray dirs, NaN outside the FOV


class SolverConfig(NamedTuple):
    """Static solve parameters."""

    min_depth: float = 0.5
    max_depth: float = 1e4
    num_random_proposals: int = 2
    ping_pong_iterations: int = 1
    mismatches_start_level: int = -1
    do_bilateral_filter: bool = True
    do_median_filter: bool = True
    has_fg_masks: bool = False
    level: int = 0
    num_levels: int = 1
    # drop the four long-range (+/-2, +/-2) diagonals of the PatchMatch star
    # (solver.py:76-85); False = the reference-shaped template
    star_axis_only: bool = False


def _f32(x: float) -> float:
    return float(np.float32(x))


def make_level_context(
    rig_src: cam.Rig,
    rig_dst: cam.Rig,
    src_imgs: torch.Tensor,
    dst_fov_masks: torch.Tensor,
    dst_fg_masks=None,
    dst_bg_disp=None,
    var_noise_floor=4e-5,
    var_high_thresh=1e-3,
    full_height=None,
) -> LevelContext:
    """Build the device context on ``src_imgs``' device (computes per-src
    variance; PyramidLevel.h:232-247)."""
    src_imgs = src_imgs.to(torch.float32)
    dev = src_imgs.device
    n, h, w = src_imgs.shape[:3]
    d = len(rig_dst.ids)
    if dst_fg_masks is None:
        dst_fg_masks = torch.ones((d, h, w), dtype=torch.bool, device=dev)
    if dst_bg_disp is None:
        dst_bg_disp = torch.zeros((d, h, w), dtype=torch.float32, device=dev)
    full_height = full_height if full_height is not None else h
    # the variance noise floor scales with (level width / full height)^2
    scale = w / float(full_height)
    floor = max(var_noise_floor * scale * scale, cost_ops.MIN_VAR)

    src_cams = rig_src.cameras.to(dev, torch.float32)
    dst_cams = rig_dst.cameras.to(dev, torch.float32)
    dst_fov = dst_fov_masks.to(device=dev, dtype=torch.bool)
    # the dst unprojection is disparity-independent: hoisted out of every
    # cost evaluation. NaN rays outside the dst FOV make those pixels
    # invalid for every source (mask_fov discards them anyway).
    rays = cost_ops.dst_ray_dirs(dst_cams, h, w)
    rays = torch.where(dst_fov[..., None], rays, float("nan"))
    src_planar = src_imgs[..., :3].permute(0, 3, 1, 2).contiguous()
    return LevelContext(
        src_cams=src_cams,
        dst_cams=dst_cams,
        dst2src=tuple(int(i) for i in cam.map_src_to_dst_indexes(rig_src, rig_dst)),
        src_imgs=src_imgs,
        src_planar=src_planar,
        src_params=warp_cuda.pack_camera_params(src_cams),
        src_variance=sampling.rgb_variance(src_imgs),
        dst_fov_masks=dst_fov,
        dst_fg_masks=dst_fg_masks.to(device=dev, dtype=torch.bool),
        dst_bg_disp=dst_bg_disp.to(device=dev, dtype=torch.float32),
        var_noise_floor=_f32(floor),
        var_high_thresh=_f32(var_high_thresh),
        dst_rays=rays.permute(0, 3, 1, 2).contiguous(),
    )


def _cost_ctx(ctx: LevelContext, dst_idx: int) -> CostContext:
    src_idx = ctx.dst2src[dst_idx]
    return CostContext(
        cam_dst=ctx.dst_cams.index(dst_idx),
        src_params=ctx.src_params,
        dst_planar=ctx.src_planar[src_idx],
        src_planar=ctx.src_planar,
        variance=ctx.src_variance[src_idx],
        exclude_idx=src_idx,
        dst_rays=ctx.dst_rays[dst_idx],
    )


def _stack(per_dst):
    """List over dst cameras of tuples of maps -> tuple of stacked maps."""
    return tuple(torch.stack(maps) for maps in zip(*per_dst))


def brute_force_all(ctx: LevelContext, cfg: SolverConfig):
    """Coarsest-level initialization for every dst camera (Derp.cpp:384-401)."""
    return _stack(
        cost_ops.brute_force_disparity(
            _cost_ctx(ctx, i),
            cfg.min_depth,
            cfg.max_depth,
            ctx.dst_fov_masks[i],
            ctx.dst_fg_masks[i],
            ctx.dst_bg_disp[i],
            cfg.has_fg_masks,
        )
        for i in range(len(ctx.dst2src))
    )


def random_proposals(ctx: LevelContext, cfg: SolverConfig, disparity, costs, confidences,
                     uniforms=None, generator=None):
    """Per-pixel randomized refinement (Derp.cpp:750-873). Each proposal
    draws a uniform disparity within +/- amplitude around the current one;
    accepted proposals halve the pixel's amplitude.

    ``uniforms`` (D, P, H, W) in [0, 1) supplies the draws (tests feed the
    JAX package's threefry draws); without it they come from ``generator``.
    """
    if cfg.num_random_proposals <= 0:
        return disparity, costs, confidences
    d, h, w = disparity.shape
    dev = disparity.device
    if uniforms is None and generator is None:
        raise ValueError("random_proposals needs uniforms or a generator")

    max_disp = 1.0 / cfg.min_depth
    var_high_dev = np.float32(cost_ops.RANDOM_PROP_HIGH_VAR_DEVIATION) * np.float32(ctx.var_high_thresh)
    var_thresh = float(max(var_high_dev, np.float32(ctx.var_noise_floor)))

    out = []
    for i in range(d):
        cctx = _cost_ctx(ctx, i)
        fov, fg, bg = ctx.dst_fov_masks[i], ctx.dst_fg_masks[i], ctx.dst_bg_disp[i]
        disp0 = disparity[i]
        min_disp = bg if cfg.has_fg_masks else torch.full_like(bg, 1.0 / cfg.max_depth)
        active = fov & fg & (cctx.variance >= var_thresh)
        cost0, conf0 = cost_ops.cost_for_disparity(cctx, disp0)
        cost_thresh = torch.clamp(0.5 * cost0, max=cost_ops.RANDOM_PROP_MAX_COST)
        disp, cost, conf = disp0, cost0, conf0
        amp = (max_disp - min_disp) / 2.0
        draws = (uniforms[i] if uniforms is not None else
                 torch.rand((cfg.num_random_proposals, h, w), generator=generator, device=dev))
        for k in range(cfg.num_random_proposals):
            lo = torch.maximum(min_disp, disp - amp)
            hi = torch.clamp(disp + amp, max=max_disp)
            prop = lo + draws[k].to(dev) * (hi - lo)
            pcost, pconf = cost_ops.cost_for_disparity(cctx, torch.where(active, prop, disp))
            accept = active & (pcost < cost) & (pcost < cost_thresh)
            disp = torch.where(accept, prop, disp)
            cost = torch.where(accept, pcost, cost)
            conf = torch.where(accept, pconf, conf)
            amp = torch.where(accept, amp / 2.0, amp)
        disp = torch.where(active, disp, disp0)
        if cfg.has_fg_masks:
            disp = torch.where(fg | ~fov, disp, bg)
        out.append((disp, torch.where(active, cost, cost0), torch.where(active, conf, conf0)))
    return _stack(out)


# PatchMatch star template (DerpUtil.h:34-43)
PING_PONG_OFFSETS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (-2, -2), (2, -2), (-2, 2), (2, 2))


def ping_pong(ctx: LevelContext, cfg: SolverConfig, disparity, costs, confidences):
    """Jacobi spatial propagation: evaluate the star-template candidate
    disparity maps and keep the best per pixel (Derp.cpp:403-551)."""
    if cfg.ping_pong_iterations <= 0:
        return disparity, costs, confidences
    # the center candidate re-evaluates the pixel's own disparity, whose cost
    # the carry already holds once random proposals ran (solver.py:278-294)
    seed_center = cfg.num_random_proposals > 0
    offsets = PING_PONG_OFFSETS[1:] if seed_center else PING_PONG_OFFSETS
    if cfg.star_axis_only:
        offsets = tuple(o for o in offsets if max(abs(o[0]), abs(o[1])) <= 1)

    out = []
    for i in range(disparity.shape[0]):
        cctx = _cost_ctx(ctx, i)
        fov, fg, bg = ctx.dst_fov_masks[i], ctx.dst_fg_masks[i], ctx.dst_bg_disp[i]
        active = fov & fg & (cctx.variance >= ctx.var_noise_floor)
        bg_floor = bg if cfg.has_fg_masks else torch.zeros_like(bg)
        disp, cost, conf = disparity[i], costs[i], confidences[i]
        for _ in range(cfg.ping_pong_iterations):
            if seed_center:
                center_ok = fov & (disp >= bg_floor) & torch.isfinite(disp)
                best_cost = torch.where(center_ok, cost, math.inf)
            else:
                best_cost = torch.full_like(cost, math.inf)
            best_disp, best_conf = disp, conf
            for dy, dx in offsets:
                cand = filters._shift(disp, dy, dx)
                ok = filters._shift(fov, dy, dx) & (cand >= bg_floor) & torch.isfinite(cand)
                ccost, cconf = cost_ops.cost_for_disparity(cctx, torch.where(ok, cand, disp))
                ccost = torch.where(ok, ccost, math.inf)
                better = ccost < best_cost
                best_cost = torch.where(better, ccost, best_cost)
                best_disp = torch.where(better, cand, best_disp)
                best_conf = torch.where(better, cconf, best_conf)
            disp = torch.where(active, best_disp, disp)
            cost = torch.where(active, best_cost, cost)
            conf = torch.where(active, best_conf, conf)
        if cfg.has_fg_masks:
            disp = torch.where(fg | ~fov, disp, bg)
        out.append((disp, cost, conf))
    return _stack(out)


def handle_mismatches(ctx: LevelContext, cfg: SolverConfig, disparity, full_disparity=None):
    """Cross-camera consistency (Derp.cpp:553-748), the XLA branch of
    solver.py:388-396: project each dst pixel's depth into every other
    camera's disparity map (K1 with one channel); with no agreeing camera,
    replace it by the median of the farther mismatched disparities.

    Requires all cameras as destinations. Returns (new disparity, mismatch mask).
    """
    disparity = disparity.to(torch.float32)
    full_disparity = disparity if full_disparity is None else full_disparity.to(torch.float32)
    n = ctx.src_imgs.shape[0]
    if full_disparity.shape[0] != n:
        raise ValueError(f"need every source's disparity: {tuple(full_disparity.shape)} vs {n} sources")
    frac = 0.1  # kFractionChange, Derp.cpp:594
    disp_stack = full_disparity[:, None].contiguous()  # (N, 1, H, W)
    lanes = torch.arange(n, device=disparity.device)[:, None, None]

    new, masks = [], []
    for i in range(disparity.shape[0]):
        src_idx = ctx.dst2src[i]
        disp = disparity[i]
        fov, fg = ctx.dst_fov_masks[i], ctx.dst_fg_masks[i]
        variance = ctx.src_variance[src_idx]
        sampled, valid = warp_cuda.project_sample(
            disp_stack, ctx.src_params, ctx.dst_cams.position[i], disp.contiguous(), ctx.dst_rays[i])
        d_srcs = sampled[:, 0]
        valids = valid & (lanes != src_idx) & torch.isfinite(d_srcs)
        lo, hi = (1 - frac) * disp, (1 + frac) * disp
        is_match = valids & (d_srcs >= lo) & (d_srcs <= hi)
        is_mismatch = valids & ~is_match
        num_match = is_match.sum(dim=0)
        total = num_match + is_mismatch.sum(dim=0)

        # median of the mismatched disparities, counted from the far end
        # (updateDstDisparityAndMismatchMask, Derp.cpp:605-652)
        mm_sorted = torch.sort(torch.where(is_mismatch, d_srcs, math.inf), dim=0).values
        closer = (is_mismatch & (d_srcs < disp)).sum(dim=0)
        median_idx = torch.clamp(closer // 2, 0, n - 1)
        median_val = torch.gather(mm_sorted, 0, median_idx[None])[0]

        keep = (
            (total == 0)
            | (num_match >= cost_ops.MIN_OVERLAPPING_CAMS - 1)
            | (variance > ctx.var_high_thresh)
            | (variance < ctx.var_noise_floor)
        )
        replace = ~keep & fov & fg
        new.append(torch.where(replace, torch.minimum(disp, median_val), disp))
        masks.append(replace)
    return torch.stack(new), torch.stack(masks)


def spatial_bilateral(ctx: LevelContext, cfg: SolverConfig, disparity):
    """Color-guided joint bilateral on disparity; the radius shrinks coarse
    to fine by kLevelScale (Derp.cpp:875-902)."""
    scale = cost_ops.LEVEL_SCALE ** cfg.level
    radius = max(math.ceil(filters.BILATERAL_SPACE_RADIUS_MAX * scale), filters.BILATERAL_SPACE_RADIUS_MIN)
    out = []
    for i in range(disparity.shape[0]):
        color = ctx.src_imgs[ctx.dst2src[i]]
        mask = ctx.dst_fov_masks[i] & ctx.dst_fg_masks[i]
        filtered = filters.joint_bilateral(disparity[i], color[..., :3], mask, radius)
        out.append(torch.where(ctx.dst_fg_masks[i], filtered, disparity[i]))
    return torch.stack(out)


def median_filter(ctx: LevelContext, cfg: SolverConfig, disparity):
    """Masked median blur, radius 1, background-aware (Derp.cpp:904-920)."""
    return torch.stack([
        filters.masked_median(
            disparity[i],
            ctx.dst_bg_disp[i] if cfg.has_fg_masks else None,
            ctx.dst_fov_masks[i] & ctx.dst_fg_masks[i],
            radius=1,
        )
        for i in range(disparity.shape[0])
    ])


def mask_fov(ctx: LevelContext, disparity):
    """NaN outside the FOV (Derp.cpp:940-951)."""
    return torch.where(ctx.dst_fov_masks, disparity, float("nan"))


def process_level(ctx: LevelContext, cfg: SolverConfig, init_disparity=None, uniforms=None,
                  generator=None):
    """Full per-level pipeline (Derp.cpp:1005-1034; solver.py:474-506).

    ``init_disparity`` is the upsampled coarser-level result (None at the
    coarsest level). The random proposals draw ``uniforms`` when given,
    else from ``generator``, else from a generator seeded with the level.
    Returns a dict of (D, H, W) disparity/cost/confidence/mismatch maps.
    """
    d = len(ctx.dst2src)
    h, w = ctx.src_imgs.shape[1:3]
    dev = ctx.src_imgs.device
    coarsest = cfg.level == cfg.num_levels - 1
    if coarsest or init_disparity is None:
        disparity, costs, confidences = brute_force_all(ctx, cfg)
    else:
        disparity = init_disparity.to(device=dev, dtype=torch.float32)
        costs = torch.full((d, h, w), math.inf, dtype=torch.float32, device=dev)
        confidences = torch.zeros((d, h, w), dtype=torch.float32, device=dev)

    mismatch_mask = torch.zeros((d, h, w), dtype=torch.bool, device=dev)
    if not coarsest:
        if uniforms is None and generator is None:
            generator = torch.Generator(device=dev).manual_seed(cfg.level)
        disparity, costs, confidences = random_proposals(
            ctx, cfg, disparity, costs, confidences, uniforms=uniforms, generator=generator)
        disparity, costs, confidences = ping_pong(ctx, cfg, disparity, costs, confidences)
        if 0 <= cfg.level <= cfg.mismatches_start_level:
            disparity, mismatch_mask = handle_mismatches(ctx, cfg, disparity)

    if cfg.do_bilateral_filter:
        disparity = spatial_bilateral(ctx, cfg, disparity)
    if cfg.do_median_filter:
        disparity = median_filter(ctx, cfg, disparity)
    return {
        "disparity": mask_fov(ctx, disparity),
        "cost": costs,
        "confidence": confidences,
        "mismatches": mismatch_mask,
    }
