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

The default semantics are the JAX package's exact XLA path (no source
windows, no quantization). ``cost_for_disparity`` evaluates all the
destination maps of a level at once through the wrappers of
:mod:`.warp_cuda`: on CUDA tensors the kernels (one K1 launch for all maps
then K2 a map below 512x384, the fused K3 a map from there up), on CPU
tensors their plain twins.

A context that carries the TPU sampler's stack (``src_tpu``, built by
``solver.make_level_context(use_pallas_sampler=True)``) runs the semantics
of the JAX package's Pallas sampler instead, as that package runs on its
own chip: sources quantized to k/256 (:func:`quantize_src`), per-tile
source windows (``window=``, :func:`auto_window`), 1/256-px coordinates
and the clip guard (cost.py:388-431).
"""

from __future__ import annotations

import logging
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

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
# it K1 then K2 (the TPU path's split, PACKED_MIN_PIXELS, cost.py:102-103).
# In the default mode both give the same costs, so the split only decides
# which kernels a level launches; in the TPU sampler's it is the packed
# path's threshold.
FUSED_MIN_PIXELS = 512 * 384

# auto_window's caps on the TPU sampler's window (cost.py:60-64)
WW_CAP = 512
WH_CAP = 88

# The TPU sampler's stack (cost.py:66-95): colors quantized to k/256, and,
# with SRC_STACK_BF16 as well, a stack that stands for a bfloat16 one. The
# port stores it in float32 either way (k/256 values are exact in both), so
# the flag changes only what it changes in the JAX kernels' results: the
# windows' row alignment, 16 in place of 8.
SRC_QUANT_EXACT = True
SRC_STACK_BF16 = False


def quantize_src(planar: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Snap colors to multiples of 1/256 (cost.py:105-111). Values are
    clamped to [0, 1] first, so every result is k/256 with k <= 256, exact
    in bfloat16 and in float32; the JAX function leaves values above 1
    unclamped (a quirk not copied) and equals this on [0, 1] bit for bit."""
    return (torch.round(planar.to(torch.float32).clamp(0.0, 1.0) * 256.0) * (1.0 / 256.0)).to(dtype)


def stack_dtype():
    """The dtype the TPU sampler's stack stands for (cost.py:114-117)."""
    return torch.bfloat16 if (SRC_QUANT_EXACT and SRC_STACK_BF16) else torch.float32


def window_align() -> int:
    """The row alignment of the TPU sampler's windows: 16 for a bfloat16
    stack's (16, 128) tiling, else 8 (warp_pallas.py:942)."""
    return 16 if stack_dtype() == torch.bfloat16 else 8


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
    # the TPU sampler's (N, Hs, Ws, 4) stack (quantize_src'd colors + pad), or
    # None for the default semantics; the windows' row alignment
    src_tpu: torch.Tensor | None = None
    tpu_align: int = 8


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


def reproject_to_src(cam_dst: cam.Camera, cam_src: cam.Camera, disparity, dst_hw, src_hw):
    """Per-pixel src sampling coords for a disparity map (or scalar), on the
    device of the cameras: ((..., H, W, 2) coords in src pixel units,
    (..., H, W) validity). Derp.cpp:144-162 (dstToWorldPoint ->
    worldToSrcPoint); :func:`reproject_rays` with the dst unprojection done
    here (cost.py:148-157)."""
    h, w = dst_hw
    rays = dst_ray_dirs(cam_dst, h, w).permute(2, 0, 1)
    return reproject_rays(cam_dst.position, rays, cam_src, disparity, src_hw)


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
    The patches reach past the border by reflect-101 (:func:`ssd_ringed`
    of the reflected planes). Channel sums run in channel order, as in the
    kernels."""
    def ring(x):
        return F.pad(x, (radius,) * 4, mode="reflect")

    return ssd_ringed(ring(dst_img.permute(2, 0, 1)), ring(sampled_planar), ring(valid.to(dst_img.dtype)) > 0,
                      radius)


def ssd_ringed(dst_planar, sampled_planar, valid, radius=SEARCH_WINDOW_RADIUS):
    """ssd_planar of planes that carry their ``radius``-pixel border:
    dst_planar (C, H + 2r, W + 2r), sampled_planar (N, C, H + 2r, W + 2r),
    valid (N, H + 2r, W + 2r) -> biased, unbiased, valid, each (N, H, W)."""
    n_patch = (2 * radius + 1) ** 2
    diff = torch.where(valid[:, None], dst_planar[None] - sampled_planar, 0.0)  # (N, C, H', W')
    cnt = sampling.box_sum_ringed(valid.to(dst_planar.dtype), radius)
    cnt_safe = torch.clamp(cnt, min=1.0)
    scale = n_patch / cnt_safe
    c = diff.shape[1]
    d2 = diff[:, 0] * diff[:, 0]
    for ch in range(1, c):
        d2 = d2 + diff[:, ch] * diff[:, ch]
    biased = sampling.box_sum_ringed(d2, radius) * scale
    mean_diff = sampling.box_sum_ringed(diff, radius) / cnt_safe[:, None]
    md_sq = mean_diff[:, 0] * mean_diff[:, 0]
    for ch in range(1, c):
        md_sq = md_sq + mean_diff[:, ch] * mean_diff[:, ch]
    unbiased = torch.clamp(biased - n_patch * md_sq, min=0.0)
    core = valid[:, radius:valid.shape[1] - radius, radius:valid.shape[2] - radius]
    return biased, unbiased, core & (cnt >= MIN_PATCH_SUPPORT)


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


def combine_ssds(biased, unbiased, valid, variance):
    """Cross-camera reduction by a sort, the plain form of Derp.cpp:203-225
    (cost.py:200-226): order the sources by biased SSD (a stable sort, so
    equal SSDs keep their index order), average the unbiased SSDs of the
    ``keep = clip(max(count - 2, 1), 1, n)`` best, divide by keep^2 and by
    the confidence max(var, kMinVar).

    biased/unbiased/valid: (N, H, W); variance: (H, W), on one device.
    Returns (cost, confidence), each (H, W); cost is FLT_MAX where fewer
    than kMinOverlappingCams - 1 sources see the point. :func:`combine_top2`
    and the kernel K2 compute it without a sort.
    """
    n = biased.shape[0]
    order = torch.argsort(torch.where(valid, biased, float("inf")), dim=0, stable=True)
    prefix = torch.cumsum(torch.gather(torch.where(valid, unbiased, 0.0), 0, order), dim=0)
    count = valid.sum(dim=0)
    min_keep = MIN_OVERLAPPING_CAMS - 1
    keep = torch.clamp(torch.clamp(count - 2, min=min_keep), 1, n)
    cost_sum = torch.gather(prefix, 0, (keep - 1)[None])[0]
    keepf = keep.to(biased.dtype)
    confidence = torch.clamp(variance, min=MIN_VAR)
    cost = cost_sum / (keepf * keepf) / confidence
    enough = count >= min_keep
    return torch.where(enough, cost, FLT_MAX), torch.where(enough, confidence, 0.0)


def combine_top2(biased, unbiased, valid, variance):
    """Cross-camera drop-2-worst reduction without a sort (cost.py:229-264).

    biased/unbiased/valid: (N, H, W); variance: (H, W). Keeps the two
    largest biased SSDs (first index wins ties) and subtracts their unbiased
    values from the total: keep = clip(max(count-2, 1), 1, n). Returns
    (cost, confidence); cost is FLT_MAX where no camera counts. It equals
    :func:`combine_ssds` up to float32 rounding (a total less two terms
    against a prefix sum) wherever the dropped SSDs are not tied with a
    kept one; on such a tie this drops the first index and the sort the
    last.
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


def auto_window(src_cams, dst_cams, dst_hw, src_hw=None, min_depth: float = 0.5, max_depth: float = 1e4,
                grid: int = 0, y_align: int | None = None):
    """The TPU sampler's window for a rig (cost.py:267-372): the smallest
    aligned (ww, wh) whose span-centred anchor covers the largest per-tile
    span of source coordinates, measured at full destination resolution
    for every (dst, src) pair at the two ends of the sweep, over the dst
    pixels inside the dst's image circle; capped at WW_CAP x WH_CAP (a
    warning names a rig that wants more). ``y_align`` defaults to
    :func:`window_align`; ``grid`` is accepted and ignored, as in the JAX
    package. Plain torch on the cameras' device, one source at a time.
    Returns (ww, wh); SolverConfig(ww_max=, wh_max=) takes them."""
    dst_hw = tuple(dst_hw)
    src_hw = dst_hw if src_hw is None else tuple(src_hw)
    h, w = dst_hw
    th, tw = warp_cuda.V4_TILE_H, warp_cuda.TILE_W
    nt_i, nt_j = -(-h // th), -(-w // tw)
    pad_h, pad_w = nt_i * th - h, nt_j * tw - w
    big = 1e9
    dev = dst_cams.position.device
    srcs, dsts = src_cams.to(dev, torch.float32), dst_cams.to(dev, torch.float32)
    gridn = sampling.pixel_center_grid(h, w, device=dev) / torch.tensor([w, h], dtype=torch.float32, device=dev)

    def tile_span(a, valid):
        def tiles(fill):
            return F.pad(torch.where(valid, a, fill), (0, pad_w, 0, pad_h), value=fill).reshape(nt_i, th, nt_j, tw)

        return float(torch.clamp(tiles(-big).amax(dim=(1, 3)) - tiles(big).amin(dim=(1, 3)), min=0.0).max())

    span_x = span_y = 0.0
    for di in range(dsts.position.shape[0]):
        cdst = dsts.index(di)
        rays = dst_ray_dirs(cdst, h, w).permute(2, 0, 1)
        in_circle = ~cam.is_outside_image_circle(cdst, gridn * cdst.resolution)
        for d in (1.0 / max_depth, 1.0 / min_depth):
            for si in range(srcs.position.shape[0]):
                coords, valid = reproject_rays(cdst.position, rays, srcs.index(si), d, src_hw)
                valid = valid & in_circle
                span_x = max(span_x, tile_span(coords[..., 0], valid))
                span_y = max(span_y, tile_span(coords[..., 1], valid))

    ay = window_align() if y_align is None else y_align
    wh_cap = -(-WH_CAP // ay) * ay
    ww = 256 if span_x <= 192.0 else 128 * math.ceil((span_x + 130.0) / 128.0)
    wh = 40 if span_y <= 36.0 else ay * math.ceil((span_y + 2.0 + ay) / ay)
    ww_c, wh_c = min(max(ww, 256), WW_CAP), min(max(wh, 40), wh_cap)
    if ww > ww_c or wh > wh_c:
        logging.getLogger(__name__).warning(
            "auto_window: computed window %dx%d exceeds cap %dx%d "
            "(max tile span %.0fx%.0f px); sampler clipping may degrade "
            "coverage on this rig", ww, wh, ww_c, wh_c, span_x, span_y)
    return ww_c, wh_c


def cost_for_disparity(ctx: CostContext, disparity, window=None):
    """Cost + confidence maps (D, H, W) of the context's D destinations for a
    (D, H, W) disparity map or a scalar hypothesis. Below FUSED_MIN_PIXELS
    one K1 launch samples all D maps, then K2 runs a map; from there up K3
    runs a map. Each map's result is the bits of its own single-destination
    call. A context with the TPU sampler's stack takes its path
    (:func:`_cost_tpu`) through windows of ``window`` = (ww_max, wh_max)
    (None: the defaults); the default path has no windows and ignores it."""
    d, _, h, w = ctx.dst_planar.shape
    disp = _disparity_map(disparity, (d, h, w), ctx.dst_planar.device)
    if ctx.src_tpu is not None:
        return _cost_tpu(ctx, disp, window)
    position = ctx.cam_dst.position
    if h * w >= FUSED_MIN_PIXELS:
        out = [warp_cuda.cost_fused(ctx.src_rgba, ctx.src_params, position[i], disp[i], ctx.dst_rays[i],
                                    ctx.dst_planar[i], ctx.variance[i], ctx.exclude_idx[i]) for i in range(d)]
    else:
        sampled, valid = warp_cuda.project_sample(ctx.src_rgba, ctx.src_params, position, disp, ctx.dst_rays)
        out = [warp_cuda.ssd_combine(sampled[i], valid[i], ctx.dst_planar[i], ctx.variance[i], ctx.exclude_idx[i])
               for i in range(d)]
    return torch.stack([c for c, _ in out]), torch.stack([f for _, f in out])


def _cost_tpu(ctx: CostContext, disp, window):
    """cost_for_disparity through the TPU sampler (cost.py:388-431): one
    anchor launch for all D maps, then from FUSED_MIN_PIXELS up the packed
    path (reflect-padded tiles), one K3 launch a map; below it one K1
    launch for all D maps, K2 a map, and FLT_MAX where a non-self source
    clips the pixel (the guard the JAX package applies after its K2)."""
    d, _, h, w = ctx.dst_planar.shape
    src_hw = tuple(ctx.src_tpu.shape[1:3])
    pos, rays, params, align = ctx.cam_dst.position, ctx.dst_rays, ctx.src_params, ctx.tpu_align
    fused = h * w >= FUSED_MIN_PIXELS
    anchors = warp_cuda.tile_windows(params, pos, disp, rays, src_hw, window, align, reflect=fused)
    if fused:
        out = [warp_cuda.cost_fused_tpu(ctx.src_tpu, params, pos[i], disp[i], rays[i], ctx.dst_planar[i],
                                        ctx.variance[i], ctx.exclude_idx[i], anchors[i], window, align)
               for i in range(d)]
    else:
        sampled, valid, clipped = warp_cuda.project_sample_tpu(ctx.src_tpu, params, pos, disp, rays, anchors,
                                                               window, align)
        lanes = torch.arange(params.shape[0], device=disp.device)[:, None, None]
        out = []
        for i in range(d):
            cost, conf = warp_cuda.ssd_combine(sampled[i], valid[i], ctx.dst_planar[i], ctx.variance[i],
                                               ctx.exclude_idx[i])
            any_clip = (clipped[i] & (lanes != ctx.exclude_idx[i])).any(dim=0)
            out.append((torch.where(any_clip, FLT_MAX, cost), conf))
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
    window=None,
):
    """Plane sweep of all D destinations at once: scan ``num_depths``
    hypotheses with a running argmin; the strict ``<`` keeps the first of
    equal costs (cost.py:469-516, Derp.cpp:230-401). The masks and the
    background disparity are (D, H, W). Returns (disparity, cost,
    confidence), each (D, H, W). ``window`` as for cost_for_disparity.
    """
    disparities = probe_disparities(num_depths, 1.0 / max_depth, 1.0 / min_depth)
    shape = fov_mask.shape
    dev = ctx.dst_planar.device
    best_cost = torch.full(shape, FLT_MAX, dtype=torch.float32, device=dev)
    # min disparity fallback (Derp.cpp:349)
    best_disp = torch.full(shape, float(disparities[-1]), dtype=torch.float32, device=dev)
    best_conf = torch.zeros(shape, dtype=torch.float32, device=dev)
    for d in disparities.tolist():
        cost, conf = cost_for_disparity(ctx, d, window=window)
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
