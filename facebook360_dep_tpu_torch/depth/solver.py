"""Per-level disparity solver: the port of ``depth/solver.py``.

The reference's processLevel (``depth_estimation/Derp.cpp:1005-1034``) per
pyramid level:

  brute force (coarsest only) -> randomProposals -> pingPongPropagation ->
  handleDisparityMismatches -> bilateralFilter -> medianFilter -> maskFov

Every stage runs over whole destination maps on the context's device. The
stages that evaluate costs or sample the other cameras (brute force, random
proposals, ping-pong, mismatches) take all destination cameras at once, as
the JAX package's ``lax.map`` over them: the matching cost of each set of
candidate maps is one :func:`..ops.cost.cost_for_disparity` call, which is
where the CUDA kernels run, and the mismatch stage samples every map in one
K1 launch. Each batched stage gives the bits of the same stage run on each
destination alone. The bilateral filters all destinations in one launch
of its kernel; the median filter still runs one destination at a time.

A context built with ``use_pallas_sampler=True`` carries the TPU sampler's
stack, and every stage that samples the sources then runs the semantics of
the JAX package's Pallas sampler (per-tile windows of
``SolverConfig.ww_max`` x ``wh_max``, quantized sources and coordinates,
the clip guard), as the JAX package runs on its own chip.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import camera as cam
from ..core.spans import span
from ..ops import cost as cost_ops
from ..ops import filters, sampling, warp_cuda
from ..ops.cost import CostContext


class LevelContext(NamedTuple):
    """Device-resident state for one (frame, level), in the layouts the
    kernels read."""

    src_cams: cam.Camera  # stacked (N,), normalized, float32
    dst_cams: cam.Camera  # stacked (D,), normalized, float32
    dst2src: tuple  # (D,) int: each dst camera's index among the sources
    src_imgs: torch.Tensor  # (N, H, W, 3) float32 [0,1]
    src_rgba: torch.Tensor  # (N, H, W, 4) the same colors + pad (warp_cuda.rgba_stack): what K1 and K3 read
    src_params: torch.Tensor  # (N, 24) packed source cameras
    src_variance: torch.Tensor  # (N, H, W)
    dst_planar: torch.Tensor  # (D, 3, H, W) each dst camera's colors, contiguous
    dst_variance: torch.Tensor  # (D, H, W)
    dst_fov_masks: torch.Tensor  # (D, H, W) bool
    dst_fg_masks: torch.Tensor  # (D, H, W) bool
    dst_bg_disp: torch.Tensor  # (D, H, W)
    var_noise_floor: float  # level-scaled, a float32 value (PyramidLevel.h:232-236)
    var_high_thresh: float  # a float32 value
    dst_rays: torch.Tensor  # (D, 3, H, W) dst pixel ray dirs, NaN outside the FOV
    # a rank's block of a level (make_level_context(destinations=)): the
    # indices of the destinations it holds among the level's, and the level's
    # whole dst2src; None for a context that is the whole level
    dst_index: tuple | None = None
    level_dst2src: tuple | None = None
    # the TPU sampler's (N, H, W, 4) stack (make_level_context(use_pallas_sampler=True))
    # and its windows' row alignment; None: the default semantics
    src_tpu: torch.Tensor | None = None
    tpu_align: int = 8


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
    # the TPU sampler's window (cost.auto_window; None: its defaults), read
    # only on a context built with use_pallas_sampler=True
    ww_max: int | None = None
    wh_max: int | None = None
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
    use_pallas_sampler: bool | None = None,
    destinations=None,
) -> LevelContext:
    """Build the device context on ``src_imgs``' device (computes per-src
    variance; PyramidLevel.h:232-247).

    ``use_pallas_sampler`` adds the TPU sampler's stack (the colors
    quantized by cost.quantize_src when cost.SRC_QUANT_EXACT), so the solve
    runs the JAX package's Pallas semantics; None or False keeps the exact
    XLA path. ``destinations`` (indices into ``rig_dst``) builds the context
    of those destinations only, as a rank of a sharded solve holds its block
    (parallel/sharding.py): their cameras, rays, colors, variance and masks,
    with dst2src into the full source list; the masks and background
    disparity given may hold every destination of ``rig_dst`` or just
    those."""
    src_imgs = src_imgs.to(torch.float32)
    dev = src_imgs.device
    n, h, w = src_imgs.shape[:3]
    level_dst2src = tuple(int(i) for i in cam.map_src_to_dst_indexes(rig_src, rig_dst))
    idx = list(range(len(level_dst2src))) if destinations is None else [int(i) for i in destinations]
    d = len(idx)
    block = destinations is not None

    def own(x):  # the held destinations' rows of an input given for every destination
        return x[idx] if block and x.shape[0] == len(level_dst2src) else x

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
    if block:
        dst_cams = dst_cams.index(torch.tensor(idx, dtype=torch.long, device=dev))
    dst_fov = own(dst_fov_masks).to(device=dev, dtype=torch.bool)
    # the dst unprojection is disparity-independent: hoisted out of every
    # cost evaluation. NaN rays outside the dst FOV make those pixels
    # invalid for every source (mask_fov discards them anyway).
    rays = cost_ops.dst_ray_dirs(dst_cams, h, w)
    rays = torch.where(dst_fov[..., None], rays, float("nan"))
    dst2src = tuple(level_dst2src[i] for i in idx)
    return LevelContext(
        src_cams=src_cams,
        dst_cams=dst_cams,
        dst2src=dst2src,
        **_image_fields(src_imgs, dst2src, bool(use_pallas_sampler)),
        src_params=warp_cuda.pack_camera_params(src_cams),
        dst_fov_masks=dst_fov,
        dst_fg_masks=own(dst_fg_masks).to(device=dev, dtype=torch.bool),
        dst_bg_disp=own(dst_bg_disp).to(device=dev, dtype=torch.float32),
        var_noise_floor=_f32(floor),
        var_high_thresh=_f32(var_high_thresh),
        dst_rays=rays.permute(0, 3, 1, 2).contiguous(),
        dst_index=tuple(idx) if block else None,
        level_dst2src=level_dst2src if block else None,
        tpu_align=cost_ops.window_align(),
    )


def _image_fields(src_imgs: torch.Tensor, dst2src: tuple, tpu: bool) -> dict:
    """Every field of a level context that depends on the colors: the
    sources' stacks and variance, the destinations' colors and variance
    taken from them, and with ``tpu`` the TPU sampler's stack (the JAX
    package's src_imgs_t, solver.py:145-166: quantized to k/256 under
    cost.SRC_QUANT_EXACT; float32 storage, see cost.SRC_STACK_BF16, in
    warp_cuda.rgba_stack's layout)."""
    src_rgba = warp_cuda.rgba_stack(src_imgs)
    # source by source into the stacks: the windowed sums' temporaries of
    # one image, not of all N (the same bits: each source's sums are its own)
    src_variance = torch.empty(src_imgs.shape[:3], dtype=torch.float32, device=src_imgs.device)
    src_tpu = torch.zeros_like(src_rgba) if tpu else None
    for i, img in enumerate(src_imgs):
        src_variance[i] = sampling.rgb_variance(img)
        if tpu:
            src_tpu[i, ..., :3] = cost_ops.quantize_src(img[..., :3]) if cost_ops.SRC_QUANT_EXACT else img[..., :3]
    return dict(
        src_imgs=src_imgs,
        src_rgba=src_rgba,
        src_variance=src_variance,
        dst_planar=warp_cuda.planar_view(src_rgba)[list(dst2src)].contiguous(),
        dst_variance=src_variance[list(dst2src)],
        src_tpu=src_tpu,
    )


def with_images(ctx: LevelContext, src_imgs: torch.Tensor) -> LevelContext:
    """The context of another frame of the same rig and level: ``src_imgs``
    (N, H, W, 3) replace every field that depends on the colors, the
    destinations' included (only those the context holds, and the TPU
    sampler's stack where it has one); cameras, masks and rays stay."""
    src_imgs = src_imgs.to(device=ctx.src_imgs.device, dtype=torch.float32)
    if src_imgs.shape != ctx.src_imgs.shape:
        raise ValueError(f"frame colors {tuple(src_imgs.shape)} vs the context's {tuple(ctx.src_imgs.shape)}")
    return ctx._replace(**_image_fields(src_imgs, ctx.dst2src, ctx.src_tpu is not None))


def select_destinations(ctx: LevelContext, dsts) -> LevelContext:
    """The level context of the dst cameras ``dsts`` (indices into them, in
    the order given), with the same sources: a level of those
    destinations."""
    idx = list(dsts)
    return ctx._replace(
        dst_index=None, level_dst2src=None,
        dst_cams=ctx.dst_cams.index(torch.as_tensor(idx, dtype=torch.long, device=ctx.dst_rays.device)),
        dst2src=tuple(ctx.dst2src[i] for i in idx),
        **{f: getattr(ctx, f)[idx] for f in ("dst_planar", "dst_variance", "dst_fov_masks", "dst_fg_masks",
                                             "dst_bg_disp", "dst_rays")},
    )


def level_destinations(ctx: LevelContext) -> tuple[tuple, tuple]:
    """(the indices of the destinations the context holds among its
    level's, the level's whole dst2src)."""
    if ctx.dst_index is None:
        return tuple(range(len(ctx.dst2src))), ctx.dst2src
    return ctx.dst_index, ctx.level_dst2src


def cost_context(ctx: LevelContext) -> CostContext:
    """The cost context of all the level's dst cameras (no copy)."""
    return CostContext(
        cam_dst=ctx.dst_cams, src_params=ctx.src_params, dst_planar=ctx.dst_planar, variance=ctx.dst_variance,
        exclude_idx=ctx.dst2src, dst_rays=ctx.dst_rays, src_rgba=ctx.src_rgba, src_tpu=ctx.src_tpu,
        tpu_align=ctx.tpu_align)


def _window(cfg: SolverConfig):
    """The TPU sampler's window of the config, None for its defaults (solver.py:182-183)."""
    return (cfg.ww_max, cfg.wh_max) if (cfg.ww_max or cfg.wh_max) else None


def brute_force_all(ctx: LevelContext, cfg: SolverConfig):
    """Coarsest-level initialization of every dst camera at once (Derp.cpp:384-401)."""
    return cost_ops.brute_force_disparity(
        cost_context(ctx), cfg.min_depth, cfg.max_depth, ctx.dst_fov_masks, ctx.dst_fg_masks, ctx.dst_bg_disp,
        cfg.has_fg_masks, window=_window(cfg))


def level_generator(cfg: SolverConfig, device) -> torch.Generator:
    """The generator of a level's random proposals when the caller gives
    none: seeded with the level, so every frame of a level draws alike."""
    return torch.Generator(device=device).manual_seed(cfg.level)


def draw_uniforms(generator: torch.Generator, d: int, p: int, h: int, w: int, keep=None) -> torch.Tensor:
    """(D, P, H, W) proposal draws in [0, 1) on ``generator``'s device: one
    (P, H, W) draw a destination, in destination order, so destination j
    draws the same whichever destinations a caller keeps. ``keep`` (a range
    of destinations) keeps only those: the draws up to its end are made one
    at a time and the others dropped as they come, so no more than one
    draw beyond the kept ones is held."""
    kept = range(d) if keep is None else keep
    out = []
    for j in range(kept.stop):
        u = torch.rand((p, h, w), generator=generator, device=generator.device)
        if j in kept:
            out.append(u)
    return torch.stack(out)


def random_proposals(ctx: LevelContext, cfg: SolverConfig, disparity, costs, confidences,
                     uniforms=None, generator=None):
    """Per-pixel randomized refinement of every dst camera at once
    (Derp.cpp:750-873). Each proposal draws a uniform disparity within +/-
    amplitude around the current one; accepted proposals halve the pixel's
    amplitude.

    ``uniforms`` (D, P, H, W) in [0, 1) supplies the draws (tests feed the
    JAX package's threefry draws); without it they come from ``generator``
    (:func:`draw_uniforms`).
    """
    if cfg.num_random_proposals <= 0:
        return disparity, costs, confidences
    d, h, w = disparity.shape
    dev = disparity.device
    if uniforms is None and generator is None:
        raise ValueError("random_proposals needs uniforms or a generator")
    if uniforms is None:
        uniforms = draw_uniforms(generator, d, cfg.num_random_proposals, h, w)

    max_disp = 1.0 / cfg.min_depth
    var_high_dev = np.float32(cost_ops.RANDOM_PROP_HIGH_VAR_DEVIATION) * np.float32(ctx.var_high_thresh)
    var_thresh = float(max(var_high_dev, np.float32(ctx.var_noise_floor)))

    cctx = cost_context(ctx)
    fov, fg, bg = ctx.dst_fov_masks, ctx.dst_fg_masks, ctx.dst_bg_disp
    min_disp = bg if cfg.has_fg_masks else torch.full_like(bg, 1.0 / cfg.max_depth)
    active = fov & fg & (ctx.dst_variance >= var_thresh)
    window = _window(cfg)
    cost0, conf0 = cost_ops.cost_for_disparity(cctx, disparity, window)
    cost_thresh = torch.clamp(0.5 * cost0, max=cost_ops.RANDOM_PROP_MAX_COST)
    disp, cost, conf = disparity, cost0, conf0
    amp = (max_disp - min_disp) / 2.0
    for k in range(cfg.num_random_proposals):
        lo = torch.maximum(min_disp, disp - amp)
        hi = torch.clamp(disp + amp, max=max_disp)
        prop = lo + uniforms[:, k].to(dev) * (hi - lo)
        pcost, pconf = cost_ops.cost_for_disparity(cctx, torch.where(active, prop, disp), window)
        accept = active & (pcost < cost) & (pcost < cost_thresh)
        disp = torch.where(accept, prop, disp)
        cost = torch.where(accept, pcost, cost)
        conf = torch.where(accept, pconf, conf)
        amp = torch.where(accept, amp / 2.0, amp)
    disp = torch.where(active, disp, disparity)
    if cfg.has_fg_masks:
        disp = torch.where(fg | ~fov, disp, bg)
    return disp, torch.where(active, cost, cost0), torch.where(active, conf, conf0)


# PatchMatch star template (DerpUtil.h:34-43)
PING_PONG_OFFSETS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (-2, -2), (2, -2), (-2, 2), (2, 2))


def _shift_maps(maps: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """filters._shift of each (H, W) map of a (D, H, W) stack."""
    return filters._shift(maps.permute(1, 2, 0), dy, dx).permute(2, 0, 1)


def ping_pong(ctx: LevelContext, cfg: SolverConfig, disparity, costs, confidences):
    """Jacobi spatial propagation of every dst camera at once: evaluate the
    star-template candidate disparity maps and keep the best per pixel
    (Derp.cpp:403-551)."""
    if cfg.ping_pong_iterations <= 0:
        return disparity, costs, confidences
    # the center candidate re-evaluates the pixel's own disparity, whose cost
    # the carry already holds once random proposals ran (solver.py:278-294)
    seed_center = cfg.num_random_proposals > 0
    offsets = PING_PONG_OFFSETS[1:] if seed_center else PING_PONG_OFFSETS
    if cfg.star_axis_only:
        offsets = tuple(o for o in offsets if max(abs(o[0]), abs(o[1])) <= 1)

    cctx = cost_context(ctx)
    fov, fg, bg = ctx.dst_fov_masks, ctx.dst_fg_masks, ctx.dst_bg_disp
    active = fov & fg & (ctx.dst_variance >= ctx.var_noise_floor)
    bg_floor = bg if cfg.has_fg_masks else torch.zeros_like(bg)
    disp, cost, conf = disparity, costs, confidences
    for _ in range(cfg.ping_pong_iterations):
        if seed_center:
            center_ok = fov & (disp >= bg_floor) & torch.isfinite(disp)
            best_cost = torch.where(center_ok, cost, math.inf)
        else:
            best_cost = torch.full_like(cost, math.inf)
        best_disp, best_conf = disp, conf
        for dy, dx in offsets:
            cand = _shift_maps(disp, dy, dx)
            ok = _shift_maps(fov, dy, dx) & (cand >= bg_floor) & torch.isfinite(cand)
            ccost, cconf = cost_ops.cost_for_disparity(cctx, torch.where(ok, cand, disp), _window(cfg))
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
    return disp, cost, conf


# handle_mismatches reduces the destinations in chunks whose (chunk, N, H, W)
# intermediates (the sort's int64 indices among them) hold at most this many
# elements: all 16 maps at once up to 256x192, one at a time at 2048x1536
MISMATCH_CHUNK_ELEMENTS = 1 << 25


def runs_mismatches(cfg: SolverConfig) -> bool:
    """Whether :func:`process_level` runs the mismatch stage at ``cfg.level``:
    below the coarsest level, from ``mismatches_start_level`` down to 0."""
    return cfg.level != cfg.num_levels - 1 and 0 <= cfg.level <= cfg.mismatches_start_level


def handle_mismatches(ctx: LevelContext, cfg: SolverConfig, disparity, full_disparity=None):
    """Cross-camera consistency of every dst camera at once
    (Derp.cpp:553-748): project each dst pixel's depth into every other
    camera's disparity map (one K1 launch for all dst maps); with no
    agreeing camera, replace it by the median of the farther mismatched
    disparities. The default semantics are the XLA branch of
    solver.py:388-396 (one channel, the disparities); on a context with the
    TPU sampler's stack, the Pallas branch (solver.py:347-383): K1 in TPU
    mode through the config's windows over two planes, the NaN-filled
    disparities and their finite mask, and a source votes only where its
    sample is valid, not clipped and wholly finite.

    ``full_disparity`` holds every source camera's map (default: the dst
    maps, when all cameras are destinations). Returns (new disparity,
    mismatch mask).
    """
    disparity = disparity.to(torch.float32)
    full_disparity = disparity if full_disparity is None else full_disparity.to(torch.float32)
    n = ctx.src_imgs.shape[0]
    if full_disparity.shape[0] != n:
        raise ValueError(f"need every source's disparity: {tuple(full_disparity.shape)} vs {n} sources")
    disp = disparity.contiguous()
    d, h, w = disp.shape
    args = (ctx.src_params, ctx.dst_cams.position, disp, ctx.dst_rays)
    if ctx.src_tpu is None:
        sampled, valid = warp_cuda.project_sample_planes(full_disparity[:, None].contiguous(), *args)
    else:
        # NaNs in a window would poison the TPU's interpolation matmul, so
        # it samples (filled, finite-mask) pairs (solver.py:340-349)
        planes = torch.stack([torch.nan_to_num(full_disparity), torch.isfinite(full_disparity).to(torch.float32)],
                             dim=1)
        anchors = warp_cuda.tile_windows(*args, (h, w), _window(cfg))
        sampled, valid, _ = warp_cuda.project_sample_planes_tpu(planes, *args, anchors, _window(cfg))
        valid = valid & (sampled[:, :, 1] > 0.999)
    step = max(1, MISMATCH_CHUNK_ELEMENTS // (n * h * w))
    parts = [_replace_mismatches(ctx, disp, sampled[:, :, 0], valid, slice(i, i + step)) for i in range(0, d, step)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _replace_mismatches(ctx: LevelContext, disp, d_srcs, valid, dsts: slice):
    """handle_mismatches' decision for the destinations ``dsts``, from the
    other cameras' disparities d_srcs (D, N, H, W) sampled at each pixel."""
    frac = 0.1  # kFractionChange, Derp.cpp:594
    disp, d_srcs = disp[dsts], d_srcs[dsts]
    n = d_srcs.shape[1]
    lanes = torch.arange(n, device=disp.device)[None, :, None, None]
    self_idx = torch.as_tensor(ctx.dst2src[dsts], device=disp.device)[:, None, None, None]
    valids = valid[dsts] & (lanes != self_idx) & torch.isfinite(d_srcs)
    lo, hi = ((1 - frac) * disp)[:, None], ((1 + frac) * disp)[:, None]
    is_match = valids & (d_srcs >= lo) & (d_srcs <= hi)
    is_mismatch = valids & ~is_match
    num_match = is_match.sum(dim=1)
    total = num_match + is_mismatch.sum(dim=1)

    # median of the mismatched disparities, counted from the far end
    # (updateDstDisparityAndMismatchMask, Derp.cpp:605-652)
    mm_sorted = torch.sort(torch.where(is_mismatch, d_srcs, math.inf), dim=1).values
    closer = (is_mismatch & (d_srcs < disp[:, None])).sum(dim=1)
    median_idx = torch.clamp(closer // 2, 0, n - 1)
    median_val = torch.gather(mm_sorted, 1, median_idx[:, None])[:, 0]

    variance = ctx.dst_variance[dsts]
    keep = (
        (total == 0)
        | (num_match >= cost_ops.MIN_OVERLAPPING_CAMS - 1)
        | (variance > ctx.var_high_thresh)
        | (variance < ctx.var_noise_floor)
    )
    replace = ~keep & ctx.dst_fov_masks[dsts] & ctx.dst_fg_masks[dsts]
    return torch.where(replace, torch.minimum(disp, median_val), disp), replace


def spatial_bilateral(ctx: LevelContext, cfg: SolverConfig, disparity):
    """Color-guided joint bilateral on disparity; the radius shrinks coarse
    to fine by kLevelScale (Derp.cpp:875-902). All the context's maps in
    one launch (warp_cuda.joint_bilateral), each guided by its source's
    colors in the interleaved stack; a pixel outside fov & fg passes
    through, so outside fg each map keeps its disparity."""
    scale = cost_ops.LEVEL_SCALE ** cfg.level
    radius = max(math.ceil(filters.BILATERAL_SPACE_RADIUS_MAX * scale), filters.BILATERAL_SPACE_RADIUS_MIN)
    return warp_cuda.joint_bilateral(ctx.src_rgba, ctx.dst2src, disparity.contiguous(),
                                     ctx.dst_fov_masks & ctx.dst_fg_masks, radius)


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
                  generator=None, gather=None):
    """Full per-level pipeline (Derp.cpp:1005-1034; solver.py:474-506).

    ``init_disparity`` is the upsampled coarser-level result (None at the
    coarsest level). The random proposals draw ``uniforms`` when given,
    else from ``generator``, else from :func:`level_generator`.
    ``gather``, where the context holds some of the destinations (the
    sharded solve, ``parallel/sharding.py``), maps this context's disparity
    to every source's map in source order for the mismatch stage; None
    means the context's own maps are every source's. Returns a dict of
    (D, H, W) disparity/cost/confidence/mismatch maps. Each stage is a
    ``derp.stage.<name>`` span (``core/spans.py``); the median's holds the
    FOV mask.
    """
    d = len(ctx.dst2src)
    h, w = ctx.src_imgs.shape[1:3]
    dev = ctx.src_imgs.device
    coarsest = cfg.level == cfg.num_levels - 1
    if coarsest or init_disparity is None:
        with span("derp.stage.brute_force"):
            disparity, costs, confidences = brute_force_all(ctx, cfg)
    else:
        disparity = init_disparity.to(device=dev, dtype=torch.float32)
        costs = torch.full((d, h, w), math.inf, dtype=torch.float32, device=dev)
        confidences = torch.zeros((d, h, w), dtype=torch.float32, device=dev)

    mismatch_mask = torch.zeros((d, h, w), dtype=torch.bool, device=dev)
    if not coarsest:
        with span("derp.stage.proposals"):
            if uniforms is None and generator is None:
                generator = level_generator(cfg, dev)
            disparity, costs, confidences = random_proposals(
                ctx, cfg, disparity, costs, confidences, uniforms=uniforms, generator=generator)
        with span("derp.stage.ping_pong"):
            disparity, costs, confidences = ping_pong(ctx, cfg, disparity, costs, confidences)
        if runs_mismatches(cfg):
            with span("derp.stage.mismatches"):
                full = None if gather is None else gather(disparity)
                disparity, mismatch_mask = handle_mismatches(ctx, cfg, disparity, full)

    if cfg.do_bilateral_filter:
        with span("derp.stage.bilateral"):
            disparity = spatial_bilateral(ctx, cfg, disparity)
    with span("derp.stage.median"):
        if cfg.do_median_filter:
            disparity = median_filter(ctx, cfg, disparity)
        disparity = mask_fov(ctx, disparity)
    return {
        "disparity": disparity,
        "cost": costs,
        "confidence": confidences,
        "mismatches": mismatch_mask,
    }
