"""Coarse-to-fine depth-estimation driver: the port of ``depth/pipeline.py``.

Host loop over pyramid levels and frames (``DerpCLI.cpp:179-328``); per
level the data lives on the device and :func:`solver.process_level` runs
there. Between levels the coarser disparity initializes the finer one
(``UpsampleDisparityLib.cpp:93-220``): upsampled with Lanczos4, or with
foreground masks, nearest-upsampled inside the mask, holes filled from the
nearest valid pixel and the rest from the background disparity.

The filesystem contract (color_levels/level_N/<cam>/<frame>.png in,
disparity_levels out; foreground_masks_levels and the background's
disparity_levels with ``--use_foreground_masks``) matches the reference and
the JAX package. The debug outputs (``--save_debug_images``, plotMatches)
write the JAX package's files; ``--profile_dir`` writes a torch.profiler
chrome trace with a ``derp level N`` range per level and, inside it, the
frame job's spans (``core/spans.py``): ``derp.io.read_colors``,
``derp.io.read_coarser``, ``derp.io.write``, ``derp.upload``,
``derp.readback``, ``derp.stage.setup``, the solver's stages
``derp.stage.{brute_force,proposals,ping_pong,mismatches,bilateral,median}``
and ``derp.coverage``; ``derp.init`` lies before the levels. The same spans
time every run, traced or not: ``level_seconds`` and the per-frame log
line's split (io, copies, setup, search, filters) come from them.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..core import camera as cam
from ..core import imagetypes, io
from ..core.spans import Record, span
from ..ops import sampling
from . import solver

log = logging.getLogger("derp")


@dataclass
class DepthEstimatorOptions:
    """Mirrors the DerpCLI flags (DerpCLI.cpp:40-67)."""

    input_root: str = ""
    output_root: str = ""
    rig: str = ""
    color: str = ""
    background_disp: str = ""
    foreground_masks: str = ""
    background_frame: str = "000000"
    cameras: str = ""
    first: str = "000000"
    last: str = "000000"
    level_start: int = -1
    level_end: int = -1
    num_levels: int = -1
    min_depth_m: float = 0.5
    max_depth_m: float = 1e4
    mismatches_start_level: int = -1
    output_formats: str = "pfm"
    partial_coverage: bool = False
    ping_pong_iterations: int = 1
    random_proposals: int = 2
    # the N finest levels use the axis-only star and
    # fast_fine_random_proposals (pipeline.py:56-67); 0 = reference schedule
    fast_fine_levels: int = 0
    fast_fine_random_proposals: int = 1
    resolution: int = 2048
    use_foreground_masks: bool = False
    var_high_thresh: float = 1e-3
    var_noise_floor: float = 4e-5
    do_bilateral_filter: bool = True
    do_median_filter: bool = True
    save_debug_images: bool = False
    debug_dir: str = ""
    debug_plot_match_dst: str = ""
    debug_plot_match_x: int = -1
    debug_plot_match_y: int = -1
    debug_plot_match_level: int = -1
    profile_dir: str = ""

    def resolve_paths(self):
        if not self.rig:
            self.rig = os.path.join(self.input_root, "rigs/rig_calibrated.json")
        if not self.color:
            self.color = imagetypes.image_dir(self.input_root, "color_levels")
        if not self.background_disp:
            self.background_disp = imagetypes.image_dir(self.input_root, "background_disp_levels")
        if not self.foreground_masks:
            self.foreground_masks = imagetypes.image_dir(self.input_root, "foreground_masks_levels")


def generate_fov_masks(rig: cam.Rig, size_hw, device=None) -> torch.Tensor:
    """(D, H, W) bool: inside-image-circle per dst camera (DerpUtil.cpp:259-276)."""
    h, w = int(size_hw[0]), int(size_hw[1])
    cams = rig.cameras.to(device, torch.float32)
    dev = cams.position.device
    grid = sampling.pixel_center_grid(h, w, device=dev) / torch.tensor([w, h], dtype=torch.float32, device=dev)
    return ~cam.is_outside_image_circle(cams, grid.expand((len(rig.ids),) + grid.shape))


def upsample_disparity_init(disp: torch.Tensor, size_wh) -> torch.Tensor:
    """Between-level init, no-foreground path: NaN -> minDisp then Lanczos4
    (UpsampleDisparityLib.cpp:143-148; cv2.INTER_LANCZOS4 semantics)."""
    return sampling.resize_lanczos4(torch.nan_to_num(disp.to(torch.float32), nan=1e-4), size_wh)


def upsample_disparity_fg(disp, mask, mask_up, bg_disp_up, size_wh) -> np.ndarray:
    """Foreground path (UpsampleDisparityLib.cpp:97-141; pipeline.py:125-150)
    on the host, for one (H, W) map or a stack (..., H, W): NaN outside the
    mask, nearest upsample (cv2 INTER_NEAREST), NaN outside the upsampled
    mask, in-mask holes filled from the nearest valid pixel (OpenCV's
    chamfer labels, :func:`_nearest_valid_index`), the rest from the
    upsampled background disparity."""
    d = np.where(mask, np.asarray(disp, np.float32), np.float32(np.nan))
    h, w = d.shape[-2:]
    w_out, h_out = (int(v) for v in size_wh)
    d_up = d[..., io.nearest_index(h, h_out), :][..., io.nearest_index(w, w_out)]
    mask_up = np.asarray(mask_up, bool)
    d_up = np.where(mask_up, d_up, np.float32(np.nan)).reshape((-1, h_out, w_out))
    valid = np.isfinite(d_up)
    invalid = ~valid & mask_up.reshape(d_up.shape)
    todo = invalid.any(axis=(1, 2)) & valid.any(axis=(1, 2))
    if todo.any():
        _, (iy, ix) = _nearest_valid_index(valid[todo])
        flat = (-1, h_out * w_out)
        fill = np.take_along_axis(d_up[todo].reshape(flat), (iy * w_out + ix).reshape(flat), 1)
        d_up[todo] = np.where(invalid[todo], fill.reshape(-1, h_out, w_out), d_up[todo])
    d_up = d_up.reshape(d.shape[:-2] + (h_out, w_out))
    return np.where(np.isfinite(d_up), d_up, np.asarray(bg_disp_up, np.float32))


# OpenCV's distance transform with labels (imgproc/distransform.cpp,
# distanceTransformEx_5x5): whenever labels are asked for, DIST_L2 runs the
# 5x5 chamfer mask (1, 1.4, 2.1969) in 16.16 fixed point, whatever the mask
# size passed, in one forward and one backward raster pass.
_DT_HV, _DT_DIAG, _DT_LONG = 65536, 91750, 143976  # cvRound(m * 2^16)
_DT_INIT = (2**31 - 1) >> 2
# neighbors in OpenCV's order (dy, dx, cost); the in-row neighbor comes last
_DT_FORWARD = ((-2, -1, _DT_LONG), (-2, 1, _DT_LONG), (-1, -2, _DT_LONG), (-1, -1, _DT_DIAG),
               (-1, 0, _DT_HV), (-1, 1, _DT_DIAG), (-1, 2, _DT_LONG))
_DT_BACKWARD = ((2, 1, _DT_LONG), (2, -1, _DT_LONG), (1, 2, _DT_LONG), (1, 1, _DT_DIAG),
                (1, 0, _DT_HV), (1, -1, _DT_DIAG), (1, -2, _DT_LONG))


def _chamfer_row(dist, label, y, neighbors, step):
    """Relax padded row ``y + 2`` of (B, H+4, W+4) ``dist``/``label`` in
    place: first the neighbors of finished rows in OpenCV's order, then the
    in-row neighbor (left when ``step`` is 1, right when -1). Each compare is
    strict, so the first of equal candidates wins, as in OpenCV. The in-row
    recurrence v[j] = min(a[j], v[j-1] + 1) is a running minimum of
    a[k] - k over the row, so a row costs a fixed number of numpy passes."""
    w = dist.shape[2] - 4
    best = dist[:, y + 2, 2:-2].copy()
    lab = label[:, y + 2, 2:-2].copy()
    for dy, dx, c in neighbors:
        cand = dist[:, y + 2 + dy, 2 + dx:2 + dx + w] + np.int32(c)
        better = cand < best
        np.copyto(best, cand, where=better)
        np.copyto(lab, label[:, y + 2 + dy, 2 + dx:2 + dx + w], where=better)
    a, lab = best[:, ::step], lab[:, ::step]
    ramp = np.arange(w, dtype=np.int32) * np.int32(_DT_HV)
    v = np.minimum.accumulate(a - ramp, axis=1) + ramp
    from_prev = np.zeros(a.shape, bool)
    np.greater(a[:, 1:], v[:, :-1] + np.int32(_DT_HV), out=from_prev[:, 1:])
    src = np.maximum.accumulate(np.where(from_prev, 0, np.arange(w, dtype=np.int32)), axis=1)
    dist[:, y + 2, 2:-2] = v[:, ::step]
    label[:, y + 2, 2:-2] = np.take_along_axis(lab, src, 1)[:, ::step]


def _nearest_valid_index(valid: np.ndarray):
    """Chamfer distance and the nearest valid pixel of every pixel of one
    (H, W) mask or a stack (B, H, W), as
    ``cv2.distanceTransformWithLabels(~valid, DIST_L2, 3, DIST_LABEL_PIXEL)``
    computes them (pipeline.py:153-167): identical labels, not an exact
    EDT. Returns (dist float32, (iy, ix)); -1 where a mask has no valid
    pixel."""
    valid = np.asarray(valid, bool)
    shape = valid.shape
    h, w = shape[-2:]
    v = valid.reshape((-1, h, w))
    # int32 holds every sum: INIT + 2.2 px and W px in 16.16 stay below 2^31
    dist = np.full((v.shape[0], h + 4, w + 4), _DT_INIT, np.int32)
    label = np.full(dist.shape, -1, np.int32)
    dist[:, 2:-2, 2:-2] = np.where(v, 0, _DT_INIT)
    label[:, 2:-2, 2:-2] = np.where(v, np.arange(h * w, dtype=np.int32).reshape(h, w), -1)
    for y in range(h):
        _chamfer_row(dist, label, y, _DT_FORWARD, 1)
    for y in range(h - 1, -1, -1):
        _chamfer_row(dist, label, y, _DT_BACKWARD, -1)
    lab = label[:, 2:-2, 2:-2].reshape(shape).astype(np.int64)
    d = dist[:, 2:-2, 2:-2].astype(np.float32) * np.float32(1.0 / 65536)
    iy = np.where(lab >= 0, lab // w, -1)
    ix = np.where(lab >= 0, lab % w, -1)
    return d.reshape(shape), (iy, ix)


class DepthEstimator:
    """Loads rig + pyramid metadata once; estimates disparity per frame/level.

    ``level_seconds`` holds each level's wall time (all frames, outputs
    written) after :meth:`run`, the duration of its ``derp level N`` span;
    ``spans`` (a :class:`..core.spans.Record`) every span's nanoseconds by
    (frame, level). ``device`` None means the card.
    """

    def __init__(self, opts: DepthEstimatorOptions, *, device=None):
        self.spans = Record()
        with self.spans.at(None, None), span("derp.init"):
            opts.resolve_paths()
            self.opts = opts
            self.device = resolve_device(device)
            rig_src = cam.load_rig(opts.rig)
            rig_dst = cam.filter_destinations(rig_src, opts.cameras)
            self.full_height = int(rig_dst.cameras.resolution[0, 1])
            self.rig_src = cam.normalize_rig(rig_src)
            self.rig_dst = cam.normalize_rig(rig_dst)

            sizes = io.get_pyramid_level_sizes(opts.color)
            sizes.update(io.get_pyramid_level_sizes(imagetypes.image_dir(opts.output_root, "disparity_levels")))
            if not sizes:
                raise FileNotFoundError(f"no pyramid levels found under {opts.color}")
            self.level_sizes = sizes  # level -> (width, height)
            self.num_levels = (max(sizes) + 1) if opts.num_levels == -1 else opts.num_levels
            self.level_start = opts.level_start if opts.level_start >= 0 else self.num_levels - 1
            self.level_end = self._resolve_level_end()
        self.level_seconds: dict[int, float] = {}

    def _resolve_level_end(self) -> int:
        """Largest level whose width fits the requested resolution (DerpCLI.cpp:159-178)."""
        level_end = 0
        for level in sorted(self.level_sizes):
            if self.level_sizes[level][0] <= self.opts.resolution:
                level_end = level
                break
        return max(level_end, self.opts.level_end if self.opts.level_end >= 0 else 0)

    # ---- per level/frame IO -------------------------------------------------

    def _load_level_images(self, root, level, rig, frame, loader):
        return np.stack([loader(io.frame_path(os.path.join(str(root), f"level_{level}", cam_id), frame))
                         for cam_id in rig.ids])

    def load_colors(self, level, frame) -> np.ndarray:
        imgs = self._load_level_images(self.opts.color, level, self.rig_src, frame, io.read_color)
        return imgs[..., :3]

    def load_fg_masks(self, level, frame, rig) -> np.ndarray:
        return self._load_level_images(self.opts.foreground_masks, level, rig, frame, io.read_mask)

    def load_bg_disp(self, level) -> np.ndarray:
        return self._load_level_images(
            self.opts.background_disp, level, self.rig_dst, self.opts.background_frame, io.read_disparity)

    def _disparity_path(self, level, cam_id, frame, ext):
        return imagetypes.gen_filename(self.opts.output_root, "disparity_levels", level, cam_id, frame, ext)

    def save_results(self, level, frame, result):
        formats = {f for f in self.opts.output_formats.split(",") if f}
        formats.add("pfm")  # always save PFM (Derp.cpp:930-937)
        disp = np.asarray(result["disparity"])
        for i, cam_id in enumerate(self.rig_dst.ids):
            for ext in sorted(formats):
                path = self._disparity_path(level, cam_id, frame, ext)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                io.write_disparity(path, disp[i])

    def check_coverage(self, level, frame, result, fov_masks):
        """Insufficient-coverage policy at the brute-force level
        (Derp.cpp:334-348): pixels inside the FOV that no camera pair covers
        are fatal unless --partial_coverage or --use_foreground_masks."""
        uncovered = ~np.isfinite(np.asarray(result["cost"])) & np.asarray(fov_masks, bool)
        n = int(uncovered.sum())
        if n == 0:
            return
        reasons = []
        if self.opts.partial_coverage:
            reasons.append("due to partial coverage")
        if self.opts.use_foreground_masks:
            reasons.append("due to noisy foreground masks")
        msg = (
            f"Insufficient coverage at {n} pixels (level {level}, frame {frame}) "
            + " or ".join(reasons)
        )
        if not reasons:
            raise RuntimeError(msg + "; pass --partial_coverage if the rig does not cover 360")
        log.warning(msg)

    def save_debug_images(self, level, frame, result, fov_masks):
        """Per-destination disparity, cost, confidence and mismatch-overlay
        debug PNGs (pipeline.py:238-272; PyramidLevel.h:418-461, scales
        DerpUtil.h:23-25), decoding to the JAX package's bytes. The
        overlay is stored RGBA: the JAX package writes BGRA through OpenCV,
        which stores RGBA."""
        disp = np.asarray(result["disparity"], np.float32)
        cost = np.asarray(result["cost"], np.float32)
        conf = np.asarray(result["confidence"], np.float32)
        mism = np.asarray(result["mismatches"], bool)
        fov = np.asarray(fov_masks, bool)
        for i, cam_id in enumerate(self.rig_dst.ids):
            def path(image_type):
                p = imagetypes.gen_filename(self.opts.output_root, image_type, level, cam_id, frame, "png")
                os.makedirs(os.path.dirname(p), exist_ok=True)
                return p

            # disparity: clamp [0,1] -> PNG16 truncated, NaN -> 0 (PyramidLevel.h:442-445)
            d16 = np.nan_to_num(np.clip(disp[i], 0.0, 1.0)) * 65535.0
            io.write_png(path("disparity_levels"), d16.astype(np.uint16))
            # cost x 255/100, confidence x 255*100 -> PNG8 (inf -> FLT_MAX -> 255)
            with np.errstate(over="ignore"):
                c8 = np.clip(np.nan_to_num(cost[i].astype(np.float64)) * (255.0 / 100.0), 0, 255)
                f8 = np.clip(np.nan_to_num(conf[i].astype(np.float64)) * (255.0 * 100.0), 0, 255)
            io.write_png(path("cost"), c8.astype(np.uint8))
            io.write_png(path("confidence"), f8.astype(np.uint8))
            # red where mismatched, gray disparity elsewhere, transparent
            # black outside the FOV (overlayMismatchedDstDisparityMask)
            g = np.clip(np.nan_to_num(disp[i]), 0.0, 1.0) * 255.0
            inside = fov[i]
            rgba = np.zeros(disp[i].shape + (4,), np.uint8)
            rgba[..., :3] = np.where(inside, g, 0).astype(np.uint8)[..., None]
            rgba[inside & mism[i]] = (255, 0, 0, 255)
            rgba[..., 3] = np.where(inside, 255, 0).astype(np.uint8)
            io.write_png(path("mismatches"), rgba)

    def plot_matches(self, level, frame, result, colors, caller="processLevel"):
        """plotDstPointInSrc for every source (pipeline.py:296-347;
        Derp.cpp:28-70, DerpUtil.cpp:164-197): unproject the debug pixel at
        its solved disparity, project it into each source that sees it,
        mark the landing pixel green in a PNG16 of that source's color.
        The camera math runs on the host in the rig's float64."""
        o = self.opts
        if (not o.debug_dir or not o.debug_plot_match_dst or o.debug_plot_match_level != level
                or o.debug_plot_match_x < 0 or o.debug_plot_match_y < 0):
            return
        x, y = o.debug_plot_match_x, o.debug_plot_match_y
        di = self.rig_dst.ids.index(o.debug_plot_match_dst)
        disparity = np.asarray(result["disparity"])
        disp = float(disparity[di, y, x])
        if not np.isfinite(disp) or disp <= 0:
            log.warning("plotMatches: no disparity at (%d, %d)", x, y)
            return
        h, w = disparity.shape[1:]
        cdst = self.rig_dst.cameras.index(di)
        # the pixel is a float32 value, as in the JAX package
        pix_norm = torch.tensor([(x + 0.5) / w, (y + 0.5) / h], dtype=torch.float32).to(cdst.position.dtype)
        world = cdst.position + cam.ray_dir(cdst, pix_norm) / disp
        os.makedirs(o.debug_dir, exist_ok=True)
        for si, src_id in enumerate(self.rig_src.ids):
            if src_id == o.debug_plot_match_dst:
                continue
            pix, valid = cam.sees(self.rig_src.cameras.index(si), world)
            if not bool(valid):
                continue
            px, py = float(pix[0]) * w, float(pix[1]) * h
            img = (np.clip(np.asarray(colors[si])[..., :3], 0, 1) * 65535).astype(np.uint16)
            iy = int(np.clip(py, 0, img.shape[0] - 1))
            ix = int(np.clip(px, 0, img.shape[1] - 1))
            img[iy, ix] = (0, 65535, 0)
            fn = os.path.join(o.debug_dir, f"{caller}_{o.debug_plot_match_dst}_x={x}_y={y}->"
                                           f"{src_id}_x={px:.2f}_y={py:.2f}.png")
            io.write_png(fn, img)
        log.info("plotMatches: wrote projections of %s (%d, %d) disparity %.4f",
                 o.debug_plot_match_dst, x, y, disp)

    def load_coarser_disparity(self, level, frame, size_wh, fg_masks=None, bg_disp=None) -> torch.Tensor:
        """Upsampled init from level+1 outputs (DerpCLI.cpp:271-303). With
        foreground masks, ``fg_masks`` and ``bg_disp`` are this level's
        (D, H, W) masks and background maps, as the solve loaded them."""
        with span("derp.io.read_coarser"):
            coarse = [io.read_disparity(self._disparity_path(level + 1, cam_id, frame, "pfm"))
                      for cam_id in self.rig_dst.ids]
            mask = self.load_fg_masks(level + 1, frame, self.rig_dst) if self.opts.use_foreground_masks else None
        with span("derp.stage.setup"):
            if mask is None:
                return torch.stack([upsample_disparity_init(torch.from_numpy(c).to(self.device), size_wh)
                                    for c in coarse])
            up = upsample_disparity_fg(np.stack(coarse), mask, fg_masks, bg_disp, size_wh)
            return torch.from_numpy(up).to(self.device)

    # ---- main entry ---------------------------------------------------------

    def frames(self):
        first, last = int(self.opts.first), int(self.opts.last)
        return [io.frame_name(f) for f in range(first, last + 1)]

    def run(self):
        """Solve every level of every frame. With ``profile_dir`` the run is
        traced by torch.profiler (host, and the card when it runs there) and
        the trace lands in that directory as a chrome-trace JSON, with the
        ``derp level N`` ranges and the spans of the module docstring."""
        if not self.opts.profile_dir:
            self._run_levels()
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            self._run_levels()
        os.makedirs(self.opts.profile_dir, exist_ok=True)
        path = os.path.join(self.opts.profile_dir, f"derp_{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        log.info("profiler trace written to %s", path)

    @torch.inference_mode()
    def _run_levels(self):
        total = 0.0
        for level in range(self.level_start, self.level_end - 1, -1):
            with self.spans.at(None, level), span(f"derp level {level}") as s:
                self._run_level(level)
            self.level_seconds[level] = s.ns / 1e9
            total += self.level_seconds[level]
            log.info("-- Elapsed time: %.2fs", total)
        log.info("-- TOTAL: %.2fs", total)

    def _run_level(self, level):
        size_wh = self.level_sizes[level]
        w, h = size_wh
        with span("derp.stage.setup"):
            fov_masks = generate_fov_masks(self.rig_dst, (h, w), self.device)
            fov_np = fov_masks.cpu().numpy()
        fast_fine = level < self.opts.fast_fine_levels
        cfg = solver.SolverConfig(
            min_depth=self.opts.min_depth_m,
            max_depth=self.opts.max_depth_m,
            num_random_proposals=(
                self.opts.fast_fine_random_proposals if fast_fine else self.opts.random_proposals
            ),
            star_axis_only=fast_fine,
            ping_pong_iterations=self.opts.ping_pong_iterations,
            mismatches_start_level=self.opts.mismatches_start_level,
            do_bilateral_filter=self.opts.do_bilateral_filter,
            do_median_filter=self.opts.do_median_filter,
            has_fg_masks=self.opts.use_foreground_masks,
            level=level,
            num_levels=self.num_levels,
        )
        if cfg.mismatches_start_level >= 0 and self.rig_dst.ids != self.rig_src.ids:
            raise ValueError("mismatch handling requires all cameras as destinations")
        for frame in self.frames():
            with self.spans.at(frame, level):
                self._run_frame(level, frame, cfg, fov_masks, fov_np)
            split = self.spans.split(frame, level)
            log.info("frame %s level %d (%dx%d): %.2fs (%s)", frame, level, w, h,
                     self.spans.wall[(frame, level)] / 1e9, ", ".join(f"{g} {v:.2f} s" for g, v in split.items()))

    def _run_frame(self, level, frame, cfg, fov_masks, fov_np):
        with span("derp.io.read_colors"):
            colors_np = self.load_colors(level, frame)
            fg = bg = None
            if self.opts.use_foreground_masks:
                fg = self.load_fg_masks(level, frame, self.rig_dst)
                bg = self.load_bg_disp(level)
        with span("derp.upload"):
            colors = torch.from_numpy(colors_np).to(self.device)
        # The JAX package runs its windowed, quantized Pallas sampler on
        # its own chip only (use_pallas_sampler there is "the backend is a
        # TPU", pipeline.py:390), and the exact XLA path elsewhere. A
        # card gathers natively, so the port keeps the exact path here;
        # make_level_context(use_pallas_sampler=True) with
        # SolverConfig(ww_max=, wh_max=) reproduces the TPU's maps.
        with span("derp.stage.setup"):
            ctx = solver.make_level_context(
                self.rig_src,
                self.rig_dst,
                colors,
                fov_masks,
                dst_fg_masks=None if fg is None else torch.from_numpy(fg),
                dst_bg_disp=None if bg is None else torch.from_numpy(bg),
                var_noise_floor=self.opts.var_noise_floor,
                var_high_thresh=self.opts.var_high_thresh,
                full_height=self.full_height,
            )
        # below the coarsest level, init from the coarser level's saved
        # result (also how mid-pyramid resume works; DerpCLI.cpp:271-303)
        init = None
        if level < self.num_levels - 1:
            init = self.load_coarser_disparity(level, frame, self.level_sizes[level], fg, bg)
        result = solver.process_level(ctx, cfg, init_disparity=init)
        with span("derp.readback"):
            result = {k: v.cpu().numpy() for k, v in result.items()}
        if level == self.num_levels - 1 or init is None:
            # brute force ran: enforce the coverage policy
            with span("derp.coverage"):
                self.check_coverage(level, frame, result, fov_np)
        with span("derp.io.write"):
            self.save_results(level, frame, result)
            if self.opts.save_debug_images:
                self.save_debug_images(level, frame, result, fov_np)
            self.plot_matches(level, frame, result, colors_np)
