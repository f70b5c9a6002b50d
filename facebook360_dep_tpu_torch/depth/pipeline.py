"""Coarse-to-fine depth-estimation driver: the port of ``depth/pipeline.py``.

Host loop over pyramid levels and frames (``DerpCLI.cpp:179-328``); per
level the data lives on the device and :func:`solver.process_level` runs
there. Between levels the coarser disparity, upsampled with Lanczos4,
initializes the finer one (``UpsampleDisparityLib.cpp:143-148``).

The filesystem contract (color_levels/level_N/<cam>/<frame>.png in,
disparity_levels out) matches the reference and the JAX package.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import default_device
from ..core import camera as cam
from ..core import imagetypes, io
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

    def check_supported(self):
        """Options whose code paths are not ported yet raise here."""
        missing = []
        if self.use_foreground_masks:
            missing.append("--use_foreground_masks (its upsample needs a distance transform)")
        if self.save_debug_images:
            missing.append("--save_debug_images")
        if self.debug_dir and self.debug_plot_match_dst:
            missing.append("plot_matches (--debug_dir/--debug_plot_match_*)")
        if self.profile_dir:
            missing.append("--profile_dir")
        if missing:
            raise NotImplementedError("not ported yet: " + ", ".join(missing))


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


class DepthEstimator:
    """Loads rig + pyramid metadata once; estimates disparity per frame/level.

    ``level_seconds`` holds each level's wall time (all frames, outputs
    written) after :meth:`run`.
    """

    def __init__(self, opts: DepthEstimatorOptions):
        opts.resolve_paths()
        opts.check_supported()
        self.opts = opts
        self.device = default_device()
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
        out = []
        for cam_id in rig.ids:
            path_dir = os.path.join(str(root), f"level_{level}", cam_id)
            probe = io.first_image_in(path_dir)
            if not probe:
                raise FileNotFoundError(f"no images in {path_dir}")
            ext = os.path.splitext(probe)[1]
            out.append(loader(os.path.join(path_dir, frame + ext)))
        return np.stack(out)

    def load_colors(self, level, frame) -> np.ndarray:
        imgs = self._load_level_images(self.opts.color, level, self.rig_src, frame, io.read_color)
        return imgs[..., :3]

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

    def load_coarser_disparity(self, level, frame, size_wh) -> torch.Tensor:
        """Upsampled init from level+1 outputs (DerpCLI.cpp:271-303)."""
        out = []
        for cam_id in self.rig_dst.ids:
            coarse = io.read_disparity(self._disparity_path(level + 1, cam_id, frame, "pfm"))
            out.append(upsample_disparity_init(torch.from_numpy(coarse).to(self.device), size_wh))
        return torch.stack(out)

    # ---- main entry ---------------------------------------------------------

    def frames(self):
        first, last = int(self.opts.first), int(self.opts.last)
        return [io.frame_name(f) for f in range(first, last + 1)]

    @torch.inference_mode()
    def run(self):
        t0 = time.time()
        for level in range(self.level_start, self.level_end - 1, -1):
            tl = time.time()
            size_wh = self.level_sizes[level]
            w, h = size_wh
            fov_masks = generate_fov_masks(self.rig_dst, (h, w), self.device)
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
            fov_np = fov_masks.cpu().numpy()
            for frame in self.frames():
                tf = time.time()
                colors = torch.from_numpy(self.load_colors(level, frame)).to(self.device)
                ctx = solver.make_level_context(
                    self.rig_src,
                    self.rig_dst,
                    colors,
                    fov_masks,
                    var_noise_floor=self.opts.var_noise_floor,
                    var_high_thresh=self.opts.var_high_thresh,
                    full_height=self.full_height,
                )
                # below the coarsest level, init from the coarser level's saved
                # result (also how mid-pyramid resume works; DerpCLI.cpp:271-303)
                init = None
                if level < self.num_levels - 1:
                    init = self.load_coarser_disparity(level, frame, size_wh)
                result = solver.process_level(ctx, cfg, init_disparity=init)
                result = {k: v.cpu().numpy() for k, v in result.items()}
                if level == self.num_levels - 1 or init is None:
                    # brute force ran: enforce the coverage policy
                    self.check_coverage(level, frame, result, fov_np)
                self.save_results(level, frame, result)
                log.info("frame %s level %d (%dx%d): %.2fs", frame, level, w, h, time.time() - tf)
            self.level_seconds[level] = time.time() - tl
            log.info("-- Elapsed time: %.2fs", time.time() - t0)
        log.info("-- TOTAL: %.2fs", time.time() - t0)
