#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. refuses to run without CUDA; prints the card and its power limit;
2. builds the CUDA kernels of facebook360_dep_tpu_torch/csrc from source;
3. holds each kernel against its plain PyTorch twin on the card, on a
   16-camera rig of all four camera types with distortion, at every level
   shape the solve launches it at (K1/K2 at the seven widths 256..50, K1
   sampling all 16 destination maps in one launch, with 3 channels and
   with 1 over a NaN-holding disparity stack; K3 at 2048, 1024 and 512;
   K3 also against K1 -> K2 bit for bit, and below K3 the solver's batched
   cost_for_disparity against its 16 single-destination calls bit for
   bit; the joint bilateral kernel on all 16 maps at each of the ten
   levels and its radius, against its per-map twin bit for bit; the
   chamfer kernel's labels of all 16 maps at each of the ten levels, on
   the foreground init's valid flags of the disk scene, against its
   twin), and times each there two ways with CUDA events: ``ms``, one
   launch from the host as the solve makes it, and ``graph_ms``, the
   device time of one launch inside a CUDA graph, which leaves the host's
   launch cost out; beside them the roofline bound from the bytes and
   FLOPs of its shapes (the joint bilateral's: its bytes, FP32 operations
   and expf against the memory, FP32 issue and SFU rates) and the share
   bound / graph_ms; the twins are timed at 256x192 and 2048x1536; the
   chamfer's bound is its bytes, and beside it the time of one of its 2H
   dependent row steps;
4. renders the 16-camera sphere scene (the JAX bench's config 2 rig) at the
   ten pyramid widths 2048..50 with the port, writes it as a project tree,
   and runs the port's derp_cli on it with default solver flags;
5. checks that every kernel was launched by that run and that the level-0
   disparity is within 5% median relative error of the ground truth; the
   launches it counted at each level shape complete the per-level table
   (launches a solve, launches x (graph_ms - bound)), and each level must
   show the batched solve's count (K1 11 at each of 256..60 and 150 at 50,
   K2 16 times that, K3 176 at each of its levels, the joint bilateral 1,
   the chamfer 0: that solve has no foreground masks);
6. holds K4 (warp_sample) against its twin on the render gather of one
   cubemap at face 1536: the 16 cameras' level-0 colors and derp_cli's
   disparity (with a NaN patch) sampled at the coordinates render_view
   computes for the cube at camera 0's position; times both, and times
   torch.nn.functional.grid_sample at the same points as the library
   yardstick (timed only: its NaN taps differ);
7. runs the port's compute_rephotography_errors on derp_cli's output (16
   cameras, 2048x1536, cubemap faces of 1536), checks that K4 was launched
   and that the TOTAL average MSSIM meets the reference's bar (90.0 - 0.05);
8. runs the port's simple_mesh_renderer eqrcolor and tbstereo at its
   default 2048x1024 on the same output and checks that K4 was launched and
   that the images are finite with non-trivial alpha coverage;
9. runs the foreground/background chain at full width through each CLI's
   main(), in the reference's stage order: a static background (the
   sphere) and three frames with a moving textured disk in front of it,
   written at 2048x1536; resize_images of the background, derp_cli on it,
   resize_images of the frames, generate_foreground_masks, resize_images
   --threshold 0.5 of the masks, derp_cli --use_foreground_masks over the
   background's solve, temporal_bilateral_filter at level 0, upsample_disparity
   from level 1 to 2048 with color, masks and background, and an eqrcolor
   export of the filtered frame 000001. It checks that K1-K3 were launched
   by both solves, the chamfer by the foreground solve, once a camera with holes by the upsample, and K4
   by the export, the masks' IoU against the disk's true coverage, and the level-0, in-disk, filtered and upsampled median
   relative errors against the composited truth (bar 0.05); then
   convert_to_binary --foreground_masks of the filtered frame 000001, whose
   meshes must keep to the masks' pixels;
10. publishes and plays back the sphere solve of step 4 (in its tree, after
   step 8): the port's convert_to_binary with its defaults (vtx, idx, bc7;
   150000 triangles; adaptive mesh; fusion) on the 16 level-0 disparity maps
   and colors at 2048x1536; checks that each .idx indexes its .vtx, faces
   stay within the budget (or the simplifier says why not), vertices are
   finite, every fused entry read back (read_fused_entry and
   AsyncFrameLoader) equals its bin/ file, the mean BC7 PSNR against the
   RGBA8 is >= 30 dB and each mesh rasterized back keeps a median relative
   z error <= 1% of the equi-error z; converts cameras 0 and 1 again on the
   CPU (byte-identical files); runs view_fused at 2048x1024 from the rig
   center (K4 launched), whose covered share must reach 90% of the eqrcolor
   export's and whose PSNR over pixels both cover must be >= 30 dB; prints
   each stage's wall time and the peak device memory;
11. calibrates the sphere rig of step 4 (in its tree, after step 9) with the
   port's calibration CLIs: (a) cli/calibration.main on the 16 level-0
   colors (2048x1536, --max_corners 2000, --min_depth_m 1 --max_depth_m 100,
   --perturb_rotations 0.02, principals and focals locked, 10 passes):
   corners and matches in float32, triangulation and bundle adjustment in
   float64 on the card; the median reprojection error must be <= 0.5 px
   and the gauge-aligned forward-vector RMSE <= 0.65 of the perturbed
   rig's; (b) main_geometric on 10,000 artificial points with 0.5 px of
   noise, --perturb_rotations 0.01 --perturb_principals 2: median < 0.8
   px, and the same solve on the CPU must agree with the card's within
   CALIB_CARD_CPU_TOLERANCE; prints corners, matches, each pass's median,
   the stage times and the peak device memory;
12. runs a shoot from RAW frames through the project driver, in a fresh
   project: the 16 level-0 colors of step 4's scene mosaicked (GBRG) and
   written with rawio.write_raw as 16-bit dumps (one also as a DNG through
   raw_to_rgb --dng, read back within 2/65535); raw_to_rgb per camera on
   the card (EDGE_AWARE, no tone curve, PNG16) into video/color, whose PSNR
   against the mosaicked colors (8 px border out) must reach 30 dB on every
   camera; isp.process on camera 0 and on a noise mosaic in each demosaic
   mode with a full non-identity config on the card and on the CPU (max abs
   difference <= 1e-4, FREQUENCY 1e-3); then dep.main init, depth (render_pipeline's
   resize_images and derp_cli as subprocesses on the card: a farm child
   must see DEP_TORCH_DEVICE unset and the card), depth again (every stage
   cached, no work), export eqrcolor (simple_mesh_renderer) and status
   (0). The farm's level-0 median relative error must stay below 0.05 and
   the export must cover more than 10% of its pixels. The subprocesses'
   kernel launches are not counted: the port has no fallback, so a child
   that runs at all ran K1-K4 on the card;
13. runs the fixture generators, the inspection tools and the viewer in
   process through each CLI's main(), in step 4's tree: (a) rig_simulator
   --scene occluders (its built-in 16-camera ring at 2048x1536, ten 2/3-step
   levels; the render by brute force over the room's 60 triangles, the
   2048x1024 truth equirect by the BVH), derp_cli (K1-K3) and
   compute_rephotography_errors (K4) on it: level-0 median relative error
   < 0.05, TOTAL MSSIM >= 89.95, the JAX bench's readings printed as a
   reference; (b) the production FTHETA shape (make_ftheta_ring_rig(15, 0.33,
   3360x2160, the production distortion), 16 cameras) rendering the sphere
   at 2048x1317 and nine smaller widths, and derp_cli: level-0 error < 0.05
   inside the image circles; (c) render_tools geometric_consistency on
   (a)'s level-0 maps (2 passes; K1 launched, share adjusted printed, error
   still < 0.05), and generate_equirect at 5 m of step 4's sphere tree
   against the true equirect (mean color error < 0.03 over covered
   pixels); (d) conversions: camera 0's level 0 to a point cloud and back
   into cameras 0 and 1, all cameras to equirects and the truth equirect
   back, an OBJ of the truth equirect's disparity; (e) rig_analyzer's
   coverage at 5 m and view_thresholds on cameras 0 and 1; (f) the viewer
   server over step 10's publish: /scene.json, a mesh equal to the port's
   buffer of the fused entries, a color that decodes to the fused RGBA, and
   no device memory allocated. Each phase prints its wall time and peak
   device memory with the card's name and power limit;
14. runs the multi-GPU path (facebook360_dep_tpu_torch/parallel/) on the
   one card. First the references in this process: the sphere scene's
   ten-level pyramid (16 cameras, 2048x1536 down to 50) through
   process_level on all 16 destinations with the mismatch stage from level
   8 (level-0 error < 0.05), and frame 1's level 0 (the colors x 0.9 +
   0.05). Then 4 spawned ranks joined through gloo (NCCL takes one card a
   rank), which only load the kernels step 2 built: (a) each builds the
   context of its 4 destinations only (make_level_context(destinations=))
   and solves them through the pyramid on the ("cam",) mesh, with the
   disparity all-gather before the mismatch stage at levels 8..0, and
   gathers the level-0 maps; (b) on the 2 x 2 ("frame", "cam") mesh each
   builds its 8 destinations' level-0 context and solves one frame's, its
   init (a)'s level-1 maps upsampled. (c) one NCCL rank in this process
   solves level 0 on the camera mesh. Every rank's maps must equal the
   reference's bit for bit, every rank must launch K1-K3 in (a) and K1 and
   K3 in (b) (level 0 runs no K2); each rank prints its wall time, peak
   memory (beside STEP14_PREDICTED_PEAK_GIB), launches and bytes gathered,
   with the backend and the card's name and power limit;
15. holds the port to the reference's oracles and runs the CLIs that
   enlarge images, on the card (tests/torch_oracle.py, the JAX-free copy of
   the CPU tests' oracles): (a) cost_for_disparity against the scalar
   computeCost oracle with the bounds of tests/test_cost_oracle.py: the
   translation rig within 5e-4 (1 + |want|) of the 'perpixel' oracle at
   64x48 (K1 then K2) and 512x384 (K3), the sphere's median gap from the
   'center' oracle < 0.02 (> 90% under 0.2) on the original's 4-camera rig
   at 64x48 and on the 16-camera ring at 256x192 (K1 then K2) and 512x384
   (K3); then K2 against cost.combine_ssds, the sort-based plain combine,
   at 256x192 (confidence equal, cost within 8 float32 ulps of the total
   at all but 1e-4 of the pixels); (b) compute_rephotography_errors of
   step 4's level-1 colors, enlarged, against the level-0 maps (K4; MSSIM
   >= 89.95, printed beside step 7's), upsample_disparity of four cameras'
   level 1 to 2048 with the level-1 colors, and view_thresholds at twice a
   level-1 image's width: each returns and writes finite outputs; (c)
   where g++, pkg-config and opencv4 are on the host, the sphere scene of
   tests/test_ref_solver_oracle.py through the port's solver on the card
   against tools/ref_cpu_baseline.cpp --mini_solver with its bounds (else
   one line says why it did not run). K1-K4 must all launch in it;
16. runs the TPU sampler's semantics (use_pallas_sampler=True, the JAX
   package's Pallas path): (a) the anchor kernel (tile_windows), K1 in TPU
   mode (C = 3 and the mismatch stage's C = 2) and K3 in TPU mode against
   their twins at 256x192, 512x384 and 2048x1536 (step16_kernels' bounds),
   each timed a launch and in a graph beside the default mode's kernel,
   with the clipped share; (b) the sphere's ten-level 16-camera pyramid at
   2048x1536 on TPU-semantics contexts with cost.auto_window's windows
   (the mismatch stage from level 8): level-0 error < 0.05, the share of
   level-0 pixels that differ from the default mode's maps, the clipped
   share per level; every TPU-mode kernel and K2 launched, no default K1
   or K3; (c) step 13b's production FTHETA shape the same way: the window
   per level, the clipped share and the level-0 error inside the image
   circles (< 0.05). (b) and (c) print the digests of their level-0 maps,
   then make one anchor launch a cost evaluation (for all maps) at every
   level, or fail.

Any failure raises (exit code != 0). The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

    python3 chip_smoke.py --profile DIR

also runs the derp_cli and rephotography phases and the chain's foreground
solve under torch.profiler and writes their kernel tables (device and host
time by operator) to DIR/derp_profile.txt, DIR/rephoto_profile.txt and
DIR/derp_foreground_profile.txt.

    python3 chip_smoke.py --solve ROOT OUT [--reference OUT0] [--profile DIR]
                          [--mismatches_start_level L]

builds the kernels, writes the sphere scene's project tree to ROOT unless
it is there, runs derp_cli on it into OUT (with the mismatch stage at
levels L..0 when L >= 0) and prints one JSON line ``{"solve": ...}`` (wall
time, level times, launches, peak memory; with ``--reference``, OUT's
level-0 maps against OUT0's): two checkouts, each with this script,
compared on one tree in one call.

    python3 chip_smoke.py --step14

builds the kernels and runs step 14 alone, printed as one JSON object
``{"step14": ..., "phase_launches": ...}`` (no ``ok`` line).

    python3 chip_smoke.py --step16

builds the kernels and runs step 16 alone, printed as one JSON object
``{"step16": ..., "kernel_table": ..., "phase_launches": ...}`` (no ``ok``
line).

    python3 chip_smoke.py --kernel-digests

builds the kernels and prints the digests of the default-mode K1-K3
outputs and of the anchor kernel's on step 3's inputs
(``{"kernel_digests": ...}``): run with this script in another checkout,
equal digests are equal bits.

    python3 chip_smoke.py --step15

builds the kernels, writes and solves the sphere tree (steps 4-5, 7) and
runs step 15 on it, printed as one JSON object ``{"step15": ...,
"phase_launches": ...}`` (no ``ok`` line).

    python3 chip_smoke.py --kernels-only

builds the kernels and runs step 3 alone: the checks and the per-level
times and bounds, without the launch counts of a solve, printed as one JSON
object ``{"kernel_table": ...}`` (no ``ok`` line: the main path did not
run).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import time

# the card's peaks and the kernels' work: the benchmark's roofline, the one
# definition behind the kernel table's bounds and the cells' k*_roofline_pct
from depbench.roofline import (FP32_FLOP_PER_S, HBM_BYTES_PER_S, PARAM_BYTES, bound_s, k1_flops, k1_work, k2_flops,
                               k2_work, k3_work)

WIDTHS = [2048, 1024, 512, 256, 200, 128, 100, 80, 60, 50]
TWIN_WIDTH = 256  # the level below K3 whose checks are printed in full and whose twins are timed
NUM_CAMERAS = 16
REPO = os.path.dirname(os.path.abspath(__file__))
WARP_PALLAS = "facebook360_dep_tpu/ops/warp_pallas.py"
CSRC = "facebook360_dep_tpu_torch/csrc"


def height(width: int) -> int:
    return (3 * width + 2) // 4  # 1536 at 2048


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def mixed_rig(resolution):
    """16 forward-looking ring cameras cycling through the four camera types,
    each with radial distortion."""
    import numpy as np

    from facebook360_dep_tpu_torch.core import camera as cam

    w, h = resolution
    cams, ids = [], []
    for i in range(NUM_CAMERAS):
        a = 2 * np.pi * i / NUM_CAMERAS
        cams.append(cam.make_camera(
            type_code=i % 4,
            position=[0.3 * np.cos(a), 0.3 * np.sin(a), 0.0],
            rotation=np.eye(3),
            resolution=[w, h],
            focal=[0.45 * w, -0.45 * w],
            distortion=(-0.02 * (1 + i % 3), 0.002, 0.0),
        ))
        ids.append(f"cam{i}")
    return cam.Rig(cameras=cam.stack_cameras(cams), ids=tuple(ids), groups=("",) * NUM_CAMERAS)


def level_inputs(width: int, dev, use_pallas_sampler: bool = False):
    """One level of the solve at a pyramid width, as the solver builds it
    (all 16 cameras as destinations; with the TPU sampler's stack under
    ``use_pallas_sampler``), noisy candidate maps for its 16 destinations,
    the ground truth and the FOV masks."""
    import torch

    from facebook360_dep_tpu_torch.core import camera as cam
    from facebook360_dep_tpu_torch.depth import pipeline, solver
    from facebook360_dep_tpu_torch.render import synthetic

    h = height(width)
    rig = mixed_rig((2048, 1536))
    colors, gt = synthetic.render_sphere_scene(rig, (width, h), radius=5.0, device=dev)
    nrig = cam.normalize_rig(rig)
    fov = pipeline.generate_fov_masks(nrig, (h, width), dev)
    tpu = dict(use_pallas_sampler=True) if use_pallas_sampler else {}  # a checkout before the TPU mode lacks it
    ctx = solver.make_level_context(nrig, nrig, colors, fov, full_height=1536, **tpu)
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = 1.0 + 0.05 * (2.0 * torch.rand((NUM_CAMERAS, h, width), generator=gen, device=dev) - 1.0)
    disp = (torch.nan_to_num(gt, nan=1e-4) * noise).contiguous()
    return ctx, disp, gt, fov


def compare(name, kernel, plain, atol, rtol, max_outlier_frac, quiet=False):
    """max |kernel - plain| over the compared values; raises if more than
    ``max_outlier_frac`` of them exceed atol + rtol * |plain|."""
    import torch

    kernel, plain = kernel.double(), plain.double()
    both_nan = torch.isnan(kernel) & torch.isnan(plain)
    err = torch.where(both_nan, 0.0, (kernel - plain).abs())
    err = torch.nan_to_num(err, nan=math.inf)
    bad = err > atol + rtol * plain.abs().nan_to_num(0.0)
    frac = bad.double().mean().item()
    max_err = err.max().item() if err.numel() else 0.0
    if not quiet or frac > max_outlier_frac:
        log(f"  {name}: max_abs_err {max_err:.3e}, outside tol {frac:.2e} (allowed {max_outlier_frac:.0e})")
    if frac > max_outlier_frac:
        raise AssertionError(f"{name}: {frac:.2e} of values outside atol {atol} rtol {rtol}")
    return max_err


def compare_validity(name, kernel, plain, max_frac, quiet=False):
    frac = (kernel != plain).double().mean().item()
    if not quiet or frac > max_frac:
        log(f"  {name}: validity differs at {frac:.2e} of pixels (allowed {max_frac:.0e})")
    if frac > max_frac:
        raise AssertionError(f"{name}: validity differs at {frac:.2e} of pixels")


# unfused FP32 instructions a second (128 lanes a clock an SM;
# FP32_FLOP_PER_S counts an FMA as two operations) and expf results a
# second (MUFU.EX2, 16 a clock an SM), at the peak's 132 SMs and 1.98 GHz
FP32_ISSUE_PER_S = FP32_FLOP_PER_S / 2
SFU_PER_S = 132 * 16 * 1.98e9


def roofline(nbytes: float, flops: float):
    """(bound ms, "bytes" or "operations"): ``bound_s`` and what binds it."""
    return bound_s(nbytes, flops) * 1e3, ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOP_PER_S
                                          else "operations")


def jb_radius(level: int) -> int:
    """The solver's bilateral radius at a level (solver.spatial_bilateral)."""
    return max(math.ceil(5 * 0.9 ** level), 1)


def jb_work(d, h, w, radius):
    """(bytes, FP32 operations, expf) of one joint_bilateral launch: each
    map's source colors (RGB), disparity and mask read once and its output
    written once; a tap 15 FP32 operations (3 differences, 3 squares, the
    blue weight, 2 sums, the products by 1/3 and 1/(2 sigma^2), the mask
    product, the weight x value and 2 accumulations) and one expf."""
    px = d * h * w
    taps = px * (2 * radius + 1) ** 2
    return 21 * px, 15 * taps, taps


def jb_roofline(nbytes: float, ops: float, exps: float):
    """(bound ms, what binds): the largest of the bytes over the memory
    rate, the FP32 operations over the issue rate and the expf over the
    SFU rate."""
    times = {"bytes": nbytes / HBM_BYTES_PER_S, "FP32 issue": ops / FP32_ISSUE_PER_S, "SFU": exps / SFU_PER_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def chamfer_work(d, h, w):
    """(bytes, FLOPs) of one chamfer_labels launch on d maps: the valid
    flags read once (1 byte a pixel), the forward pass's dist and label
    written and read back (16), the labels written (4); no floating-point
    operation (integer compares and adds). What binds it, each map's chain
    of 2h dependent row steps, has no published rate to set against: step 3
    reports the time a row step took beside the bound."""
    return 21 * d * h * w, 0


def chamfer_valid(rig, width: int, dev):
    """(16, H, W) bool: the foreground init's valid flags at a level of the
    sphere pyramid with the chain's disk at x = 0: where the disk covers the
    level and, nearest-upsampled, the next coarser level (holes where the
    two levels' edges disagree)."""
    import torch

    from facebook360_dep_tpu_torch.core import io

    h = height(width)
    on = render_disk_scene(rig, (width, h), 0.0, dev)[2]
    i = WIDTHS.index(width)
    if i + 1 < len(WIDTHS):
        cw = WIDTHS[i + 1]
        coarse = render_disk_scene(rig, (cw, height(cw)), 0.0, dev)[2]
        iy = torch.from_numpy(io.nearest_index(height(cw), h)).to(dev)
        ix = torch.from_numpy(io.nearest_index(cw, width)).to(dev)
        on = on & coarse.index_select(1, iy).index_select(2, ix)
    return on.contiguous()


def k4_work(n, c, hs, ws, h, w):
    """Sources and coordinates read once, samples and validity written once;
    taps and weights 8 FLOPs a point, a lerp of 6 per channel."""
    return 4 * n * c * hs * ws + 8 * n * h * w + 4 * n * c * h * w + n * h * w, n * h * w * (8 + 6 * c)


def graph_time_ms(fn, inner: int, reps: int = 7) -> float:
    """Device milliseconds per call of ``fn()`` (one kernel launch and its
    outputs' allocation): ``inner`` calls captured in one CUDA graph, whose
    replays are timed with CUDA events (median over ``reps``), over
    ``inner``. The graph takes the host's launch cost out, which at the
    coarse levels exceeds the kernel's time."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    ms = cuda_time_ms(graph.replay, reps, warmup=1) / inner
    del graph
    return ms


def level_row(name, h, w, fn, work, reps, inner, bound_of=roofline):
    """One row of the per-level table; ``fn()`` launches the kernel once;
    ``bound_of(*work)`` is its (bound ms, what binds)."""
    ms = cuda_time_ms(fn, reps)
    graph_ms = graph_time_ms(fn, inner)
    bound_ms, bound_by = bound_of(*work)
    row = dict(shape=f"{w}x{h}", h=h, w=w, ms=ms, graph_ms=graph_ms, bound_ms=bound_ms, bound_by=bound_by,
               share=bound_ms / graph_ms)
    log(f"  {name} {w}x{h}: {ms:.4f} ms a launch, {graph_ms:.4f} ms in a graph, bound {bound_ms:.4f} ms "
        f"({bound_by}), share of the graph time {100 * row['share']:.1f}%")
    return row


# cost evaluations of every level below the coarsest with derp_cli's
# default flags: the start map, 2 random proposals, the 8-candidate star
EVALS_FINE = 1 + 2 + 8
NUM_DEPTHS = 150  # the coarsest level's sweep


def count_level_launches(checks, by_shape, totals):
    """Fill each per-level row's launches a solve from the solve's counts
    by (kernel, H, W), and launches x (graph_ms - bound). Raises unless
    every level saw the launches the batched solve makes there (K1 one a
    cost evaluation of all 16 maps, K2 and K3 one a map and evaluation, the
    joint bilateral one for all maps, the chamfer none: the solve has no
    foreground masks) and no launch fell outside the table."""
    for name in ("project_sample", "ssd_combine", "cost_fused", "joint_bilateral", "chamfer"):
        rows = checks[name]["levels"]
        for row in rows:
            row["launches_per_solve"] = n = by_shape.get((name, row["h"], row["w"]), 0)
            row["lost_ms_per_solve"] = n * (row["graph_ms"] - row["bound_ms"])
            log(f"  {name} {row['shape']}: {n} launches a solve, launches x (graph_ms - bound) "
                f"{row['lost_ms_per_solve']:.2f} ms")
            evals = NUM_DEPTHS if row["w"] == WIDTHS[-1] else EVALS_FINE
            want = {"joint_bilateral": 1, "chamfer": 0, "project_sample": evals}.get(name, NUM_CAMERAS * evals)
            if n != want:
                raise AssertionError(f"{name}: {n} launches at {row['shape']}, expected {want}")
        counted = sum(row["launches_per_solve"] for row in rows)
        if counted != totals[name]:
            raise AssertionError(f"{name}: {counted} launches at the table's shapes, {totals[name]} in all")


def check_kernels(dev):
    """K1-K3 against their twins, and K3 against K1 -> K2 bit for bit, at
    every level shape the sphere solve launches them at (K3 from 512x384
    up, K1 and K2 below), each timed with CUDA events and set against its
    roofline: K1 as one launch sampling all 16 destination maps, K2 and K3
    as one launch for one map; then the joint bilateral kernel, one launch
    for all 16 maps, against its twin bit for bit at every level, and the
    chamfer labels of the foreground init, one launch for the 16 maps,
    equal to its twin at every level. Below K3 the solver's batched cost must equal the 16 single-destination
    calls bit for bit. Tolerances: the kernels and twins round every
    product alike (-fmad=false); what is left is atan2f/sqrt/exp last-ulp
    noise, which flips validity at a sensor or FOV edge for a few pixels
    and, through the bias compensation's cancellation and the
    drop-two-worst choice, moves a few costs."""
    import torch

    from facebook360_dep_tpu_torch.depth import solver
    from facebook360_dep_tpu_torch.ops import cost as cost_ops
    from facebook360_dep_tpu_torch.ops import warp_cuda as wc

    flt_max = cost_ops.FLT_MAX
    results = {k: dict(max_abs_err=0.0, levels=[])
               for k in ("project_sample", "ssd_combine", "cost_fused", "joint_bilateral", "chamfer")}

    def record(name, err, row):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        results[name]["levels"].append(row)

    # ---- K1 / K2 at each level below FUSED_MIN_PIXELS, 16 maps x 16 sources ----
    log("K1 project_sample (C=3 and C=1, all 16 maps) and K2 ssd_combine, every level of the solve below K3:")
    for width in [w for w in WIDTHS if w * height(w) < cost_ops.FUSED_MIN_PIXELS]:
        ctx, disp, gt, fov = level_inputs(width, dev)
        cctx = solver.cost_context(ctx)
        n, hs, ws, _ = ctx.src_rgba.shape
        c = 3
        d, h, w = disp.shape
        quiet = width != TWIN_WIDTH
        planar = wc.planar_view(ctx.src_rgba)
        rest = (ctx.src_params, ctx.dst_cams.position, disp, ctx.dst_rays)
        s_k, v_k = wc.project_sample(ctx.src_rgba, *rest)
        s_p, v_p = wc.project_sample_plain(planar, *rest)
        torch.cuda.synchronize()
        compare_validity(f"K1 {w}x{h} valid", v_k, v_p, 1e-4, quiet)
        both = (v_k & v_p)[:, :, None].expand_as(s_k)
        err1 = compare(f"K1 {w}x{h} sampled", s_k[both], s_p[both], 1e-5, 0.0, 1e-4, quiet)
        # C=1 on a NaN-holding disparity stack, as handle_mismatches samples it
        stack = torch.where(fov, gt, float("nan"))[:, None].clone()
        stack[:, :, :8, :8] = float("nan")
        d_k, dv_k = wc.project_sample_planes(stack, *rest)
        d_p, dv_p = wc.project_sample_plain(stack, *rest)
        torch.cuda.synchronize()
        compare_validity(f"K1 C=1 {w}x{h} valid", dv_k, dv_p, 1e-4, quiet)
        b1 = dv_k & dv_p
        err_c1 = compare(f"K1 C=1 {w}x{h} sampled (NaN taps)", d_k[:, :, 0][b1], d_p[:, :, 0][b1], 1e-7, 1e-5, 1e-4,
                         quiet)
        # the solver's batched cost against its 16 single-destination calls
        cost, conf = cost_ops.cost_for_disparity(cctx, disp)
        for i in range(d):
            one = solver.cost_context(solver.select_destinations(ctx, [i]))
            c1, f1 = cost_ops.cost_for_disparity(one, disp[i:i + 1])
            if not (torch.equal(cost[i:i + 1], c1) and torch.equal(conf[i:i + 1], f1)):
                raise AssertionError(f"batched cost at {w}x{h}: destination {i} differs from its own call")
        if not quiet:
            log(f"  batched cost_for_disparity {w}x{h} bit-identical to the {d} single-destination calls")
        # K2 on the twin's samples of destination 0
        k2_args = (s_p[0], v_p[0], cctx.dst_planar[0], cctx.variance[0], cctx.exclude_idx[0])
        c_k, f_k = wc.ssd_combine(*k2_args)
        c_p, f_p = wc.ssd_combine_plain(*k2_args)
        torch.cuda.synchronize()
        compare_validity(f"K2 {w}x{h} cost finite", c_k < flt_max, c_p < flt_max, 1e-4, quiet)
        fin = (c_k < flt_max) & (c_p < flt_max)
        err2 = compare(f"K2 {w}x{h} cost", c_k[fin], c_p[fin], 1e-6, 1e-4, 1e-4, quiet)
        compare(f"K2 {w}x{h} confidence", f_k, f_p, 0.0, 0.0, 0.0, quiet)
        del s_k, v_k, d_k, dv_k, d_p, dv_p, cost, conf
        row1 = level_row("K1 (16 maps)", h, w, lambda: wc.project_sample(ctx.src_rgba, *rest),
                         k1_work(n, c, hs, ws, h, w, d), 20, 20)
        row2 = level_row("K2", h, w, lambda: wc.ssd_combine(*k2_args), k2_work(n, c, h, w), 20, 50)
        record("project_sample", max(err1, err_c1), row1)
        record("ssd_combine", err2, row2)
        if width == TWIN_WIDTH:  # the representative shape: plain twins' times
            pms1 = cuda_time_ms(lambda: wc.project_sample_plain(planar, *rest), 3, warmup=1)
            pms2 = cuda_time_ms(lambda: wc.ssd_combine_plain(*k2_args), 5)
            ms_c1 = cuda_time_ms(lambda: wc.project_sample_planes(stack, *rest), 20)
            pms_c1 = cuda_time_ms(lambda: wc.project_sample_plain(stack, *rest), 3, warmup=1)
            log(f"  plain twins at {w}x{h}: K1 {pms1:.4f} ms (16 maps), K2 {pms2:.4f} ms; "
                f"K1 C=1 (16 maps) kernel {ms_c1:.4f} ms from the host, plain {pms_c1:.4f} ms")
            results["project_sample"].update(ms=row1["ms"], graph_ms=row1["graph_ms"], plain_ms=pms1,
                                             shape=f"{w}x{h}", maps_a_call=d, c1_max_abs_err=err_c1,
                                             c1_ms=ms_c1, c1_plain_ms=pms_c1)
            results["ssd_combine"].update(ms=row2["ms"], graph_ms=row2["graph_ms"], plain_ms=pms2,
                                          shape=f"{w}x{h}")
        del ctx, cctx, s_p, v_p
        torch.cuda.empty_cache()

    # ---- K3 at each level from FUSED_MIN_PIXELS up, 16 sources, one map;
    # K1 and K3 read the context's interleaved stack ----
    log("K3 cost_fused, every level of the solve from FUSED_MIN_PIXELS up:")
    for width in [w for w in WIDTHS if w * height(w) >= cost_ops.FUSED_MIN_PIXELS]:
        ctx, disp, gt, fov = level_inputs(width, dev)
        cctx = solver.cost_context(ctx)
        n, hs, ws, _ = ctx.src_rgba.shape
        h, w = disp.shape[1:]
        one = (ctx.src_params, ctx.dst_cams.position[0], disp[0], ctx.dst_rays[0])
        dst0 = (cctx.dst_planar[0], cctx.variance[0], cctx.exclude_idx[0])
        k3_args = (ctx.src_rgba,) + one + dst0
        c_k, f_k = wc.cost_fused(*k3_args)
        s12, v12 = wc.project_sample(ctx.src_rgba, *one)
        c_12, f_12 = wc.ssd_combine(s12, v12, *dst0)
        del s12, v12
        torch.cuda.synchronize()
        same = bool(torch.equal(c_k, c_12) and torch.equal(f_k, f_12))
        log(f"  K3 {w}x{h} bit-identical to K1 -> K2: {same}")
        if not same:
            compare(f"K3 {w}x{h} cost vs K1 -> K2", c_k, c_12, 0.0, 0.0, 0.0)
        err = 0.0
        if width == WIDTHS[0]:  # the twin at full width
            plain_args = (wc.planar_view(ctx.src_rgba),) + one + dst0
            c_p, f_p = wc.cost_fused_plain(*plain_args)
            torch.cuda.synchronize()
            compare_validity("K3 cost finite", c_k < flt_max, c_p < flt_max, 1e-4)
            fin = (c_k < flt_max) & (c_p < flt_max)
            err = compare("K3 cost", c_k[fin], c_p[fin], 1e-6, 1e-4, 1e-4)
            compare("K3 confidence", f_k, f_p, 0.0, 0.0, 1e-4)
            pms = cuda_time_ms(lambda: wc.cost_fused_plain(*plain_args), 3, warmup=1)
            log(f"  plain twin at {w}x{h}: {pms:.4f} ms")
            results["cost_fused"].update(plain_ms=pms, shape=f"{w}x{h}")
            del c_p, f_p
        row = level_row("K3", h, w, lambda: wc.cost_fused(*k3_args), k3_work(n, hs, ws, h, w), 20, 10)
        record("cost_fused", err, row)
        if width == WIDTHS[0]:
            results["cost_fused"].update(ms=row["ms"], graph_ms=row["graph_ms"])
        del ctx, cctx, c_k, f_k, c_12, f_12, k3_args
        torch.cuda.empty_cache()
    results["cost_fused"]["bit_identical_to_k1_k2"] = True  # at every level: a difference raises above

    # ---- the joint bilateral of a level: all 16 maps in one launch, at each
    # level's radius, masked by the FOV as derp_cli's solve masks them ----
    log("joint_bilateral (16 maps a launch), every level of the solve at its radius:")
    for level, width in enumerate(WIDTHS):
        ctx, disp, gt, fov = level_inputs(width, dev)
        d, h, w = disp.shape
        radius = jb_radius(level)
        jb_args = (ctx.src_rgba, ctx.dst2src, disp, fov, radius)
        k = wc.joint_bilateral(*jb_args)
        p = wc.joint_bilateral_plain(*jb_args)
        torch.cuda.synchronize()
        same = bool(torch.equal(k.view(torch.int32), p.view(torch.int32)))
        log(f"  joint_bilateral {w}x{h} radius {radius} bit-identical to its twin: {same}")
        if not same:
            compare(f"joint_bilateral {w}x{h}", k, p, 0.0, 0.0, 0.0)
        row = level_row("joint_bilateral (16 maps)", h, w, lambda: wc.joint_bilateral(*jb_args),
                        jb_work(d, h, w, radius), 20, 20, bound_of=jb_roofline)
        row["radius"] = radius
        record("joint_bilateral", 0.0, row)
        if width in (TWIN_WIDTH, WIDTHS[0]):  # the plain twin, 16 maps, at 256x192 and at full width
            pms = cuda_time_ms(lambda: wc.joint_bilateral_plain(*jb_args), 3, warmup=1)
            log(f"  plain twin at {w}x{h}: {pms:.4f} ms (16 maps)")
            if width == TWIN_WIDTH:
                results["joint_bilateral"].update(plain_ms_256=pms, ms_256=row["ms"], graph_ms_256=row["graph_ms"])
            else:
                results["joint_bilateral"].update(ms=row["ms"], graph_ms=row["graph_ms"], plain_ms=pms,
                                                  shape=f"{w}x{h}", maps_a_call=d)
        del ctx, disp, gt, fov, k, p, jb_args
        torch.cuda.empty_cache()
    jb = results["joint_bilateral"]
    jb["bit_identical_to_twin"] = True  # at every level: a difference raises above
    jb["graph_ms_a_solve"] = sum(row["graph_ms"] for row in jb["levels"])
    jb["bound_ms_a_solve"] = sum(row["bound_ms"] for row in jb["levels"])
    log(f"  joint_bilateral over the ten levels: {jb['graph_ms_a_solve']:.4f} ms in graphs, bound "
        f"{jb['bound_ms_a_solve']:.4f} ms, share {100 * jb['bound_ms_a_solve'] / jb['graph_ms_a_solve']:.1f}%")

    # ---- the chamfer labels of the foreground init: all 16 maps of a level
    # in one launch, on the init's valid flags of the chain's disk scene ----
    log("chamfer_labels (16 maps a launch), every level of the pyramid:")
    from facebook360_dep_tpu_torch.render import synthetic

    rig = synthetic.make_test_rig(NUM_CAMERAS, (WIDTHS[0], height(WIDTHS[0])), ring_radius=0.3)
    for width in WIDTHS:
        valid = chamfer_valid(rig, width, dev)
        d, h, w = valid.shape
        k = wc.chamfer_labels(valid)
        p = wc.chamfer_labels_plain(valid)
        torch.cuda.synchronize()
        if not torch.equal(k, p):
            raise AssertionError(f"chamfer_labels {w}x{h}: {int((k != p).sum())} labels differ from the twin's")
        log(f"  chamfer_labels {w}x{h} equal to its twin: True")
        row = level_row("chamfer_labels (16 maps)", h, w, lambda: wc.chamfer_labels(valid), chamfer_work(d, h, w),
                        5, 5)
        row["row_step_us"] = row["graph_ms"] * 1e3 / (2 * h)
        log(f"  chamfer_labels {w}x{h}: {row['row_step_us']:.3f} us a row step in a graph ({2 * h} steps)")
        record("chamfer", 0.0, row)
        if width == WIDTHS[0]:  # the plain twin on the card, 16 maps at full width
            pms = cuda_time_ms(lambda: wc.chamfer_labels_plain(valid), 1, warmup=0)
            log(f"  plain twin at {w}x{h}: {pms:.4f} ms (16 maps)")
            results["chamfer"].update(ms=row["ms"], graph_ms=row["graph_ms"], plain_ms=pms, shape=f"{w}x{h}",
                                      maps_a_call=d, row_step_us=row["row_step_us"])
        del valid, k, p
        torch.cuda.empty_cache()
    ch = results["chamfer"]
    ch["equal_to_twin"] = True  # at every level: a difference raises above
    ch["graph_ms_a_solve"] = sum(row["graph_ms"] for row in ch["levels"])
    log(f"  chamfer_labels over the ten levels: {ch['graph_ms_a_solve']:.4f} ms in graphs")
    for name, r in results.items():
        top = next(row for row in r["levels"] if row["shape"] == r["shape"])
        r.update(bound_ms=top["bound_ms"], bound_by=top["bound_by"], library_ms=None,
                 library="none: no single PyTorch call computes it")
    return results


def check_warp_sample(root: str, out_root: str, dev):
    """K4 against its twin at the render gather's shapes: (16, 4, 1536, 2048)
    planar stack of colors + disparity (NaN taps), coords of a face-1536
    cubemap seen from camera 0 (16 x 6 x 1536^2 points). Built with
    -fmad=false and the twin's lerp order, so expected bit-identical."""
    import torch

    from facebook360_dep_tpu_torch.cli import compute_rephotography_errors as cre
    from facebook360_dep_tpu_torch.core import camera as cam
    from facebook360_dep_tpu_torch.ops import warp_cuda as wc
    from facebook360_dep_tpu_torch.render import dibr

    rig = cam.load_rig(os.path.join(root, "rigs/rig_calibrated.json"))
    colors, disps = cre.load_rig_images(os.path.join(root, "video/color_levels/level_0"),
                                        os.path.join(out_root, "disparity_levels/level_0"), rig, "000000")
    colors, disps = torch.from_numpy(colors).to(dev), torch.from_numpy(disps).to(dev)
    disps[:, 700:760, 900:1000] = float("nan")
    cams = cam.normalize_rig(rig).cameras.to(dev, torch.float32)
    face = colors.shape[1]
    target = dibr.Target("cube", face_size=face)
    center = cams.position[0]
    world = dibr.target_points(dibr.splat_zbuffer(cams, disps, center, target), center, target)
    coords, _ = dibr.gather_coords(cams, world, colors.shape[1:3])
    src = dibr.planar_stack(colors, disps)
    del world, colors, disps
    s_k, v_k = wc.warp_sample_planar(src, coords)
    s_p, v_p = wc.warp_sample_planar_plain(src, coords)
    torch.cuda.synchronize()
    log(f"K4 warp_sample C=4 ({src.shape[0]} sources {src.shape[3]}x{src.shape[2]} -> cube face {face}, "
        f"{coords.shape[1] * coords.shape[2]} points each):")
    same_valid = torch.equal(v_k, v_p)
    same_nan = torch.equal(torch.isnan(s_k), torch.isnan(s_p))
    err = (s_k - s_p).abs().nan_to_num(0.0).max().item()
    bit_identical = same_valid and same_nan and torch.equal(s_k.nan_to_num(-1.0), s_p.nan_to_num(-1.0))
    log(f"  valid share {v_k.double().mean().item():.4f}, NaN samples {torch.isnan(s_k).sum().item()}; "
        f"same valid mask {same_valid}, same NaN positions {same_nan}, max_abs_err {err:.3e}, "
        f"bit-identical {bit_identical}")
    if not (same_valid and same_nan and err <= 1e-6):
        raise AssertionError("K4 warp_sample disagrees with its twin")
    del s_k, s_p, v_k, v_p
    ms = cuda_time_ms(lambda: wc.warp_sample_planar(src, coords), 20)
    pms = cuda_time_ms(lambda: wc.warp_sample_planar_plain(src, coords), 3, warmup=1)
    # the library yardstick, timed only (its NaN taps differ from K4's, so
    # it is not compared): grid_sample at the same points, the grid
    # normalized outside the timed region; x = 2 cx / ws - 1 puts pixel
    # centres where align_corners=False puts them, border = clamp to edge
    n, c, hs, ws = src.shape
    scale = torch.tensor([2.0 / ws, 2.0 / hs], dtype=torch.float32, device=dev)
    grid = coords * scale - 1.0
    lib_ms = cuda_time_ms(lambda: torch.nn.functional.grid_sample(
        src, grid, mode="bilinear", padding_mode="border", align_corners=False), 5, warmup=1)
    del grid
    h, w = coords.shape[1:3]
    bound_ms, bound_by = roofline(*k4_work(n, c, hs, ws, h, w))
    log(f"  time: kernel {ms:.4f} ms, plain {pms:.4f} ms, grid_sample {lib_ms:.4f} ms; "
        f"bound {bound_ms:.4f} ms ({bound_by}), share {100 * bound_ms / ms:.1f}%")
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / ms,
                library_ms=lib_ms, library="torch.nn.functional.grid_sample (bilinear, border, align_corners=False)",
                bit_identical=bit_identical)


def run_rephotography(root: str, out_root: str, profile_dir: str, dev):
    """The port's compute_rephotography_errors on derp_cli's level 0, as
    tests/test_metrics_contract.py:92-98 runs it: TOTAL MSSIM against the
    reference's bar, with the K4 launches, wall time and peak memory."""
    import torch

    from facebook360_dep_tpu_torch.cli import compute_rephotography_errors as cre
    from facebook360_dep_tpu_torch.ops import warp_cuda as wc

    torch.cuda.reset_peak_memory_stats()
    wc.reset_launch_counts()
    t = time.time()
    with profiled(profile_dir, "rephoto"):
        result = cre.main(device=dev, argv=[
            "--color", os.path.join(root, "video/color_levels/level_0"),
            "--disparity", os.path.join(out_root, "disparity_levels/level_0"),
            "--rig", os.path.join(root, "rigs/rig_calibrated.json"),
            "--output", os.path.join(root, "rephoto"), "--first", "000000", "--last", "000000",
        ])
        torch.cuda.synchronize()
    seconds = time.time() - t
    launches = dict(wc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for cam_id, rgb in result["frames"]["000000"]["cameras"].items():
        log(f"  {cam_id} MSSIM: " + ", ".join(f"{c} {100 * v:.2f}%" for c, v in zip("RGB", rgb)))
    mssim = 100 * sum(result["total"]) / 3
    log("rephotography: TOTAL average MSSIM " + ", ".join(f"{c} {100 * v:.2f}%" for c, v in zip("RGB", result["total"]))
        + f" (mean {mssim:.3f}, bar 89.95); {seconds:.2f} s for {len(result['frames']['000000']['cameras'])} "
        f"cameras, peak device memory {peak:.2f} GiB; kernel launches {launches}")
    if launches["warp_sample"] <= 0:
        raise AssertionError("K4 warp_sample never launched by the rephotography run")
    if not mssim >= 90.0 - 0.05:
        raise AssertionError(f"rephotography MSSIM {mssim} below the reference's 89.95")
    return dict(rephoto_mssim=mssim, rephoto_s=seconds, rephoto_peak_gib=peak), launches["warp_sample"]


def run_renderer(root: str, out_root: str, fmt: str, dev):
    """The port's simple_mesh_renderer at its default 2048x1024 on derp_cli's
    level 0; the image must be finite with non-trivial alpha coverage."""
    import torch

    from facebook360_dep_tpu_torch.cli import simple_mesh_renderer as smr
    from facebook360_dep_tpu_torch.ops import warp_cuda as wc

    wc.reset_launch_counts()
    t = time.time()
    records = smr.main([
        "--rig", os.path.join(root, "rigs/rig_calibrated.json"),
        "--color", os.path.join(root, "video/color_levels/level_0"),
        "--disparity", os.path.join(out_root, "disparity_levels/level_0"),
        "--output", os.path.join(root, "render", fmt), "--format", fmt,
    ], device=dev)
    torch.cuda.synchronize()
    seconds = time.time() - t
    rec = records[0]
    log(f"simple_mesh_renderer {fmt}: {seconds:.2f} s, image {rec['shape']}, alpha coverage "
        f"{rec['coverage']:.4f}, finite {rec['finite']}, K4 launches {wc.LAUNCHES['warp_sample']}")
    if wc.LAUNCHES["warp_sample"] <= 0:
        raise AssertionError(f"K4 warp_sample never launched by simple_mesh_renderer {fmt}")
    if not rec["finite"] or not 0.1 < rec["coverage"]:
        raise AssertionError(f"simple_mesh_renderer {fmt}: finite {rec['finite']}, coverage {rec['coverage']}")
    return {f"{fmt}_s": seconds, f"{fmt}_coverage": rec["coverage"], f"{fmt}_k4_launches": wc.LAUNCHES["warp_sample"]}


# bars of the publish and playback phase (step 10): BC7 against its RGBA8,
# the simplified mesh's z against the equi-error grid's, and the played-back
# view against the eqrcolor export of the same solve
BC7_PSNR_BAR_DB = 30.0
MESH_Z_ERR_BAR = 0.01
PLAYBACK_COVERAGE_BAR = 0.90  # of the export's covered share
PLAYBACK_PSNR_BAR_DB = 30.0
TRIANGLES = 150000  # convert_to_binary's default budget


def psnr_db(a, b) -> float:
    """PSNR of two [0, 1] arrays."""
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return math.inf if mse == 0 else 10.0 * math.log10(1.0 / mse)


class _Messages(logging.Handler):
    """Keeps the messages of the records it handles (the simplifier's budget
    warnings, the farm's stage lines)."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def run_publish(root: str, out_root: str, dev):
    """Step 10: the port's convert_to_binary with its defaults (vtx, idx,
    bc7; 150000 triangles; adaptive mesh; fusion) on derp_cli's level 0 and
    the level-0 colors, its checks, the same conversion of two cameras on
    the CPU (byte-identical files), and view_fused at 2048x1024 from the rig
    center against step 8's eqrcolor export. Returns (metrics, K4 launches
    of the playback)."""
    import numpy as np
    import torch

    from facebook360_dep_tpu_torch.cli import compute_rephotography_errors as cre
    from facebook360_dep_tpu_torch.cli import convert_to_binary as ctb
    from facebook360_dep_tpu_torch.cli import simple_mesh_renderer as smr
    from facebook360_dep_tpu_torch.cli import view_fused
    from facebook360_dep_tpu_torch.core import camera as cam
    from facebook360_dep_tpu_torch.core import io
    from facebook360_dep_tpu_torch.ops import warp_cuda as wc
    from facebook360_dep_tpu_torch.stream import async_loader, fusion, mesh, native

    frame = "000000"
    rig_path = os.path.join(root, "rigs/rig_calibrated.json")
    rig = cam.load_rig(rig_path)
    color_dir = os.path.join(root, "video/color_levels/level_0")
    disp_dir = os.path.join(out_root, "disparity_levels/level_0")
    pub = os.path.join(root, "publish")
    bin_dir, fused_dir = os.path.join(pub, "bin"), os.path.join(pub, "fused")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    capture = _Messages()
    logging.getLogger("stream").addHandler(capture)
    t = time.time()
    try:
        conv = ctb.main(["--rig", rig_path, "--bin", bin_dir, "--fused", fused_dir, "--color", color_dir,
                         "--disparity", disp_dir], device=dev)
    finally:
        logging.getLogger("stream").removeHandler(capture)
    convert_wall = time.time() - t
    tasks = {rec["cam_id"]: rec for rec in conv["tasks"]}
    if sorted(tasks) != sorted(rig.ids):
        raise AssertionError(f"convert_to_binary converted {sorted(tasks)}, expected {rig.ids}")

    with open(os.path.join(fused_dir, "fused.json")) as f:
        catalog = json.load(f)
    loader = async_loader.AsyncFrameLoader(fused_dir, catalog)
    try:
        loaded = loader.get(frame)
    finally:
        loader.close()
    log(f"publish: convert_to_binary {convert_wall:.2f} s for {len(rig.ids)} cameras ({conv['convert_s']:.2f} s "
        f"converting on {os.cpu_count()} threads, fusion {conv['fuse_s']:.3f} s)")
    bc7_psnr, z_err, z_cover = {}, {}, {}
    for i, cam_id in enumerate(rig.ids):
        rec = tasks[cam_id]
        stem = os.path.join(bin_dir, cam_id, frame)
        v, f = mesh.read_vtx(stem + ".vtx"), mesh.read_idx(stem + ".idx")
        if not len(f) or int(f.max()) >= len(v):
            raise AssertionError(f"{cam_id}: .idx ({len(f)} faces) does not index its .vtx ({len(v)} vertices)")
        if len(f) > TRIANGLES and not any(f"{len(f)} faces" in m for m in capture.messages):
            raise AssertionError(f"{cam_id}: {len(f)} faces over the budget without the simplifier's warning")
        if not np.isfinite(v).all():
            raise AssertionError(f"{cam_id}: non-finite vertices")
        for ext in (".vtx", ".idx", ".bc7"):
            data = open(stem + ext, "rb").read()
            if fusion.read_fused_entry(fused_dir, catalog, frame, cam_id, ext) != data:
                raise AssertionError(f"{cam_id}{ext}: the fused entry differs from its bin/ file")
            if loaded[(cam_id, ext)] != data:
                raise AssertionError(f"{cam_id}{ext}: AsyncFrameLoader's read differs from its bin/ file")
        color = io.read_color(io.frame_path(os.path.join(color_dir, cam_id), frame))
        h4, w4 = color.shape[0] // 4 * 4, color.shape[1] // 4 * 4
        rgba = ctb.gamma_correct_to_rgba8(color[:h4, :w4], 2.2 / 1.8)
        decoded = native.decompress_bc7(np.fromfile(stem + ".bc7", np.uint8), w4, h4)
        bc7_psnr[cam_id] = psnr_db(decoded[..., :3] / 255.0, rgba[..., :3] / 255.0)
        disp = io.read_disparity(io.frame_path(os.path.join(disp_dir, cam_id), frame))
        h, w = disp.shape
        camera = rig.camera(i)
        with np.errstate(divide="ignore", invalid="ignore"):
            z = np.float32(float(camera.focal[0])) / (np.float32(1.0) / disp)  # the equi-error grid's z
            zr = native.rasterize_mesh(v, f, w, h, w / float(camera.resolution[0]), h / float(camera.resolution[1]))
            both = np.isfinite(zr) & np.isfinite(z)
            z_err[cam_id] = float(np.median(np.abs(zr[both] - z[both]) / np.abs(z[both])))
        z_cover[cam_id] = float(np.isfinite(zr).mean())
        log(f"  {cam_id}: {rec['vertices']} vertices, {rec['faces']} faces; mesh {rec['mesh_s']:.2f} s, color "
            f"{rec['color_s']:.2f} s; BC7 PSNR {bc7_psnr[cam_id]:.2f} dB; rasterized mesh covers "
            f"{z_cover[cam_id]:.4f} (finite z {np.isfinite(z).mean():.4f}), median relative z error "
            f"{z_err[cam_id]:.5f}")
    mean_psnr = float(np.mean(list(bc7_psnr.values())))
    worst_z = max(z_err.values())
    budget = [m for m in capture.messages if "budget not reached" in m]
    log(f"publish: BC7 mean PSNR {mean_psnr:.3f} dB (bar {BC7_PSNR_BAR_DB}); mesh median relative z error "
        f"worst {worst_z:.5f} (bar {MESH_Z_ERR_BAR}); faces max {max(r['faces'] for r in tasks.values())} "
        f"(budget {TRIANGLES}); simplifier warnings {budget}")
    if not mean_psnr >= BC7_PSNR_BAR_DB:
        raise AssertionError(f"BC7 mean PSNR {mean_psnr} dB below {BC7_PSNR_BAR_DB}")
    if not worst_z <= MESH_Z_ERR_BAR:
        raise AssertionError(f"mesh median relative z error {worst_z} above {MESH_Z_ERR_BAR}")

    # the same conversion of two cameras on the CPU: the same bytes
    t = time.time()
    cpu_bin = os.path.join(pub, "bin_cpu")
    two = rig.ids[:2]
    ctb.main(["--rig", rig_path, "--bin", cpu_bin, "--color", color_dir, "--disparity", disp_dir,
              "--cameras", ",".join(two)], device="cpu")
    for cam_id in two:
        for ext in (".vtx", ".idx", ".bc7", ".meta.json"):
            a, b = (open(os.path.join(d, cam_id, frame + ext), "rb").read() for d in (bin_dir, cpu_bin))
            if a != b:
                raise AssertionError(f"{cam_id}{ext}: the card's conversion differs from the CPU's")
    cpu_s = time.time() - t
    log(f"publish: {', '.join(two)} converted on the CPU in {cpu_s:.2f} s, byte-identical to the card's")

    wc.reset_launch_counts()
    t = time.time()
    played = view_fused.main(["--rig", rig_path, "--catalog", os.path.join(fused_dir, "fused.json"),
                              "--output", os.path.join(pub, "view"), "--width", "2048", "--height", "1024"],
                             device=dev)[0]
    if cuda:
        torch.cuda.synchronize()
    playback_s = time.time() - t
    k4 = wc.LAUNCHES["warp_sample"]
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    if cuda and k4 <= 0:
        raise AssertionError("K4 warp_sample never launched by view_fused")
    # step 8's eqrcolor export of the same solve; its alpha re-rendered
    # from the same inputs (outside the counted run)
    export = io.read_color(os.path.join(root, "render", "eqrcolor", frame + ".png"))
    colors, disps = cre.load_rig_images(color_dir, disp_dir, rig, frame)
    _, ref_alpha = smr.render_format("eqrcolor", rig, torch.from_numpy(colors).to(dev),
                                     torch.from_numpy(disps).to(dev), 2048, 1024, 0.064, [0.0, 0.0, 0.0])
    ref_alpha = ref_alpha.cpu().numpy()
    view = io.read_color(played["path"])
    both = played["alpha"] & ref_alpha
    cover_ratio = played["coverage"] / float(ref_alpha.mean())
    play_psnr = psnr_db(view[both], export[both])
    log(f"playback: view_fused {playback_s:.2f} s at 2048x1024, K4 launches {k4}; covered {played['coverage']:.4f} "
        f"against the export's {ref_alpha.mean():.4f} (ratio {cover_ratio:.4f}, bar {PLAYBACK_COVERAGE_BAR}); "
        f"PSNR over pixels both cover {play_psnr:.3f} dB (bar {PLAYBACK_PSNR_BAR_DB}); finite {played['finite']}")
    mesh_s = sum(r["mesh_s"] for r in tasks.values())
    color_s = sum(r["color_s"] for r in tasks.values())
    log(f"publish stage times: mesh + simplify {mesh_s:.2f} s, BC7 {color_s:.2f} s (thread-seconds, summed over "
        f"the {len(tasks)} tasks), conversion {conv['convert_s']:.2f} s wall = "
        f"{conv['convert_s'] / len(tasks):.3f} s per frame-camera, fusion {conv['fuse_s']:.3f} s, "
        f"playback {playback_s:.2f} s; peak device memory {peak:.2f} GiB")
    if not played["finite"] or not cover_ratio >= PLAYBACK_COVERAGE_BAR:
        raise AssertionError(f"playback covers {cover_ratio} of the export (finite {played['finite']})")
    if not play_psnr >= PLAYBACK_PSNR_BAR_DB:
        raise AssertionError(f"playback PSNR {play_psnr} dB against the export below {PLAYBACK_PSNR_BAR_DB}")
    metrics = dict(publish_convert_s=conv["convert_s"], publish_mesh_thread_s=mesh_s, publish_bc7_thread_s=color_s,
                   publish_fuse_s=conv["fuse_s"], publish_s_per_frame_camera=conv["convert_s"] / len(tasks),
                   publish_cpu_two_cameras_s=cpu_s, publish_max_faces=max(r["faces"] for r in tasks.values()),
                   publish_bc7_psnr_db=mean_psnr, publish_mesh_z_err_worst=worst_z,
                   publish_mesh_coverage_min=min(z_cover.values()), playback_s=playback_s,
                   playback_coverage=played["coverage"], playback_coverage_ratio=cover_ratio,
                   playback_psnr_db=play_psnr, publish_peak_gib=peak)
    return metrics, k4


# step 11's bars: the reference's --max_error for the image-matched solve and
# tests/test_features.py's share of the injected rotation it must remove;
# tests/test_calibration.py:67-75's median for artificial points with 0.5 px
# of noise
CALIB_MATCHED_MEDIAN_BAR = 0.5
CALIB_FORWARD_SHARE_BAR = 0.65
CALIB_ARTIFICIAL_MEDIAN_BAR = 0.8
# card against CPU on (b): the largest differences of the two solved rigs
# (positions are locked) and of their medians, ~2000x what a first run on
# the card measured (rotation 2.0e-12, principal 4.7e-6 px, focal 7.4e-6 px,
# median 1.0e-11 px): the card's float64 scatter-adds sum in another order
# from run to run, and the LM's accept test may then flip
CALIB_CARD_CPU_TOLERANCE = dict(position=1e-9, rotation=1e-8, principal=0.01, focal=0.01, median=1e-8)


def gauge_aligned_forward_rmse(rig, truth) -> float:
    """RMSE of the cameras' forward vectors against the truth's after the
    best common rotation (tests/test_features.py): with positions locked, a
    rotation of the whole rig is nearly free on a small-baseline ring."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    from facebook360_dep_tpu_torch.core import camera as cam

    fa = -cam.camera_to_numpy(rig.cameras).rotation[:, 2]
    fb = -cam.camera_to_numpy(truth.cameras).rotation[:, 2]
    rot, _ = Rotation.align_vectors(fb, fa)
    return float(np.sqrt(np.mean(np.sum((rot.apply(fa) - fb) ** 2, -1))))


def rig_difference(a, b) -> dict:
    """Largest absolute differences of two rigs' solved fields."""
    import numpy as np

    from facebook360_dep_tpu_torch.core import camera as cam

    ca, cb = cam.camera_to_numpy(a.cameras), cam.camera_to_numpy(b.cameras)
    return {f: float(np.abs(getattr(ca, f) - getattr(cb, f)).max())
            for f in ("position", "rotation", "principal", "focal")}


def run_calibration(root: str, dev):
    """Step 11: the port's calibration CLIs on the sphere tree at ``root``.
    (a) cli/calibration.main (match corners, then the 10-pass solve) on the
    16 level-0 colors with --perturb_rotations 0.02 and the intrinsics
    locked; (b) main_geometric on 10,000 artificial points with 0.5 px of
    noise, --perturb_rotations 0.01 --perturb_principals 2, on the card and
    again on the CPU. Returns the metrics."""
    import numpy as np
    import torch

    from facebook360_dep_tpu_torch.cli import calibration as calib_cli
    from facebook360_dep_tpu_torch.core import camera as cam

    rig_path = os.path.join(root, "rigs/rig_calibrated.json")
    out = os.path.join(root, "calibration")
    truth = cam.load_rig(rig_path)

    def solve(name, entry, argv, device):
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        timings = {}
        t = time.time()
        median = getattr(calib_cli, entry)(argv, device=device, timings=timings)
        if device != "cpu":
            torch.cuda.synchronize()
        seconds = time.time() - t
        peak = torch.cuda.max_memory_allocated() / 2**30 if device != "cpu" else None
        log(f"calibration {name} on {device}: {seconds:.2f} s, median {median:.4f} px, pass medians "
            f"{[round(m, 4) for m in timings['pass_medians']]}; stage s "
            f"{ {k: round(v, 3) for k, v in timings.items() if k != 'pass_medians'} }"
            + (f"; peak device memory {peak:.3f} GiB" if peak is not None else ""))
        return dict(seconds=seconds, median=median, pass_medians=timings["pass_medians"], peak_gib=peak,
                    stage_s={k: v for k, v in timings.items() if k != "pass_medians"})

    matched = solve("(a) image-matched", "main", [
        "--color", os.path.join(root, "video/color_levels/level_0"), "--rig_in", rig_path,
        "--matches", os.path.join(out, "matches.json"), "--rig_out", os.path.join(out, "rig_matched.json"),
        "--min_depth_m", "1", "--max_depth_m", "100", "--perturb_rotations", "0.02",
        "--lock_principals", "true", "--lock_focal", "true"], str(dev))
    with open(os.path.join(out, "matches.json")) as f:
        matches = json.load(f)
    corners = [len(v) for v in matches["images"].values()]
    matched.update(corners_total=sum(corners), corners_min=min(corners), corners_max=max(corners),
                   pairs=len(matches["all_matches"]),
                   matches=sum(len(m["matches"]) for m in matches["all_matches"]))
    before = gauge_aligned_forward_rmse(cam.perturb_cameras(truth, rot_amount=0.02, seed=0), truth)
    after = gauge_aligned_forward_rmse(cam.load_rig(os.path.join(out, "rig_matched.json")), truth)
    matched.update(forward_rmse_perturbed=before, forward_rmse_solved=after)
    log(f"  corners {matched['corners_total']} ({matched['corners_min']}-{matched['corners_max']} a camera), "
        f"{matched['matches']} matches over {matched['pairs']} pairs; gauge-aligned forward RMSE "
        f"{before:.5f} -> {after:.5f} ({after / before:.3f} of the perturbed rig's, bar "
        f"{CALIB_FORWARD_SHARE_BAR}); median bar {CALIB_MATCHED_MEDIAN_BAR}")
    if not (matched["median"] <= CALIB_MATCHED_MEDIAN_BAR and after <= CALIB_FORWARD_SHARE_BAR * before):
        raise AssertionError(f"image-matched calibration: median {matched['median']}, forward RMSE "
                             f"{before} -> {after}")

    artificial_argv = ["--rig_in", rig_path, "--point_error_stddev", "0.5", "--perturb_rotations", "0.01",
                       "--perturb_principals", "2"]
    card = solve("(b) 10,000 artificial points", "main_geometric",
                 artificial_argv + ["--rig_out", os.path.join(out, "rig_artificial.json")], str(dev))
    cpu = solve("(b) 10,000 artificial points", "main_geometric",
                artificial_argv + ["--rig_out", os.path.join(out, "rig_artificial_cpu.json")], "cpu")
    diff = rig_difference(cam.load_rig(os.path.join(out, "rig_artificial.json")),
                          cam.load_rig(os.path.join(out, "rig_artificial_cpu.json")))
    diff["median"] = abs(card["median"] - cpu["median"])
    log(f"  card against CPU: largest differences {diff} (tolerance {CALIB_CARD_CPU_TOLERANCE})")
    if not card["median"] < CALIB_ARTIFICIAL_MEDIAN_BAR:
        raise AssertionError(f"artificial-points calibration: median {card['median']}")
    if any(diff[k] > tol for k, tol in CALIB_CARD_CPU_TOLERANCE.items()):
        raise AssertionError(f"artificial-points calibration: card and CPU rigs differ: {diff}")
    return dict(calib_matched=matched, calib_artificial=card, calib_artificial_cpu=cpu,
                calib_card_vs_cpu=diff)


# step 12's bars: the ISP's PSNR against the colors it was mosaicked from
# (interior, ISP_BORDER_PX out), card against CPU per demosaic mode, and the
# DNG's round trip (one 16-bit step of rounding each way)
ISP_PSNR_BAR_DB = 30.0
ISP_BORDER_PX = 8
ISP_CARD_CPU_TOLERANCE = {"BILINEAR": 1e-4, "EDGE_AWARE": 1e-4, "FREQUENCY": 1e-3, "CHROMA_SUPPRESSED": 1e-4}
DNG_TOLERANCE = 2.0 / 65535
ISP_PATTERN = "GBRG"  # IspConfig's default
ISP_NOISE_SEED = 0
# every stage of process() away from identity (stuck pixels with r = 1)
ISP_FULL_CONFIG = dict(
    bayer_pattern=ISP_PATTERN, companding_lut=[(0.0, 0.0), (0.25, 0.3), (0.75, 0.8), (1.0, 1.0)],
    black_level=(0.02, 0.03, 0.02), white_balance_gain=(1.1, 1.0, 1.2), clamp_max=(0.98, 0.99, 0.97),
    vignette_roll_off_h=[(0.9, 0.92, 0.9), (1.0, 1.0, 1.0), (0.9, 0.92, 0.9)],
    vignette_roll_off_v=[(0.95, 0.95, 0.94), (1.0, 1.0, 1.0), (0.95, 0.95, 0.94)],
    ccm=((1.2, -0.1, -0.1), (-0.15, 1.3, -0.15), (0.0, -0.25, 1.25)), saturation=1.1,
    gamma=(0.9, 0.85, 0.9), contrast=1.05, low_key_boost=(0.05, 0.02, 0.05), high_key_boost=(-0.03, 0.0, 0.02),
    sharpening=(0.2, 0.3, 0.2), stuck_pixel_radius=1, stuck_pixel_threshold=0.3,
    stuck_pixel_darkness_threshold=0.05)


def isp_card_against_cpu(mosaic0, dev):
    """Step 12(3): isp.process on the card and on the CPU in each demosaic
    mode with ISP_FULL_CONFIG, on camera 0's mosaic with a stuck sensel every
    97th and on a mosaic of uniform noise from ISP_NOISE_SEED (the sphere's
    gradients are small, so a homogeneity vote that flipped would move it
    less); returns {mode: (max abs difference of the two, card seconds on
    camera 0)}."""
    import numpy as np
    import torch

    from facebook360_dep_tpu_torch.isp import pipeline as isp

    raw = mosaic0.clone().cpu()
    raw.view(-1)[::97] = 1.0
    noise = torch.from_numpy(np.random.default_rng(ISP_NOISE_SEED).random(tuple(raw.shape), dtype=np.float32))
    raw_card = raw.to(dev)
    out = {}
    for mode in isp.DEMOSAIC_FILTERS:
        cfg = isp.IspConfig(**ISP_FULL_CONFIG, demosaic_filter=mode)
        cpu = isp.process(raw, cfg)
        times = []
        for _ in range(4):  # the first warms up (cuFFT plans, allocator)
            torch.cuda.synchronize()
            t = time.perf_counter()
            card = isp.process(raw_card, cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        seconds = sorted(times[1:])[1]
        err = float((card.cpu() - cpu).abs().max())
        err_noise = float((isp.process(noise.to(dev), cfg).cpu() - isp.process(noise, cfg)).abs().max())
        log(f"  isp.process {mode}: card against CPU max abs difference {err:.3e} on camera 0, {err_noise:.3e} "
            f"on noise (tolerance {ISP_CARD_CPU_TOLERANCE[mode]:g}), card {seconds * 1e3:.2f} ms at "
            f"{raw.shape[1]}x{raw.shape[0]}")
        if not max(err, err_noise) <= ISP_CARD_CPU_TOLERANCE[mode]:
            raise AssertionError(f"isp.process {mode}: card and CPU differ by {err} on camera 0, {err_noise} on noise")
        out[mode] = (max(err, err_noise), seconds)
    return out


def run_shoot(tmp: str, rig, gt0, dev):
    """Step 12: a shoot from RAW frames through the project driver on the
    card. The 16 level-0 colors of step 4's sphere scene are mosaicked
    (GBRG) and written as 16-bit RAW dumps; raw_to_rgb (EDGE_AWARE, no tone
    curve, PNG16) makes the project's color frames; dep init, depth (twice:
    the second must find every chunk cached), export eqrcolor and status run
    the farm's subprocess stages on the card. Returns the metrics."""
    import shutil

    import numpy as np
    import torch

    from facebook360_dep_tpu_torch.cli import DEVICE_ENV, dep, raw_to_rgb
    from facebook360_dep_tpu_torch.core import camera as cam, imagetypes, io, rawio
    from facebook360_dep_tpu_torch.farm import runner
    from facebook360_dep_tpu_torch.isp import pipeline as isp
    from facebook360_dep_tpu_torch.render import synthetic

    w, h = WIDTHS[0], height(WIDTHS[0])
    project = os.path.join(tmp, "shoot")
    raw_dir = os.path.join(tmp, "raw")
    os.makedirs(raw_dir)
    os.makedirs(os.path.join(project, "rigs"))
    cam.save_rig(os.path.join(project, "rigs/rig_calibrated.json"), rig)
    isp_json = os.path.join(raw_dir, "isp.json")
    with open(isp_json, "w") as f:
        json.dump({"CameraIsp": {"bitsPerPixel": 16, "width": w, "height": h, "bayerPattern": ISP_PATTERN}}, f)

    # (1) the RAW frames, and one DNG read back
    colors, _ = synthetic.render_sphere_scene(rig, (w, h), radius=5.0, device=dev)
    mosaics = [isp.mosaic(c, ISP_PATTERN) for c in colors]
    for cam_id, m in zip(rig.ids, mosaics):
        rawio.write_raw(os.path.join(raw_dir, cam_id + ".raw"), m.cpu().numpy(), 16)
    dng = os.path.join(tmp, "cam0.dng")
    raw_to_rgb.main(["--input_image_path", os.path.join(raw_dir, rig.ids[0] + ".raw"), "--output_image_path", dng,
                     "--isp_config_path", isp_json, "--dng"], device=dev)
    back, _ = rawio.read_dng(dng)
    dng_err = float(np.abs(back - mosaics[0].cpu().numpy()).max())
    log(f"  DNG of {rig.ids[0]} read back within {dng_err:.3e} (tolerance {DNG_TOLERANCE:.3e})")
    if not dng_err <= DNG_TOLERANCE:
        raise AssertionError(f"DNG round trip: {dng_err}")

    # (2) the ISP into the project's color tree; the shoot's background
    # frame (dep init makes background/color, which verify_data then
    # requires for every camera) is the same static sphere
    isp_s, psnr = [], []
    b = ISP_BORDER_PX
    for i, cam_id in enumerate(rig.ids):
        out_png = imagetypes.gen_filename(project, "color", None, cam_id, "000000", "png")
        os.makedirs(os.path.dirname(out_png))
        t = time.time()
        raw_to_rgb.main(["--input_image_path", os.path.join(raw_dir, cam_id + ".raw"),
                         "--output_image_path", out_png, "--isp_config_path", isp_json,
                         "--demosaic_filter", "EDGE_AWARE", "--apply_tone_curve", "false", "--output_bpp", "16"],
                        device=dev)
        isp_s.append(time.time() - t)
        psnr.append(psnr_db(io.read_color(out_png)[b:-b, b:-b], colors[i].cpu().numpy()[b:-b, b:-b]))
        background = imagetypes.gen_filename(project, "background_color", None, cam_id, "000000", "png")
        os.makedirs(os.path.dirname(background), exist_ok=True)
        shutil.copyfile(out_png, background)
    log(f"raw_to_rgb (step 12): {sum(isp_s):.2f} s for {len(isp_s)} cameras, "
        f"{[round(s, 3) for s in isp_s]} s a camera; PSNR against the mosaicked colors mean "
        f"{np.mean(psnr):.2f} dB, least {min(psnr):.2f} dB (bar {ISP_PSNR_BAR_DB})")
    if not min(psnr) >= ISP_PSNR_BAR_DB:
        raise AssertionError(f"ISP PSNR {psnr}")

    # (3) the card against the CPU, every demosaic mode, full config
    modes = isp_card_against_cpu(mosaics[0], dev)
    del colors, mosaics
    torch.cuda.empty_cache()

    # (4) the project driver: its stages are subprocesses that must run on
    # the card, so the device variable is unset here, and a child the farm
    # runner starts must see it unset and see the card
    if DEVICE_ENV in os.environ:
        raise AssertionError(f"{DEVICE_ENV} is set: {os.environ[DEVICE_ENV]}")
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p)
    probe = os.path.join(tmp, "child_env.json")
    runner.Pipeline().run_stage(runner.Stage(
        name="child_env", outputs=lambda c: [probe],
        command=lambda c: [sys.executable, "-c",
                           "import json, os, sys, torch; json.dump({'env': os.environ.get(sys.argv[2]), "
                           "'cuda': torch.cuda.is_available()}, open(sys.argv[1], 'w'))", probe, DEVICE_ENV]),
        runner.chunk_frames(0, 0, 1))
    with open(probe) as f:
        child = json.load(f)
    log(f"  a farm child's environment: {DEVICE_ENV}={child['env']}, torch.cuda.is_available() {child['cuda']}")
    if child["env"] is not None or not child["cuda"]:
        raise AssertionError(f"farm child: {child}")

    records = _Messages()
    logging.getLogger("farm").addHandler(records)
    common = ["--project_root", project, "--first", "000000", "--last", "000000",
              "--resolution", str(WIDTHS[0]), "--min_depth_m", "1", "--max_depth_m", "100"]
    steps = [("init", ["init", "--project_root", project]), ("depth", ["depth", *common]),
             ("depth again", ["depth", *common]), ("export", ["export", *common, "--format", "eqrcolor"]),
             ("status", ["status", "--project_root", project])]
    dep_s, stage_lines = {}, {}
    try:
        for name, argv in steps:
            records.messages.clear()
            t = time.time()
            rc = dep.main(argv)
            dep_s[name] = time.time() - t
            stage_lines[name] = [m for m in records.messages if m.startswith(("done:", "==="))
                                 or "cached" in m]
            log(f"dep {name}: {dep_s[name]:.2f} s, rc {rc}; " + "; ".join(stage_lines[name]))
            if rc not in (0, None):
                raise AssertionError(f"dep {name} returned {rc}")
            if name == "depth again":  # every stage listed finds its one chunk cached
                listed = [m for m in records.messages if m.startswith("=== stage")]
                cached = [m for m in records.messages if m.endswith("1/1 chunks cached, skipping")]
                ran = [m for m in records.messages if m.startswith("done:")]
                if ran or not listed or len(cached) != len(listed):
                    raise AssertionError(f"the resumed depth run did work: {records.messages}")
    finally:
        logging.getLogger("farm").removeHandler(records)

    # (5) the farm's solve and export
    med, coverage, rmse = check_level0(project, rig, gt0)
    export = io.read_color(os.path.join(imagetypes.image_dir(project, "exports_eqrcolor"), "000000.png"))
    export_cov = float((export[..., :3].max(axis=-1) > 0).mean())  # uncovered pixels are written black
    log(f"  eqrcolor export {export.shape}, finite {bool(np.isfinite(export).all())}, covered share "
        f"{export_cov:.4f}")
    if export.shape[:2] != (1024, 2048) or not np.isfinite(export).all() or not export_cov > 0.1:
        raise AssertionError(f"eqrcolor export {export.shape}: covered share {export_cov}")
    return dict(shoot_isp_s=isp_s, shoot_isp_psnr_db=psnr, shoot_dng_err=dng_err,
                shoot_isp_card_vs_cpu={m: e for m, (e, _) in modes.items()},
                shoot_isp_card_s={m: s for m, (_, s) in modes.items()}, shoot_dep_s=dep_s,
                shoot_stage_lines=stage_lines, shoot_level0_median_rel_err=med, shoot_level0_coverage=coverage,
                shoot_level0_covered_rel_rmse=rmse, shoot_export_covered_share=export_cov)


# step 13's bars: the repo's level-0 bar (steps 5, 9) and, for
# render_tools generate_equirect at the sphere's radius, the mean color error
# over the covered pixels that tests/test_torch_inspect_cli.py holds the CPU
# to; the JAX bench's readings for its occluder room (BENCH_r05.json tail,
# make_test_rig at ring 0.3, seed 11) printed beside the port's as a
# reference, not a bar
LEVEL0_BAR = 0.05
EQUIRECT_COLOR_BAR = 0.03
JAX_OCCLUDER_REFERENCE = "covered rel RMSE 0.0258 over 99.4%, MSSIM 99.80"
FTHETA_RESOLUTION = (3360, 2160)  # the production rig's 14:9 sensors


def _phase_start():
    import torch

    from facebook360_dep_tpu_torch.ops import warp_cuda as wc

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wc.reset_launch_counts()
    return time.time()


def _phase_end(name: str, t: float, smi: str):
    """Wall time of the phase begun at ``t``, printed with its peak device
    memory; returns (seconds, the kernel launches counted since the start)."""
    import torch

    from facebook360_dep_tpu_torch.ops import warp_cuda as wc

    torch.cuda.synchronize()
    seconds = time.time() - t
    log(f"{name}: {seconds:.2f} s, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
    return seconds, dict(wc.LAUNCHES)


def _level_dir(out_root: str, cam_id: str) -> str:
    from facebook360_dep_tpu_torch.core import imagetypes

    return os.path.dirname(os.path.dirname(
        imagetypes.gen_filename(out_root, "disparity_levels", 0, cam_id, "000000", "pfm")))


def _read_maps(directory: str, ids):
    import numpy as np

    from facebook360_dep_tpu_torch.core import io

    return np.stack([io.read_disparity(os.path.join(directory, c, "000000.pfm")) for c in ids])


def level0_error_in(maps, truth, mask, name: str):
    """Median relative error of finite interior pixels inside ``mask``, the
    finite share of ``mask`` and the covered relative RMSE; raises above
    LEVEL0_BAR."""
    import numpy as np

    inside = np.where(mask, maps, np.nan)
    med, _ = relative_error(inside, truth)
    ok = np.isfinite(inside)
    coverage = float(ok.sum() / max(mask.sum(), 1))
    rmse = float(np.sqrt(np.mean((inside[ok] - truth[ok]) ** 2)) / np.mean(truth[ok]))
    log(f"  {name}: median relative disparity error {med:.5f} (bar {LEVEL0_BAR}), coverage {coverage:.4f}, "
        f"covered relative RMSE {rmse:.5f}")
    if not np.isfinite(med) or med >= LEVEL0_BAR:
        raise AssertionError(f"{name}: level-0 median relative error {med}")
    return med, coverage, rmse


def run_occluder_room(tmp: str, dev, smi: str):
    """Step 13 (a): rig_simulator's occluder room (its built-in 16-camera
    ring at 2048x1536, ten 2/3-step levels, the 2048x1024 truth equirect),
    derp_cli and compute_rephotography_errors on it. Returns (root, output
    root, rig, truth, metrics, launches by phase)."""
    import numpy as np

    from facebook360_dep_tpu_torch.cli import rig_simulator
    from facebook360_dep_tpu_torch.core import camera as cam
    from facebook360_dep_tpu_torch.render import raytrace

    root = os.path.join(tmp, "occluders")
    out_root = os.path.join(root, "out")
    t = _phase_start()
    rig_simulator.main(["--dest", root, "--scene", "occluders", "--num_occluders", "4", "--resolution", str(WIDTHS[0]),
                        "--num_cameras", str(NUM_CAMERAS), "--levels", str(len(WIDTHS)), "--eqr_width", str(WIDTHS[0])],
                       device=dev)
    sim_s, _ = _phase_end("rig_simulator --scene occluders (step 13a)", t, smi)
    rig = cam.load_rig(os.path.join(root, "rigs/rig_calibrated.json"))
    truth = _read_maps(os.path.join(root, "truth"), rig.ids)
    if truth.shape != (NUM_CAMERAS, height(WIDTHS[0]), WIDTHS[0]) or not np.isfinite(truth).all():
        raise AssertionError(f"occluder truth {truth.shape}, finite {np.isfinite(truth).all()}")
    log(f"  truth disparity {truth.min():.4f}..{truth.max():.4f} (the walls >= 1/6.7, occluders nearer)")
    # the simulator's two raytraces alone: frame 0's room (seed 7), by brute
    # force into the rig and by the BVH into the equirect
    mesh = raytrace.box_room_with_occluders(seed=7, num_occluders=4)
    t = _phase_start()
    _, disp = raytrace.render_mesh_scene(rig, (WIDTHS[0], height(WIDTHS[0])), mesh, device=dev)
    render_s, _ = _phase_end(f"  raytrace.render_mesh_scene, {NUM_CAMERAS} cameras by brute force", t, smi)
    t = _phase_start()
    _, edisp = raytrace.ground_truth_equirect_mesh(mesh, WIDTHS[0], WIDTHS[0] // 2, device=dev)
    eqr_s, _ = _phase_end(f"  raytrace.ground_truth_equirect_mesh, {WIDTHS[0]}x{WIDTHS[0] // 2} by the BVH", t, smi)
    same = np.array_equal(disp.cpu().numpy(), truth)
    log(f"  the render equals the simulator's truth: {same}; equirect finite {bool(edisp.isfinite().all())}")
    if not same or not bool(edisp.isfinite().all()):
        raise AssertionError("the occluder room's raytrace differs from the simulator's truth, or leaks")

    solve_s, est, launches, _ = run_solve(root, out_root, "", dev)
    missing = [k for k in ("project_sample", "ssd_combine", "cost_fused") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched by the occluder solve: {missing}")
    log(f"  level sizes {sorted(est.level_sizes.values(), reverse=True)}")
    maps = _read_maps(_level_dir(out_root, rig.ids[0]), rig.ids)
    med, coverage, rmse = level0_error_in(maps, truth, np.ones(truth.shape, bool), "occluder room level 0")
    log(f"  the JAX bench's occluder room, for reference (not a bar): {JAX_OCCLUDER_REFERENCE}")
    rephoto, k4 = run_rephotography(root, out_root, "", dev)
    metrics = dict(occ_simulator_s=sim_s, occ_raytrace_s=render_s, occ_raytrace_eqr_s=eqr_s, occ_derp_cli_s=solve_s, occ_level0_median_rel_err=med,
                   occ_level0_coverage=coverage, occ_level0_covered_rel_rmse=rmse,
                   **{"occ_" + k: v for k, v in rephoto.items()})
    return root, out_root, rig, truth, metrics, dict(occluder_solve=launches, occluder_rephotography=k4)


def run_ftheta(tmp: str, dev, smi: str):
    """Step 13 (b): the production FTHETA shape (15 distorted fisheyes at
    3360x2160 on a 0.33 m ring and a top camera), the sphere rendered at
    2048x1317 and nine smaller widths, and derp_cli; the level-0 error is
    taken inside each image circle."""
    from facebook360_dep_tpu_torch.core import camera as cam
    from facebook360_dep_tpu_torch.depth import pipeline
    from facebook360_dep_tpu_torch.render import synthetic

    rig = synthetic.make_ftheta_ring_rig(15, ring_radius=0.33, resolution=FTHETA_RESOLUTION,
                                         distortion=synthetic.PRODUCTION_FTHETA_DISTORTION)
    sizes = [(w, int(round(w * FTHETA_RESOLUTION[1] / FTHETA_RESOLUTION[0]))) for w in WIDTHS]
    root = os.path.join(tmp, "ftheta")
    out_root = os.path.join(root, "out")
    t = _phase_start()
    _, truth = write_project(root, dev, rig=rig, sizes=sizes)
    render_s, _ = _phase_end(f"FTHETA sphere scene rendered and written at {sizes} (step 13b)", t, smi)
    solve_s, _, launches, _ = run_solve(root, out_root, "", dev)
    missing = [k for k in ("project_sample", "ssd_combine", "cost_fused") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched by the FTHETA solve: {missing}")
    circles = pipeline.generate_fov_masks(cam.normalize_rig(rig), sizes[0][::-1], "cpu").numpy()
    maps = _read_maps(_level_dir(out_root, rig.ids[0]), rig.ids)
    med, coverage, rmse = level0_error_in(maps, truth, circles, "FTHETA level 0 inside the image circles")
    return dict(ftheta_render_s=render_s, ftheta_derp_cli_s=solve_s, ftheta_level0_median_rel_err=med,
                ftheta_level0_circle_coverage=coverage, ftheta_level0_covered_rel_rmse=rmse), launches


def run_render_tools(sphere_root: str, occ_root: str, occ_out: str, rig, truth, dev, smi: str):
    """Step 13 (c): render_tools geometric_consistency on the occluder
    room's level-0 maps (two passes of the mismatch stage: K1), and
    generate_equirect of the sphere tree at the sphere's radius against the
    true equirect."""
    import numpy as np

    from facebook360_dep_tpu_torch.cli import render_tools
    from facebook360_dep_tpu_torch.core import io
    from facebook360_dep_tpu_torch.render import synthetic

    gc_dir = os.path.join(occ_root, "geometric_consistency")
    t = _phase_start()
    shares = render_tools.main(["geometric_consistency", "--rig", os.path.join(occ_root, "rigs/rig_calibrated.json"),
                                "--color", os.path.join(occ_root, "video/color_levels/level_0"),
                                "--disparity", _level_dir(occ_out, rig.ids[0]), "--output", gc_dir,
                                "--iterations", "2"], device=dev)["000000"]
    gc_s, launches = _phase_end("render_tools geometric_consistency (step 13c)", t, smi)
    log(f"  pixels adjusted by each pass: {[f'{100 * v:.3f}%' for v in shares]}; kernel launches {launches}")
    if launches["project_sample"] < 1:
        raise AssertionError("K1 never launched by geometric_consistency")
    med, _, _ = level0_error_in(_read_maps(gc_dir, rig.ids), truth, np.ones(truth.shape, bool),
                                "occluder room level 0 after geometric_consistency")

    eqr_dir = os.path.join(sphere_root, "generate_equirect")
    t = _phase_start()
    render_tools.main(["generate_equirect", "--rig", os.path.join(sphere_root, "rigs/rig_calibrated.json"),
                       "--color", os.path.join(sphere_root, "video/color_levels/level_0"), "--output", eqr_dir,
                       "--num_depths", "1", "--min_depth", "5", "--max_depth", "5"], device=dev)
    eqr_s, _ = _phase_end("render_tools generate_equirect at 5 m, sphere tree (step 13c)", t, smi)
    got = io.read_color(os.path.join(eqr_dir, "eqr_depth_5.00.png"))
    want, _ = synthetic.ground_truth_equirect(None, got.shape[1], got.shape[0], "sphere", 5.0, seed=7)
    covered = got.sum(axis=-1) > 0
    err = float(np.abs(got - want.numpy())[covered].mean())
    log(f"  generate_equirect {got.shape}: covered share {covered.mean():.4f}, mean color error against the "
        f"true equirect {err:.5f} (bar {EQUIRECT_COLOR_BAR})")
    if not covered.mean() > 0.1 or not err < EQUIRECT_COLOR_BAR:
        raise AssertionError(f"generate_equirect: covered {covered.mean()}, error {err}")
    return dict(gc_s=gc_s, gc_adjusted_shares=shares, gc_level0_median_rel_err=med, gc_k1_launches=launches,
                generate_equirect_s=eqr_s, generate_equirect_color_err=err,
                generate_equirect_covered=float(covered.mean())), launches["project_sample"]


def run_conversions(occ_root: str, occ_out: str, rig, dev, smi: str):
    """Step 13 (d): conversions on the occluder room: camera 0's level-0
    map to a point cloud and back into cameras 0 and 1 at 2048x1536; all
    16 cameras to equirects at 10 m and the truth equirect back into them;
    an OBJ mesh of the truth equirect's disparity."""
    import numpy as np

    from facebook360_dep_tpu_torch.cli import conversions

    rig_path = os.path.join(occ_root, "rigs/rig_calibrated.json")
    level0 = _level_dir(occ_out, rig.ids[0])
    conv = os.path.join(occ_root, "conversions")
    cloud = os.path.join(conv, "cam0.xyz")
    seconds = {}
    runs = [
        ("export_point_cloud", ["--rig", rig_path, "--disparity", level0, "--output", cloud, "--cameras", "cam0"]),
        ("import_point_cloud", ["--rig", rig_path, "--point_cloud", cloud, "--output", os.path.join(conv, "imported"),
                                "--cameras", "cam0,cam1", "--width", str(WIDTHS[0])]),
        ("project_cameras_to_equirects", ["--rig", rig_path, "--color", os.path.join(occ_root, "video/color_levels/level_0"),
                                          "--output", os.path.join(conv, "eqr")]),
        ("project_equirects_to_cameras", ["--rig", rig_path, "--eqr", os.path.join(occ_root, "truth_eqr/000000_color.png"),
                                          "--output", os.path.join(conv, "cams")]),
        ("create_obj_from_disparity_equirect", ["--disparity", os.path.join(occ_root, "truth_eqr/000000_disparity.pfm"),
                                                "--output", os.path.join(conv, "truth_eqr.obj")]),
    ]
    for tool, argv in runs:
        t = _phase_start()
        conversions.main([tool] + argv, device=dev)
        seconds[tool], _ = _phase_end(f"conversions {tool} (step 13d)", t, smi)
    with open(cloud) as f:
        points = sum(1 for _ in f)
    solved = _read_maps(level0, ("cam0", "cam1"))
    back = _read_maps(os.path.join(conv, "imported"), ("cam0", "cam1"))
    resplat = {}
    for i, cam_id in enumerate(("cam0", "cam1")):
        ok = np.isfinite(back[i]) & np.isfinite(solved[i])
        resplat[cam_id] = (float(np.median(np.abs(back[i][ok] - solved[i][ok]) / solved[i][ok])), float(ok.mean()))
    log(f"  {points} points of cam0; re-splatted against the solved maps (median relative difference, share of "
        f"pixels): {resplat}")
    if not points > 0.3 * WIDTHS[0] * height(WIDTHS[0]) or not resplat["cam0"][0] < 1e-4 or not resplat["cam0"][1] > 0.5:
        raise AssertionError(f"point cloud round trip: {points} points, {resplat}")
    with open(os.path.join(conv, "truth_eqr.obj")) as f:
        kinds = [line[:2] for line in f]
    vertices, faces = kinds.count("v "), kinds.count("f ")
    log(f"  truth equirect OBJ: {vertices} vertices, {faces} faces")
    if not 0 < faces <= 200000:
        raise AssertionError(f"OBJ faces {faces}")
    for sub in ("eqr", "cams"):
        names = sorted(os.listdir(os.path.join(conv, sub)))
        if names != sorted(rig.ids):
            raise AssertionError(f"conversions {sub}: {names}")
    return dict(conversions_s=seconds, point_cloud_points=points, point_cloud_resplat=resplat,
                obj_vertices=vertices, obj_faces=faces)


def run_inspection(occ_root: str, rig, dev, smi: str):
    """Step 13 (e): rig_analyzer's coverage of the occluder rig at 5 m and
    view_thresholds on its cameras 0 and 1."""
    from facebook360_dep_tpu_torch.cli import rig_analyzer, view_thresholds

    rig_path = os.path.join(occ_root, "rigs/rig_calibrated.json")
    t = _phase_start()
    rig_analyzer.main(["--rig", rig_path, "--output", os.path.join(occ_root, "analysis"), "--depths", "5",
                       "--eqr_width", str(WIDTHS[0]), "--eqr_height", str(WIDTHS[0] // 2)], device=dev)
    cov = rig_analyzer.coverage_equirect(rig, WIDTHS[0], WIDTHS[0] // 2, 5.0, dev)
    analyzer_s, _ = _phase_end("rig_analyzer (step 13e)", t, smi)
    seen2 = float((cov >= 2).mean())
    log(f"  coverage at 5 m: seen by >= 2 cameras {100 * seen2:.2f}%, most cameras {int(cov.max())}")
    if not 0 < seen2 <= 1:
        raise AssertionError(f"rig_analyzer coverage {seen2}")
    img = [os.path.join(occ_root, "video/color_levels/level_0", c, "000000.png") for c in ("cam0", "cam1")]
    seconds = {}
    for tool, argv in (("color_variance", ["--fullsize_image", img[0]]),
                       ("foreground_masks", ["--fullsize_bg_image", img[0], "--fullsize_fg_image", img[1]])):
        t = _phase_start()
        view_thresholds.main([tool] + argv + ["--width", str(WIDTHS[0]),
                                              "--output_dir", os.path.join(occ_root, "thresholds", tool)], device=dev)
        seconds[tool], _ = _phase_end(f"view_thresholds {tool} (step 13e)", t, smi)
    with open(os.path.join(occ_root, "thresholds/foreground_masks/mask_sweep.json")) as f:
        masks = json.load(f)
    log(f"  {len(masks)} masks, foreground share {min(m['foreground_frac'] for m in masks):.4f}.."
        f"{max(m['foreground_frac'] for m in masks):.4f}")
    return dict(rig_analyzer_s=analyzer_s, coverage_5m_seen_by_2=seen2, view_thresholds_s=seconds)


def run_viewer(sphere_root: str, smi: str):
    """Step 13 (f): the viewer server over step 10's publish: /scene.json,
    one mesh and one color, held against the fused entries read directly;
    the server must not touch the card."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from facebook360_dep_tpu_torch.core import camera as cam, png
    from facebook360_dep_tpu_torch.stream import fusion, native
    from facebook360_dep_tpu_torch.viewer import server

    rig_path = os.path.join(sphere_root, "rigs/rig_calibrated.json")
    fused_dir = os.path.join(sphere_root, "publish", "fused")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t = time.time()
    httpd = server.serve(rig_path, fused_dir)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        scene = json.loads(urllib.request.urlopen(url + "/scene.json", timeout=60).read())
        frame, cam_id = scene["frames"][0], scene["cameras"][0]["id"]
        mesh = urllib.request.urlopen(f"{url}/mesh/{frame}/{cam_id}.bin", timeout=60).read()
        color = png.decode(urllib.request.urlopen(f"{url}/color/{frame}/{cam_id}.png", timeout=60).read())
        page = urllib.request.urlopen(url + "/", timeout=60).read()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    seconds = time.time() - t
    after = torch.cuda.memory_allocated()
    with open(os.path.join(fused_dir, "fused.json")) as f:
        catalog = json.load(f)
    entry = catalog["frames"][frame][cam_id]
    rig = cam.load_rig(rig_path)
    want_mesh = server.mesh_buffer(rig.camera(rig.find(cam_id)), fusion.read_fused_entry(fused_dir, catalog, frame, cam_id, ".vtx"),
                                   fusion.read_fused_entry(fused_dir, catalog, frame, cam_id, ".idx"))
    w, h = entry["color_wh"]
    rgba = native.decompress_bc7(np.frombuffer(fusion.read_fused_entry(fused_dir, catalog, frame, cam_id, ".bc7"),
                                               np.uint8), w, h)
    log(f"viewer (step 13f): {seconds:.2f} s for /scene.json ({len(scene['cameras'])} cameras, "
        f"{len(scene['frames'])} frames), {cam_id}'s mesh ({len(mesh)} bytes), color {color.shape}, page "
        f"({len(page)} bytes); device memory {before} -> {after} bytes; {smi}")
    if mesh != want_mesh:
        raise AssertionError("viewer mesh buffer differs from the fused entry's")
    if not np.array_equal(color, rgba[..., :3]):
        raise AssertionError("viewer color differs from the fused entry's RGBA")
    if after != before or len(scene["cameras"]) != NUM_CAMERAS:
        raise AssertionError(f"viewer: device memory {before} -> {after}, {len(scene['cameras'])} cameras")
    return dict(viewer_s=seconds, viewer_mesh_bytes=len(mesh))


def run_step13(tmp: str, sphere_root: str, dev, smi: str):
    """Step 13: the fixture generators and the inspection tools and viewer
    on the card. Returns (metrics, launches by phase)."""
    metrics, phases = {}, {}
    occ_root, occ_out, rig, truth, m, p = run_occluder_room(tmp, dev, smi)
    metrics.update(m)
    phases.update(p)
    m, phases["ftheta_solve"] = run_ftheta(tmp, dev, smi)
    metrics.update(m)
    m, phases["geometric_consistency"] = run_render_tools(sphere_root, occ_root, occ_out, rig, truth, dev, smi)
    metrics.update(m)
    metrics.update(run_conversions(occ_root, occ_out, rig, dev, smi))
    metrics.update(run_inspection(occ_root, rig, dev, smi))
    metrics.update(run_viewer(sphere_root, smi))
    return metrics, phases


def write_project(root: str, dev, widths=WIDTHS, rig=None, sizes=None):
    """The sphere scene rendered at every pyramid size into every camera of
    ``rig`` (default: the 16-camera ring at the widths ``widths``, heights
    3/4), as a project tree (color_levels/level_N/<cam>/000000.png + rig),
    the PNG16 writes on a thread pool. Returns (rig, the level-0
    ground-truth disparity (N, H, W) numpy)."""
    from concurrent.futures import ThreadPoolExecutor

    from facebook360_dep_tpu_torch.core import camera as cam
    from facebook360_dep_tpu_torch.core import imagetypes, io
    from facebook360_dep_tpu_torch.render import synthetic

    if rig is None:
        rig = synthetic.make_test_rig(NUM_CAMERAS, (widths[0], height(widths[0])), ring_radius=0.3)
    sizes = sizes or [(w, height(w)) for w in widths]
    gt0 = None

    def write(level, cam_id, color):
        d = imagetypes.image_dir(root, "color_levels", level, cam_id)
        os.makedirs(d, exist_ok=True)
        io.write_color(os.path.join(d, "000000.png"), color, bit_depth=16)

    with ThreadPoolExecutor(max_workers=min(len(rig.ids), os.cpu_count() or 1)) as pool:
        for level, size in enumerate(sizes):
            colors, gt = synthetic.render_sphere_scene(rig, size, radius=5.0, device=dev)
            colors = colors.cpu().numpy()
            if level == 0:
                gt0 = gt.cpu().numpy()
            list(pool.map(lambda a: write(level, *a), [(c, colors[i]) for i, c in enumerate(rig.ids)]))
    os.makedirs(os.path.join(root, "rigs"), exist_ok=True)
    cam.save_rig(os.path.join(root, "rigs/rig_calibrated.json"), rig)
    return rig, gt0


def run_solve(root: str, out_root: str, profile_dir: str, dev, mismatches_start_level: int = -1):
    """The port's derp_cli on the project tree at ``root`` with default
    solver flags (but ``--mismatches_start_level``), timed from main() to
    the last map written; returns (seconds, the estimator, launches by
    kernel, launches by (kernel, H, W))."""
    import torch

    from facebook360_dep_tpu_torch.cli import derp_cli
    from facebook360_dep_tpu_torch.ops import warp_cuda as wc

    torch.cuda.reset_peak_memory_stats()
    wc.reset_launch_counts()
    t = time.time()
    with profiled(profile_dir, "derp"):
        est = derp_cli.main([
            "--input_root", root, "--output_root", out_root,
            "--min_depth_m", "1", "--max_depth_m", "100", "--resolution", str(WIDTHS[0]),
            "--mismatches_start_level", str(mismatches_start_level),
        ], device=dev)
        torch.cuda.synchronize()
    total = time.time() - t
    launches, by_shape = dict(wc.LAUNCHES), dict(wc.LAUNCHES_BY_SHAPE)
    log(f"derp_cli: {total:.2f} s for {NUM_CAMERAS} destination maps, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for level in sorted(est.level_seconds, reverse=True):
        w, h = est.level_sizes[level]
        log(f"  level {level} ({w}x{h}): {est.level_seconds[level]:.3f} s")
    log(f"kernel launches in the derp_cli run: {launches}")
    return total, est, launches, by_shape


def level0_maps(out_root: str, ids):
    from facebook360_dep_tpu_torch.core import imagetypes

    return [imagetypes.gen_filename(out_root, "disparity_levels", 0, cam_id, "000000", "pfm") for cam_id in ids]


def compare_solves(out_root: str, reference: str, ids):
    """Level-0 maps of two solves of one project tree: byte-identical
    files, and the share of pixels whose values differ (NaN = NaN)."""
    import numpy as np

    from facebook360_dep_tpu_torch.core import io

    files = list(zip(level0_maps(out_root, ids), level0_maps(reference, ids)))
    same_bytes = all(open(a, "rb").read() == open(b, "rb").read() for a, b in files)
    a = np.stack([io.read_disparity(f) for f, _ in files])
    b = np.stack([io.read_disparity(f) for _, f in files])
    differ = (a != b) & ~(np.isnan(a) & np.isnan(b))
    diff = np.abs(a - b)[differ & np.isfinite(a) & np.isfinite(b)]
    return dict(byte_identical=same_bytes, differing_share=float(differ.mean()),
                max_abs_diff=float(diff.max()) if diff.size else 0.0)


def check_level0(out_root: str, rig, gt):
    """Median relative error (interior, finite pixels) against ground truth,
    as tests/test_derp_cli.py:61-65 checks it; coverage and covered RMSE."""
    import numpy as np

    disp = _read_maps(_level_dir(out_root, rig.ids[0]), rig.ids)
    if disp.shape != gt.shape:
        raise AssertionError(f"level-0 maps {disp.shape}, expected {gt.shape}")
    return level0_error_in(disp, gt, np.ones(gt.shape, bool), "level 0")


# The foreground chain's scene: the sphere of radius 5 m as the static
# background, and in frames 000000-000002 an opaque textured disk facing the
# rig 2 m in front of it, moving 3 cm in x per frame.
CHAIN_FRAMES = ("000000", "000001", "000002")
DISK_RADIUS_M = 0.4
DISK_DEPTH_M = 2.0
DISK_STEP_M = 0.03
DISK_SEED = 11  # the sphere's texture uses seed 7
# mask IoU bar: a CPU run of this scene at 256x192 (four levels) measured
# 0.929; full width has a thinner edge band relative to the disk (PERF.md)
MASK_IOU_BAR = 0.90


def render_disk_scene(rig, size_wh, disk_x, dev, with_disk=True):
    """Colors (N, H, W, 3), disparity (N, H, W) and disk coverage (N, H, W)
    of the sphere scene with the disk centered at (disk_x, 0, -2): each
    pixel shows the nearer of the sphere and the disk (ray-plane hit within
    the radius). Built from the port's camera rays and textures."""
    import torch

    from facebook360_dep_tpu_torch.core import camera as cam
    from facebook360_dep_tpu_torch.ops import sampling
    from facebook360_dep_tpu_torch.render import synthetic

    w, h = size_wh
    cams = cam.normalize_rig(rig).cameras.to(dev, torch.float32)
    grid = sampling.pixel_center_grid(h, w, device=dev) / torch.tensor([w, h], dtype=torch.float32, device=dev)
    zero = torch.zeros(3, dtype=torch.float32, device=dev)
    center = torch.tensor([disk_x, 0.0, -DISK_DEPTH_M], dtype=torch.float32, device=dev)
    colors, disparity, coverage = [], [], []
    for i in range(len(rig.ids)):
        c = cams.index(i)
        d = cam.ray_dir(c, grid)
        t = synthetic.ray_sphere_depth(c.position, d, zero, 5.0)
        hit = c.position + d * t[..., None]
        color = synthetic.procedural_texture(hit / torch.sqrt(cam._dot3(hit, hit))[..., None], 7)
        on = torch.zeros_like(t, dtype=torch.bool)
        if with_disk:
            t_disk = (center[2] - c.position[2]) / d[..., 2]  # the disk's plane z = -2 faces the rig
            off = c.position + d * t_disk[..., None] - center
            on = (t_disk > 0) & (off[..., 0] ** 2 + off[..., 1] ** 2 <= DISK_RADIUS_M ** 2) & (t_disk < t)
            local = torch.stack([off[..., 0] / DISK_RADIUS_M, off[..., 1] / DISK_RADIUS_M,
                                 torch.ones_like(t)], dim=-1)
            tex = synthetic.procedural_texture(local / torch.sqrt(cam._dot3(local, local))[..., None], DISK_SEED)
            color = torch.where(on[..., None], tex, color)
            t = torch.where(on, t_disk, t)
        colors.append(color)
        disparity.append(1.0 / t)
        coverage.append(on)
    return torch.stack(colors), torch.stack(disparity), torch.stack(coverage)


def relative_error(maps, truth, interior: int = 6):
    """(median relative error over finite interior pixels, finite share)."""
    import numpy as np

    ok = np.isfinite(maps)
    m = np.zeros(maps.shape, bool)
    m[..., interior:-interior, interior:-interior] = True
    v = ok & m
    return float(np.median(np.abs(maps[v] - truth[v]) / truth[v])), float(ok.mean())


def run_foreground_chain(tmp: str, dev, widths=WIDTHS, profile_dir: str = ""):
    """The reference's flow for a shot over a static background
    (precompute_resizes -> depth_estimation of the background ->
    generate_foreground_masks -> resize of the masks -> background-
    constrained depth_estimation -> temporal filter -> upsample -> export),
    each stage through its CLI's main() in process. Returns (metrics,
    {stage: kernel launches}). Any failed check raises. With
    ``profile_dir`` the foreground solve runs under torch.profiler."""
    import numpy as np
    import torch

    from facebook360_dep_tpu_torch.cli import (convert_to_binary, derp_cli, generate_foreground_masks,
                                               resize_images, simple_mesh_renderer, temporal_bilateral_filter,
                                               upsample_disparity)
    from facebook360_dep_tpu_torch.core import camera as cam
    from facebook360_dep_tpu_torch.core import imagetypes, io
    from facebook360_dep_tpu_torch.depth import pipeline
    from facebook360_dep_tpu_torch.ops import warp_cuda as wc
    from facebook360_dep_tpu_torch.render import synthetic
    from facebook360_dep_tpu_torch.stream import mesh

    full = (widths[0], height(widths[0]))
    rig = synthetic.make_test_rig(NUM_CAMERAS, full, ring_radius=0.3)
    bg_root, shot = os.path.join(tmp, "background_shot"), os.path.join(tmp, "shot")
    truth, cover = {}, {}
    t = time.time()
    for root in (bg_root, shot):
        os.makedirs(os.path.join(root, "rigs"), exist_ok=True)
        cam.save_rig(os.path.join(root, "rigs/rig_calibrated.json"), rig)
    scenes = [("background_color", bg_root, "000000", None)]
    scenes += [("color", shot, f, i * DISK_STEP_M) for i, f in enumerate(CHAIN_FRAMES)]
    for image_type, root, frame, disk_x in scenes:
        colors, disp, on = render_disk_scene(rig, full, disk_x or 0.0, dev, with_disk=disk_x is not None)
        colors = colors.cpu().numpy()
        if disk_x is not None:
            truth[frame], cover[frame] = disp.cpu().numpy(), on.cpu().numpy()
        for i, cam_id in enumerate(rig.ids):
            d = imagetypes.image_dir(root, image_type, cam_id=cam_id)
            os.makedirs(d, exist_ok=True)
            io.write_color(os.path.join(d, frame + ".png"), colors[i], bit_depth=16)
    seconds = {"scene": time.time() - t}
    log(f"foreground chain: scene rendered and written ({NUM_CAMERAS} cameras, {full[0]}x{full[1]}, "
        f"background + {len(CHAIN_FRAMES)} frames): {seconds['scene']:.1f} s")

    rig_path = os.path.join(shot, "rigs/rig_calibrated.json")
    frames = ["--first", CHAIN_FRAMES[0], "--last", CHAIN_FRAMES[-1]]
    widths_arg = ["--widths", ",".join(str(w) for w in widths)]
    depth = ["--min_depth_m", "1", "--max_depth_m", "100", "--resolution", str(widths[0])]
    bg_out, fg_out = os.path.join(bg_root, "out"), os.path.join(shot, "out")
    fg_masks = imagetypes.image_dir(shot, "foreground_masks")
    fg_levels = imagetypes.image_dir(shot, "foreground_masks_levels")
    stages = [
        ("resize background", resize_images.main, [
            "--rig", rig_path, "--color", imagetypes.image_dir(bg_root, "background_color"),
            "--output", imagetypes.image_dir(bg_root, "background_color_levels")] + widths_arg),
        ("derp background", derp_cli.main, [
            "--input_root", bg_root, "--output_root", bg_out,
            "--color", imagetypes.image_dir(bg_root, "background_color_levels")] + depth),
        ("resize frames", resize_images.main, [
            "--rig", rig_path, "--color", imagetypes.image_dir(shot, "color"),
            "--output", imagetypes.image_dir(shot, "color_levels")] + frames + widths_arg),
        ("foreground masks", generate_foreground_masks.main, [
            "--rig", rig_path, "--background_color", imagetypes.image_dir(bg_root, "background_color"),
            "--color", imagetypes.image_dir(shot, "color"), "--foreground_masks", fg_masks,
            "--width", str(widths[0])] + frames),
        ("resize masks", resize_images.main, [
            "--rig", rig_path, "--color", fg_masks, "--output", fg_levels, "--threshold", "0.5"] + frames + widths_arg),
        ("derp foreground", derp_cli.main, [
            "--input_root", shot, "--output_root", fg_out, "--use_foreground_masks", "true",
            "--background_disp", os.path.join(bg_out, "disparity_levels")] + frames + depth),
        ("temporal filter", temporal_bilateral_filter.main, [
            "--rig", rig_path, "--input_root", shot, "--output_root", fg_out, "--level", "0",
            "--use_foreground_masks", "true"] + frames),
        ("upsample", upsample_disparity.main, [
            "--rig", rig_path, "--disparity", os.path.join(fg_out, "disparity_levels/level_1"),
            "--output", os.path.join(fg_out, "disparity_upsample"), "--resolution", str(widths[0]),
            "--color", imagetypes.image_dir(shot, "color"),
            "--foreground_masks_in", os.path.join(fg_levels, "level_1"),
            "--foreground_masks_out", os.path.join(fg_levels, "level_0"),
            "--background_disp", os.path.join(bg_out, "disparity_levels/level_0"),
            "--first", CHAIN_FRAMES[1], "--last", CHAIN_FRAMES[1]]),
        ("export eqrcolor", simple_mesh_renderer.main, [
            "--rig", rig_path, "--color", os.path.join(imagetypes.image_dir(shot, "color_levels"), "level_0"),
            "--disparity", os.path.join(fg_out, "disparity_time_filtered_levels/level_0"),
            "--output", os.path.join(fg_out, "eqrcolor"), "--format", "eqrcolor",
            "--first", CHAIN_FRAMES[1], "--last", CHAIN_FRAMES[1]]),
        ("publish with masks", convert_to_binary.main, [
            "--rig", rig_path, "--bin", os.path.join(fg_out, "bin"), "--fused", os.path.join(fg_out, "fused"),
            "--color", os.path.join(imagetypes.image_dir(shot, "color_levels"), "level_0"),
            "--disparity", os.path.join(fg_out, "disparity_time_filtered_levels/level_0"),
            "--foreground_masks", os.path.join(fg_levels, "level_0"),
            "--first", CHAIN_FRAMES[1], "--last", CHAIN_FRAMES[1]]),
    ]
    on_device = {derp_cli.main, generate_foreground_masks.main, temporal_bilateral_filter.main,
                 upsample_disparity.main, simple_mesh_renderer.main, convert_to_binary.main}
    launches, results, peaks = {}, {}, {}
    for name, entry, argv in stages:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        wc.reset_launch_counts()
        t = time.time()
        with profiled(profile_dir if name == "derp foreground" else "", "derp_foreground"):
            results[name] = entry(argv, device=dev) if entry in on_device else entry(argv)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds[name] = time.time() - t
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else 0.0
        launches[name] = dict(wc.LAUNCHES)
        log(f"  stage {name}: {seconds[name]:.2f} s, peak device memory {peaks[name]:.2f} GiB, "
            f"kernel launches {launches[name]}")
    peak = max(peaks.values())
    if dev.type == "cuda":  # on the CPU every wrapper runs its plain twin
        for name, kernels in (("derp background", ("project_sample", "ssd_combine", "cost_fused")),
                              ("derp foreground", ("project_sample", "ssd_combine", "cost_fused", "chamfer")),
                              ("export eqrcolor", ("warp_sample",))):
            missing = [k for k in kernels if launches[name][k] <= 0]
            if missing:
                raise AssertionError(f"foreground chain: {name} never launched {missing}")
        # the upsample's init: one chamfer launch for each camera whose
        # upsampled map has both an in-mask hole and a valid pixel
        nrig = cam.normalize_rig(cam.load_rig(rig_path))
        want = 0
        for i, cam_id in enumerate(rig.ids):
            d = io.read_disparity(os.path.join(fg_out, "disparity_levels/level_1", cam_id, CHAIN_FRAMES[1] + ".pfm"))
            m, m_up = (io.read_mask(os.path.join(fg_levels, f"level_{lv}", cam_id, CHAIN_FRAMES[1] + ".png"))
                       & pipeline.generate_fov_masks(nrig, shape, "cpu")[i].numpy()
                       for lv, shape in ((1, d.shape), (0, (full[1], full[0]))))
            up = np.where(m, d, np.nan)[io.nearest_index(d.shape[0], full[1])][:, io.nearest_index(d.shape[1], full[0])]
            valid = np.isfinite(up) & m_up
            want += bool((m_up & ~valid).any() and valid.any())
        log(f"  stage upsample: {want} of {len(rig.ids)} cameras need the chamfer")
        if not 0 < want == launches["upsample"]["chamfer"]:
            raise AssertionError(f"foreground chain: upsample launched the chamfer {launches['upsample']['chamfer']} "
                                 f"times for {want} cameras with holes")

    # masks against the disk's true coverage at level 0
    inter = union = 0
    for frame in CHAIN_FRAMES:
        for i, cam_id in enumerate(rig.ids):
            m = io.read_mask(os.path.join(fg_levels, "level_0", cam_id, frame + ".png"))
            inter += int((m & cover[frame][i]).sum())
            union += int((m | cover[frame][i]).sum())
    iou = inter / max(union, 1)

    def maps(image_type, frame, level=0):
        return np.stack([io.read_disparity(imagetypes.gen_filename(fg_out, image_type, level, cam_id, frame, "pfm"))
                         for cam_id in rig.ids])

    solve = np.stack([maps("disparity_levels", f) for f in CHAIN_FRAMES])
    filtered = np.stack([maps("disparity_time_filtered_levels", f) for f in CHAIN_FRAMES])
    upsampled = np.stack([io.read_disparity(os.path.join(fg_out, "disparity_upsample", cam_id,
                                                         CHAIN_FRAMES[1] + ".pfm")) for cam_id in rig.ids])
    gt = np.stack([truth[f] for f in CHAIN_FRAMES])
    on_disk = np.stack([cover[f] for f in CHAIN_FRAMES])
    err, coverage = relative_error(solve, gt)
    disk_err = float(np.median(np.abs(solve - gt)[on_disk & np.isfinite(solve)] / gt[on_disk & np.isfinite(solve)]))
    filt_err, _ = relative_error(filtered, gt)
    up_err, _ = relative_error(upsampled, gt[1])
    export = results["export eqrcolor"][0]
    # the masked meshes: vertex xy are level-0 pixels here, and the mesh
    # keeps (QEM moves a few vertices off) the foreground mask's pixels only
    inside = {}
    for rec in results["publish with masks"]["tasks"]:
        v = mesh.read_vtx(os.path.join(fg_out, "bin", rec["cam_id"], CHAIN_FRAMES[1] + ".vtx"))
        m = io.read_mask(os.path.join(fg_levels, "level_0", rec["cam_id"], CHAIN_FRAMES[1] + ".png"))
        cols = np.clip(v[:, 0].astype(np.int64), 0, m.shape[1] - 1)
        rows = np.clip(v[:, 1].astype(np.int64), 0, m.shape[0] - 1)
        inside[rec["cam_id"]] = float(m[rows, cols].mean()) if len(v) else 0.0
        if not 0 < rec["faces"] <= 150000:
            raise AssertionError(f"publish with masks: {rec['cam_id']} has {rec['faces']} faces")
    log(f"publish with masks: faces {[r['faces'] for r in results['publish with masks']['tasks']]}; share of "
        f"vertices on the mask, least {min(inside.values()):.4f}")
    if not min(inside.values()) >= 0.9:
        raise AssertionError(f"publish with masks: vertices off the foreground mask {inside}")
    metrics = dict(chain_mask_iou=iou, chain_level0_median_rel_err=err, chain_level0_disk_median_rel_err=disk_err,
                   chain_level0_coverage=coverage, chain_filtered_median_rel_err=filt_err,
                   chain_upsampled_median_rel_err=up_err, chain_eqrcolor_coverage=export["coverage"],
                   chain_publish_mask_share_min=min(inside.values()),
                   chain_peak_gib=peak, chain_seconds=seconds)
    log(f"foreground chain: mask IoU {iou:.4f} (bar {MASK_IOU_BAR}); level 0 median relative error {err:.5f}, "
        f"inside the disk {disk_err:.5f} (bar 0.05), coverage {coverage:.4f}; temporally filtered {filt_err:.5f}; "
        f"upsampled from level 1 {up_err:.5f}; eqrcolor alpha coverage {export['coverage']:.4f}; "
        f"peak device memory {peak:.2f} GiB; {sum(seconds.values()):.1f} s in all")
    if not iou >= MASK_IOU_BAR:
        raise AssertionError(f"foreground mask IoU {iou} below {MASK_IOU_BAR}")
    for name, value in (("level 0", err), ("level 0 inside the disk", disk_err), ("filtered", filt_err),
                        ("upsampled", up_err)):
        if not value < 0.05:
            raise AssertionError(f"foreground chain: {name} median relative error {value}")
    if not (np.isfinite(filtered) | ~np.isfinite(solve)).all():
        raise AssertionError("temporally filtered map is not finite where the solve's map is")
    if not (np.isfinite(upsampled) | ~np.isfinite(solve[1])).all():
        raise AssertionError("upsampled map is not finite where the level-0 solve is")
    if not export["finite"] or not export["coverage"] > 0.1:
        raise AssertionError(f"eqrcolor export of the filtered frame: {export}")
    return metrics, launches


# step 14: the multi-GPU path (parallel/) on the one card: 4 gloo ranks,
# then one NCCL rank; every result held to the single-process solve
STEP14_RANKS = 4
STEP14_FRAMES = 2
STEP14_MISMATCHES_START_LEVEL = 8
STEP14_TIMEOUT_S = 600
# Each rank's peak device memory predicted for (a), (b) and (c) when a rank
# builds only its block's destination fields and keeps only its block's
# draws (PERF.md section 6; a rank holding the whole level's context and
# draws measured 6.42, 10.65 and 11.96 GiB)
STEP14_PREDICTED_PEAK_GIB = dict(a=4.95, b=8.50, c=11.96)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sphere_pyramid(rig, widths, dev, solve, keep=(0, 1), destinations=None, use_pallas_sampler=False,
                   config=None, sizes=None):
    """Step 14's pyramid loop, DepthEstimator's (depth/pipeline.py) without
    the files: from the coarsest level down, each level's context of the
    sphere colors rendered at that width and the upsampled init of the maps
    ``solve(ctx, cfg, init)`` returned one level up (its own maps: a rank's
    block, or all of them), the mismatch stage from level
    STEP14_MISMATCHES_START_LEVEL. ``destinations`` builds the context of
    those destinations only (a rank's block: its masks, rays and colors
    alone); ``use_pallas_sampler`` the TPU sampler's; ``config(level, ctx)``
    replaces step14_config; ``sizes`` the (W, H) of each width. Returns
    ({level: its result} for ``keep``, the finest level's context)."""
    import torch

    from facebook360_dep_tpu_torch.core import camera as cam
    from facebook360_dep_tpu_torch.depth import pipeline, solver
    from facebook360_dep_tpu_torch.render import synthetic

    nrig = cam.normalize_rig(rig)
    mine = nrig if destinations is None else nrig.subset(list(destinations))
    sizes = sizes or [(w, height(w)) for w in widths]
    kept, maps, ctx = {}, None, None
    for level in reversed(range(len(widths))):
        size = sizes[level]
        ctx = None  # freed before the next level's is built
        colors, _ = synthetic.render_sphere_scene(rig, size, radius=5.0, device=dev)
        ctx = solver.make_level_context(nrig, nrig, colors, pipeline.generate_fov_masks(mine, size[::-1], dev),
                                        full_height=sizes[0][1], use_pallas_sampler=use_pallas_sampler,
                                        destinations=destinations)
        init = None if maps is None else torch.stack([pipeline.upsample_disparity_init(m, size) for m in maps])
        cfg = step14_config(level, len(widths)) if config is None else config(level, ctx)
        out = solve(ctx, cfg, init)
        maps = out["disparity"]
        if level in keep:
            kept[level] = out
    return kept, ctx


def step14_config(level: int, num_levels: int):
    from facebook360_dep_tpu_torch.depth import solver

    return solver.SolverConfig(min_depth=1.0, max_depth=100.0, mismatches_start_level=STEP14_MISMATCHES_START_LEVEL,
                               level=level, num_levels=num_levels)


def map_digests(out, index=slice(None)) -> dict:
    """SHA-256 of each result map's bytes (``index`` of its leading axis):
    equal digests are equal bits, NaNs included."""
    import hashlib

    from facebook360_dep_tpu_torch.parallel.sharding import MAPS

    return {k: hashlib.sha256(out[k][index].contiguous().cpu().numpy().tobytes()).hexdigest() for k in MAPS}


@contextlib.contextmanager
def counting_gathers():
    """Counts the bytes every ``sharding.all_gather`` call returns (each
    rank's copy of what the group gathered) into the yielded list."""
    from facebook360_dep_tpu_torch.parallel import sharding

    counted, gather = [0], sharding.all_gather

    def counting(tensor, mesh, axis):
        out = gather(tensor, mesh, axis)
        counted[0] += out.numel() * out.element_size()
        return out

    sharding.all_gather = counting
    try:
        yield counted
    finally:
        sharding.all_gather = gather


@contextlib.contextmanager
def memory_marks(dev):
    """Marks the device memory after each solver stage, each level
    context built and each scene render: yields a list of (stage, GiB
    allocated after it, the phase's peak GiB so far). The stage after
    which the peak first reaches its final value is where it was reached."""
    import torch

    from facebook360_dep_tpu_torch.depth import solver
    from facebook360_dep_tpu_torch.render import synthetic

    marks, saved = [], []
    stages = [(solver, n) for n in ("make_level_context", "with_images", "draw_uniforms", "brute_force_all",
                                    "random_proposals", "ping_pong", "handle_mismatches", "spatial_bilateral",
                                    "median_filter")]
    stages.append((synthetic, "render_sphere_scene"))
    for module, name in stages:
        fn = getattr(module, name)
        saved.append((module, name, fn))

        def marked(*args, _fn=fn, _name=name, **kwargs):
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize(dev)
            marks.append((_name, torch.cuda.memory_allocated(dev) / 2**30, torch.cuda.max_memory_allocated(dev) / 2**30))
            return out

        setattr(module, name, marked)
    try:
        yield marks
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def _peak_at(marks, peak):
    """The first mark whose running peak reached ``peak``, with the memory
    allocated after the stage before it."""
    for i, (name, _, running) in enumerate(marks):
        if running >= peak - 1e-6:
            return dict(stage=name, index=i, allocated_before_gib=marks[i - 1][1] if i else 0.0,
                        allocated_after_gib=marks[i][1])
    return None


def _rank_phase(dev, fn):
    """(seconds, peak device GiB, K1-K4 launches, gathered bytes, the stage
    where the peak was reached, result) of ``fn()``."""
    import torch

    from facebook360_dep_tpu_torch.ops import warp_cuda as wc

    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    wc.reset_launch_counts()
    with counting_gathers() as gathered, memory_marks(dev) as marks:
        t = time.time()
        result = fn()
        torch.cuda.synchronize(dev)
        seconds = time.time() - t
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    return dict(seconds=seconds, peak_gib=peak, launches=dict(wc.LAUNCHES), gathered_bytes=gathered[0],
                peak_at=_peak_at(marks, peak), stages=len(marks)), result


def step14_rank(rank: int, coordinator: str, rig, widths, report_path: str) -> None:
    """One of step 14's ranks, a spawned process on the card: joins the
    gloo group, then (a) the sphere pyramid with its block of destinations
    on the ("cam",) mesh, whose level-0 maps it gathers, and (b) one frame
    of two with its block of destinations on the 2 x 2 ("frame", "cam")
    mesh, its init (a)'s level-1 maps upsampled. Writes its report (times,
    memory, launches, gathered bytes, digests of its maps) as JSON."""
    import torch
    import torch.distributed as dist

    from facebook360_dep_tpu_torch.core import camera as cam
    from facebook360_dep_tpu_torch.depth import pipeline, solver
    from facebook360_dep_tpu_torch.parallel import multihost, sharding

    # the ranks share this host: gloo's pairs connect over the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dev = multihost.local_device()
    if dev.type != "cuda":
        raise RuntimeError(f"rank {rank} is on {dev}: step 14's ranks run on the card")
    torch.cuda.set_device(dev)
    multihost.maybe_initialize(coordinator_address=coordinator, num_processes=STEP14_RANKS, process_id=rank,
                               backend="gloo", device=dev)
    report = dict(rank=dist.get_rank(), world=dist.get_world_size(), backend=dist.get_backend(), device=str(dev))
    n = len(rig.ids)

    # each rank builds the context of its own block of destinations only
    mesh = sharding.camera_mesh()
    report["a"], (kept, ctx0) = _rank_phase(dev, lambda: sphere_pyramid(
        rig, widths, dev, lambda ctx, cfg, init: sharding.process_level_sharded(ctx, cfg, mesh, init),
        destinations=sharding.block(n, mesh, "cam")))
    report["a"]["destinations"] = list(kept[0]["destinations"])
    report["a"]["digests"] = map_digests(sharding.gather_result(kept[0], mesh))
    level1 = sharding.all_gather(kept[1]["disparity"], mesh, "cam")  # (a)'s level-1 maps, destination order
    colors0 = ctx0.src_imgs
    del kept, ctx0

    mesh2 = sharding.frame_camera_mesh(STEP14_FRAMES)
    frames = torch.stack([colors0, colors0 * 0.9 + 0.05])
    del colors0
    dsts = sharding.block(n, mesh2, "cam")
    size = (widths[0], height(widths[0]))
    init = torch.stack([pipeline.upsample_disparity_init(level1[d], size) for d in dsts])[None]
    nrig = cam.normalize_rig(rig)

    def frames_b():
        base = solver.make_level_context(
            nrig, nrig, frames[0], pipeline.generate_fov_masks(nrig.subset(list(dsts)), size[::-1], dev),
            full_height=size[1], destinations=dsts)
        return sharding.process_frames_sharded(base, frames, step14_config(0, len(widths)), mesh2,
                                               init_disparity=init)

    report["b"], out = _rank_phase(dev, frames_b)
    report["b"].update(frames=list(out["frames"]), destinations=list(out["destinations"]),
                       digests=map_digests(out, 0))
    multihost.shutdown()
    with open(report_path, "w") as f:
        json.dump(report, f)


def run_ranks(target, args_of, n: int, timeout: float):
    """``target(rank, *args_of(rank))`` in ``n`` spawned processes (CUDA does
    not survive a fork); any rank that fails, or a run past ``timeout`` s,
    kills them all and raises."""
    import multiprocessing

    mp = multiprocessing.get_context("spawn")
    procs = [mp.Process(target=target, args=(r, *args_of(r))) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed or time.time() > deadline:
                raise AssertionError(f"step 14 ranks {failed or 'all'} failed or ran past {timeout} s "
                                     f"(exit codes {[p.exitcode for p in procs]})")
            time.sleep(0.2)
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise AssertionError(f"step 14 ranks exited with {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()


def run_step14(tmp: str, dev, smi: str, widths=WIDTHS):
    """Step 14: the multi-GPU path on the one card. The single-process
    references first: the sphere pyramid through process_level on all 16
    destinations, and frame 1's level 0. Then (a) and (b) in 4 spawned gloo
    ranks (step14_rank), whose maps must equal the references bit for bit,
    and (c) one NCCL rank in this process: the level-0 solve on the camera
    mesh. Returns (metrics, launches by phase)."""
    import torch
    import torch.distributed as dist

    from facebook360_dep_tpu_torch.depth import pipeline, solver
    from facebook360_dep_tpu_torch.parallel import multihost, sharding
    from facebook360_dep_tpu_torch.render import synthetic

    rig = synthetic.make_test_rig(NUM_CAMERAS, (widths[0], height(widths[0])), ring_radius=0.3)
    size = (widths[0], height(widths[0]))
    cfg0 = step14_config(0, len(widths))
    t = _phase_start()
    ref, ctx0 = sphere_pyramid(rig, widths, dev, lambda ctx, cfg, init: solver.process_level(ctx, cfg, init))
    single_s, _ = _phase_end(f"step 14 reference: the pyramid in one process, process_level on all {NUM_CAMERAS} "
                             f"destinations, mismatch stage from level {STEP14_MISMATCHES_START_LEVEL}", t, smi)
    _, gt0 = synthetic.render_sphere_scene(rig, size, radius=5.0, device=dev)
    med, _ = relative_error(ref[0]["disparity"].cpu().numpy(), gt0.cpu().numpy())
    log(f"  level 0: median relative disparity error {med:.5f} (bar {LEVEL0_BAR})")
    if not med < LEVEL0_BAR:
        raise AssertionError(f"step 14 reference level 0: median relative error {med}")
    init0 = torch.stack([pipeline.upsample_disparity_init(m, size) for m in ref[1]["disparity"]])
    frame1 = solver.process_level(solver.with_images(ctx0, ctx0.src_imgs * 0.9 + 0.05), cfg0, init0)
    per_rank = NUM_CAMERAS * STEP14_FRAMES // STEP14_RANKS
    want_a = map_digests(ref[0])
    want_b = {(f, d): map_digests(out, slice(d, d + per_rank))
              for f, out in enumerate((ref[0], frame1)) for d in range(0, NUM_CAMERAS, per_rank)}
    del frame1
    torch.cuda.empty_cache()

    coordinator = f"127.0.0.1:{free_port()}"
    paths = [os.path.join(tmp, f"step14_rank{r}.json") for r in range(STEP14_RANKS)]
    t = time.time()
    run_ranks(step14_rank, lambda r: (coordinator, rig, widths, paths[r]), STEP14_RANKS, STEP14_TIMEOUT_S)
    ranks_s = time.time() - t
    reports = []
    for path in paths:
        with open(path) as f:
            reports.append(json.load(f))
    for r in reports:
        a, b = r["a"], r["b"]
        log(f"step 14 rank {r['rank']}/{r['world']} ({r['backend']}, {r['device']}): (a) destinations "
            f"{a['destinations']}: {a['seconds']:.2f} s, peak {a['peak_gib']:.2f} GiB, launches {a['launches']}, "
            f"gathered {a['gathered_bytes']} B; (b) frame {b['frames']}, destinations {b['destinations']}: "
            f"{b['seconds']:.2f} s, peak {b['peak_gib']:.2f} GiB, launches {b['launches']}, "
            f"gathered {b['gathered_bytes']} B; {smi}")
        if r["backend"] != "gloo" or r["world"] != STEP14_RANKS or not r["device"].startswith("cuda"):
            raise AssertionError(f"step 14 rank {r['rank']}: {r['backend']}, world {r['world']}, {r['device']}")
        if a["digests"] != want_a:
            raise AssertionError(f"step 14 (a) rank {r['rank']}: gathered level-0 maps differ from process_level's "
                                 f"in {[k for k in want_a if a['digests'][k] != want_a[k]]}")
        want = want_b[(b["frames"][0], b["destinations"][0])]
        if b["digests"] != want:
            raise AssertionError(f"step 14 (b) rank {r['rank']}: frame {b['frames']} maps differ from process_level's "
                                 f"in {[k for k in want if b['digests'][k] != want[k]]}")
        # level 0 runs K3 (2048x1536) and K1 (the mismatch stage) only
        missing = [k for k in ("project_sample", "ssd_combine", "cost_fused") if a["launches"][k] <= 0]
        missing += [k for k in ("project_sample", "cost_fused") if b["launches"][k] <= 0]
        if missing:
            raise AssertionError(f"step 14 rank {r['rank']} never launched {missing}")
    log(f"step 14 (a) camera mesh, (b) frame x camera mesh: {STEP14_RANKS} gloo ranks in {ranks_s:.2f} s "
        f"(spawn to exit); every rank's maps equal the single-process solve's bit for bit; {smi}")
    for phase in ("a", "b"):
        log(f"  step 14 ({phase}) peak a rank {max(r[phase]['peak_gib'] for r in reports):.2f} GiB, predicted "
            f"{STEP14_PREDICTED_PEAK_GIB[phase]:.2f} GiB, reached in rank 0's {reports[0][phase]['peak_at']} of "
            f"{reports[0][phase]['stages']} marked stages; {smi}")

    # (c) the production backend: one NCCL rank on the card
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    multihost.maybe_initialize(coordinator_address=f"127.0.0.1:{free_port()}", num_processes=1, process_id=0,
                               device=dev)
    try:
        backend = dist.get_backend()
        mesh = sharding.camera_mesh()
        t = _phase_start()
        with counting_gathers() as gathered:
            full = sharding.gather_result(sharding.process_level_sharded(ctx0, cfg0, mesh, init0), mesh)
        nccl_s, nccl_launches = _phase_end(f"step 14 (c) level 0 on the camera mesh, 1 {backend} rank", t, smi)
        nccl_peak = torch.cuda.max_memory_allocated() / 2**30
        nccl_equal = map_digests(full) == want_a
    finally:
        multihost.shutdown()
    log(f"  gathered {gathered[0]} B; equal to process_level: {nccl_equal}; launches {nccl_launches}; peak "
        f"{nccl_peak:.2f} GiB, predicted {STEP14_PREDICTED_PEAK_GIB['c']:.2f} GiB; {smi}")
    if backend != "nccl" or not nccl_equal or min(nccl_launches[k] for k in ("project_sample", "cost_fused")) <= 0:
        raise AssertionError(f"step 14 (c): backend {backend}, equal {nccl_equal}, launches {nccl_launches}")

    metrics = dict(
        step14_single_pyramid_s=single_s, step14_level0_median_rel_err=med, step14_ranks_s=ranks_s,
        step14a_rank_s=[r["a"]["seconds"] for r in reports], step14a_peak_gib=[r["a"]["peak_gib"] for r in reports],
        step14a_gathered_bytes=[r["a"]["gathered_bytes"] for r in reports],
        step14b_rank_s=[r["b"]["seconds"] for r in reports], step14b_peak_gib=[r["b"]["peak_gib"] for r in reports],
        step14b_gathered_bytes=[r["b"]["gathered_bytes"] for r in reports],
        step14c_s=nccl_s, step14c_peak_gib=nccl_peak, step14c_gathered_bytes=gathered[0],
        step14_backends=dict(a="gloo", b="gloo", c=backend))
    phases = {"step14a_ranks": [r["a"]["launches"] for r in reports],
              "step14b_ranks": [r["b"]["launches"] for r in reports], "step14c": nccl_launches}
    return metrics, phases


# ---- step 16: the TPU sampler's semantics (use_pallas_sampler=True) ----

STEP16_WIDTHS = (256, 512, 2048)  # K1 then K2 below 512x384, K3 from there up, and the finest level
STEP16_CHECK_MAPS = 4  # destination maps the twins are checked on from 512x384 up (K1 samples all 16)


# k1_flops(0) split as common.cuh splits the projection: the world point of
# a destination pixel (the clamp, the reciprocal, three products and three
# sums), then the rest of a (pixel, source) projection
WORLD_POINT_FLOPS = 8
PROJECT_FLOPS = k1_flops(0) - WORLD_POINT_FLOPS


def tile_windows_work(n, disp, rays):
    """The anchor kernel's least work on D maps ``disp`` (D, H, W) and
    ``rays`` (D, 3, H, W): each map's disparity and rays read once, the
    cameras once, the anchors written once; the world point once a pixel,
    the projection once a (source, pixel with d > 0 and a ray) pair (the
    others project nothing)."""
    d, h, w = disp.shape
    projected = ((disp > 0) & ~rays.isnan().any(dim=1)).sum().item()
    tiles = -(-h // 24) * -(-w // 128)
    return (d * 16 * h * w + n * PARAM_BYTES + d * n * tiles * 8,
            d * h * w * WORLD_POINT_FLOPS + n * projected * PROJECT_FLOPS)


def _tpu_flags_share(clipped, valid, exclude=None):
    """The share of visible (source, pixel) pairs that are clipped, the
    destinations' own sources left out (``exclude``: each map's)."""
    import torch

    if exclude is not None:
        lanes = torch.arange(clipped.shape[1], device=clipped.device)[None, :, None, None]
        own = lanes == torch.as_tensor(exclude, device=clipped.device)[:, None, None, None]
        clipped, valid = clipped & ~own, valid & ~own
    seen = (clipped | valid).sum().item()
    return clipped.sum().item() / max(seen, 1)


def step16_kernels(dev, smi):
    """Step 16 (a): the anchor kernel, K1 in TPU mode (C = 3 on the
    quantized stack, C = 2 on the mismatch stage's planes) and K3 in TPU
    mode against their twins at 256x192, 512x384 and 2048x1536 with the
    default windows, on the kernels' own anchors (the twins' anchors beside:
    >= 98% equal, else one alignment step apart); flags agree but for 1e-3
    of the pairs, samples are bit-equal at >= 99.5% of those both call
    valid (k/256 colors; C = 2 within 1e-6 relative) and K3's costs within
    1e-4 relative at >= 99% of the pixels both evaluate (the card tests'
    bounds). Each is timed as step 3 times its kernel, beside the default
    mode's kernel on the same inputs. Returns the per-kernel results."""
    import torch

    from facebook360_dep_tpu_torch.depth import solver
    from facebook360_dep_tpu_torch.ops import cost as cost_ops
    from facebook360_dep_tpu_torch.ops import warp_cuda as wc

    names = ("tile_windows", "project_sample_tpu", "cost_fused_tpu")
    results = {k: dict(max_abs_err=0.0, levels=[]) for k in names}
    flt_max = cost_ops.FLT_MAX
    log("step 16 (a): the TPU sampler's kernels against their twins, default windows (256 x 40):")
    for width in STEP16_WIDTHS:
        ctx, disp, gt, fov = level_inputs(width, dev, use_pallas_sampler=True)
        cctx = solver.cost_context(ctx)
        n, hs, ws, _ = ctx.src_tpu.shape
        d, h, w = disp.shape
        small = w * h < cost_ops.FUSED_MIN_PIXELS
        k = d if small else STEP16_CHECK_MAPS
        args = (ctx.src_params, ctx.dst_cams.position[:k], disp[:k], ctx.dst_rays[:k])
        # anchors, plain and reflect-padded, against the twin's
        for reflect in (False, True):
            a_k = wc.tile_windows(*args, (hs, ws), reflect=reflect)
            a_p = wc.tile_windows_plain(*args, (hs, ws), reflect=reflect)
            same = (a_k == a_p).all(-1).double().mean().item()
            far = ((a_k - a_p).abs() > torch.tensor([128, 8], device=dev)).any().item()
            results["tile_windows"]["max_abs_err"] = max(results["tile_windows"]["max_abs_err"],
                                                         float((a_k - a_p).abs().max().item()))
            log(f"  anchors {w}x{h} ({'reflect' if reflect else 'edge'} padding, {k} maps): equal to the twin's at "
                f"{same:.5f} of (tile, source) pairs")
            if same < 0.98 or far:
                raise AssertionError(f"tile_windows {w}x{h}: {same} equal, beyond one step {far}")
        anchors = wc.tile_windows(*args, (hs, ws))
        # K1 in TPU mode, C = 3
        s_k, v_k, c_k = wc.project_sample_tpu(ctx.src_tpu, *args, anchors)
        s_p, v_p, c_p = wc.project_sample_tpu_plain(wc.planar_view(ctx.src_tpu), *args, anchors)
        torch.cuda.synchronize()
        compare_validity(f"K1 TPU {w}x{h} valid", v_k, v_p, 1e-3)
        compare_validity(f"K1 TPU {w}x{h} clipped", c_k, c_p, 1e-3)
        both = (v_k & v_p)[:, :, None].expand_as(s_k)
        exact = (s_k == s_p)[both].double().mean().item()
        err1 = compare(f"K1 TPU {w}x{h} sampled (bit-equal at {exact:.5f})", s_k[both], s_p[both], 2.0 / 256.0, 0.0,
                       0.0)
        clip_share = _tpu_flags_share(c_k, v_k, cctx.exclude_idx[:k])
        if exact < 0.995:
            raise AssertionError(f"K1 TPU {w}x{h}: samples bit-equal at {exact}")
        del s_k, s_p, both
        # K1 in TPU mode, C = 2 (the mismatch stage's planes)
        full = torch.where(fov, gt, float("nan"))
        planes = torch.stack([torch.nan_to_num(full), torch.isfinite(full).float()], dim=1)
        p_k, pv_k, pc_k = wc.project_sample_planes_tpu(planes, *args, anchors)
        p_p, pv_p, pc_p = wc.project_sample_tpu_plain(planes, *args, anchors)
        torch.cuda.synchronize()
        compare_validity(f"K1 TPU C=2 {w}x{h} valid", pv_k, pv_p, 1e-3)
        b2 = (pv_k & pv_p)[:, :, None].expand_as(p_k)
        err_c2 = compare(f"K1 TPU C=2 {w}x{h} sampled", p_k[b2], p_p[b2], 1e-7, 1e-6, 5e-3)
        del p_k, p_p, b2
        # K3 in TPU mode, destination 3
        one = (ctx.src_params, ctx.dst_cams.position[3], disp[3], ctx.dst_rays[3])
        rest = (cctx.dst_planar[3], cctx.variance[3], cctx.exclude_idx[3])
        a3 = wc.tile_windows(*one, (hs, ws), reflect=True)
        c3_k, f3_k = wc.cost_fused_tpu(ctx.src_tpu, *one, *rest, a3)
        c3_p, f3_p = wc.cost_fused_tpu_plain(wc.planar_view(ctx.src_tpu), *one, *rest, a3)
        torch.cuda.synchronize()
        compare_validity(f"K3 TPU {w}x{h} cost finite", c3_k < flt_max, c3_p < flt_max, 1e-2)
        fin = (c3_k < flt_max) & (c3_p < flt_max)
        err3 = compare(f"K3 TPU {w}x{h} cost", c3_k[fin], c3_p[fin], 0.0, 1e-4, 1e-2)
        compare(f"K3 TPU {w}x{h} confidence", f3_k, f3_p, 0.0, 0.0, 1e-3)
        log(f"  clipped share of visible (source, pixel) pairs at {w}x{h} ({k} maps): {clip_share:.6f}; {smi}")
        # times, the default mode's kernel beside each
        rows = dict(
            tile_windows=level_row(f"anchors ({k} maps)", h, w, lambda: wc.tile_windows(*args, (hs, ws)),
                                   tile_windows_work(n, disp[:k], ctx.dst_rays[:k]), 20, 20),
            project_sample_tpu=level_row(f"K1 TPU ({k} maps)", h, w,
                                         lambda: wc.project_sample_tpu(ctx.src_tpu, *args, anchors),
                                         k1_work(n, 3, hs, ws, h, w, k), 20, 10),
            cost_fused_tpu=level_row("K3 TPU", h, w, lambda: wc.cost_fused_tpu(ctx.src_tpu, *one, *rest, a3),
                                     k3_work(n, hs, ws, h, w), 20, 10))
        default = dict(
            project_sample=level_row(f"  default K1 ({k} maps)", h, w,
                                     lambda: wc.project_sample(ctx.src_rgba, *args), k1_work(n, 3, hs, ws, h, w, k),
                                     20, 10),
            cost_fused=level_row("  default K3", h, w, lambda: wc.cost_fused(ctx.src_rgba, *one, *rest),
                                 k3_work(n, hs, ws, h, w), 20, 10))
        for name, row in rows.items():
            row.update(maps=1 if name == "cost_fused_tpu" else k, clipped_share=clip_share,
                       default_ms=default["cost_fused" if name == "cost_fused_tpu" else "project_sample"]["ms"],
                       default_graph_ms=default["cost_fused" if name == "cost_fused_tpu" else "project_sample"][
                           "graph_ms"])
            results[name]["levels"].append(row)
        results["project_sample_tpu"]["max_abs_err"] = max(results["project_sample_tpu"]["max_abs_err"], err1,
                                                           err_c2)
        results["cost_fused_tpu"]["max_abs_err"] = max(results["cost_fused_tpu"]["max_abs_err"], err3)
        if width == WIDTHS[0]:  # the twins at full width: the packed path's (anchors and K3) and K1's
            results["tile_windows"]["plain_ms"] = cuda_time_ms(
                lambda: wc.tile_windows_plain(*one, (hs, ws), reflect=True), 3, warmup=1)
            results["cost_fused_tpu"]["plain_ms"] = cuda_time_ms(
                lambda: wc.cost_fused_tpu_plain(wc.planar_view(ctx.src_tpu), *one, *rest, a3), 3, warmup=1)
            results["project_sample_tpu"]["plain_ms"] = cuda_time_ms(
                lambda: wc.project_sample_tpu_plain(wc.planar_view(ctx.src_tpu), *args, anchors), 3, warmup=1)
            log(f"  plain twins at {w}x{h}: anchors (one map, reflect) {results['tile_windows']['plain_ms']:.3f} ms, "
                f"K1 TPU ({k} maps) {results['project_sample_tpu']['plain_ms']:.3f} ms, K3 TPU "
                f"{results['cost_fused_tpu']['plain_ms']:.3f} ms")
        del ctx, cctx, args, one, rest, anchors, a3
        torch.cuda.empty_cache()
    for name, r in results.items():
        top = r["levels"][-1]  # 2048x1536
        r.update(shape=top["shape"], ms=top["ms"], graph_ms=top["graph_ms"], bound_ms=top["bound_ms"],
                 bound_by=top["bound_by"], library_ms=None, library="none: no single PyTorch call computes it")
    return results


def default_kernel_digests(dev):
    """SHA-256 of the default-mode K1 (C = 3, all 16 maps; C = 1), K2 and
    K3 outputs on step 3's inputs at 256x192 and 2048x1536 (K1 there on 4
    maps), and of the anchor kernel's at 256x192, 512x384 and 2048x1536
    (edge and reflect padding; all 16 maps in one launch, and map 3 alone):
    run in two checkouts, equal digests are equal bits."""
    import hashlib

    import torch

    from facebook360_dep_tpu_torch.depth import solver
    from facebook360_dep_tpu_torch.ops import warp_cuda as wc

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

    out = {}
    for width in (256, 512, 2048):
        ctx, disp, gt, fov = level_inputs(width, dev)
        src_hw = tuple(ctx.src_imgs.shape[1:3])
        params, pos, rays = ctx.src_params, ctx.dst_cams.position, ctx.dst_rays
        for reflect in (False, True):
            for maps, args in (("16maps", (params, pos, disp, rays)), ("map3", (params, pos[3], disp[3], rays[3]))):
                out[f"anchors_{width}_{'reflect' if reflect else 'edge'}_{maps}"] = digest(
                    wc.tile_windows(*args, src_hw, reflect=reflect))
        if width == 512:  # the anchors' level only
            continue
        cctx = solver.cost_context(ctx)
        k = 16 if width == 256 else 4
        args = (ctx.src_params, ctx.dst_cams.position[:k], disp[:k], ctx.dst_rays[:k])
        s3, v3 = wc.project_sample(ctx.src_rgba, *args)
        s1, v1 = wc.project_sample_planes(torch.where(fov, gt, float("nan"))[:, None].contiguous(), *args)
        one = (ctx.src_params, ctx.dst_cams.position[3], disp[3], ctx.dst_rays[3])
        rest = (cctx.dst_planar[3], cctx.variance[3], cctx.exclude_idx[3])
        c2 = wc.ssd_combine(s3[3], v3[3], *rest)
        c3 = wc.cost_fused(ctx.src_rgba, *one, *rest)
        for name, ts in (("k1_c3", (s3, v3)), ("k1_c1", (s1, v1)), ("k2", c2), ("k3", c3)):
            out[f"{name}_{width}"] = digest(*ts)
        del ctx, cctx, s3, v3, s1, v1
        torch.cuda.empty_cache()
    return out


def _tpu_config(level, ctx, num_levels, windows):
    """step14_config with the TPU sampler's window of the level:
    cost.auto_window's, kept only where it exceeds the defaults (the JAX
    pipeline's rule, depth/pipeline.py:390-401); recorded in ``windows``."""
    from facebook360_dep_tpu_torch.depth import solver
    from facebook360_dep_tpu_torch.ops import cost as cost_ops

    h, w = ctx.src_imgs.shape[1:3]
    ww, wh = cost_ops.auto_window(ctx.src_cams, ctx.dst_cams, (h, w), min_depth=1.0, max_depth=100.0)
    windows[level] = (ww, wh)
    return solver.SolverConfig(min_depth=1.0, max_depth=100.0, mismatches_start_level=STEP14_MISMATCHES_START_LEVEL,
                               level=level, num_levels=num_levels, ww_max=None if ww <= 256 else ww,
                               wh_max=None if wh <= 40 else wh)


def _tpu_pyramid(name, rig, dev, smi, sizes):
    """The TPU-semantics pyramid of ``rig``'s sphere scene (all 16
    destinations, the mismatch stage from level STEP14_MISMATCHES_START_LEVEL),
    its launches counted from zero; then the clipped share of each level's
    final maps (launches not counted). Returns (level-0 result, launches,
    launches by (kernel, H, W), windows, clipped share by level, seconds)."""
    import torch

    from facebook360_dep_tpu_torch.core import camera as cam
    from facebook360_dep_tpu_torch.depth import pipeline, solver
    from facebook360_dep_tpu_torch.ops import cost as cost_ops
    from facebook360_dep_tpu_torch.ops import warp_cuda as wc

    windows = {}
    levels = list(range(len(sizes)))
    t = _phase_start()
    kept, _ = sphere_pyramid(rig, [s[0] for s in sizes], dev, lambda ctx, cfg, init: solver.process_level(ctx, cfg, init),
                             keep=levels, use_pallas_sampler=True, sizes=sizes,
                             config=lambda level, ctx: _tpu_config(level, ctx, len(sizes), windows))
    seconds, launches = _phase_end(f"step 16 {name}: the TPU-semantics pyramid in one process", t, smi)
    by_shape = dict(wc.LAUNCHES_BY_SHAPE)
    nrig = cam.normalize_rig(rig)
    params = wc.pack_camera_params(nrig.cameras.to(dev, torch.float32))
    exclude = list(cam.map_src_to_dst_indexes(nrig, nrig))
    clipped = {}
    for level in levels:
        maps = kept[level]["disparity"]
        n, h, w = maps.shape
        ww, wh = windows[level]
        window = (None if ww <= 256 else ww, None if wh <= 40 else wh)
        fov = pipeline.generate_fov_masks(nrig, (h, w), dev)
        rays = cost_ops.dst_ray_dirs(nrig.cameras.to(dev, torch.float32), h, w)
        rays = torch.where(fov[..., None], rays, float("nan")).permute(0, 3, 1, 2).contiguous()
        stack = torch.zeros((n, 1, h, w), device=dev)  # the flags do not depend on the colors
        seen = clip = 0
        for i in range(n):
            disp = torch.nan_to_num(maps[i], nan=0.0).contiguous()  # masked pixels sample nothing (disparity 0)
            one = (params, nrig.cameras.position[i].to(dev, torch.float32), disp, rays[i])
            _, v, c = wc.project_sample_planes_tpu(stack, *one, wc.tile_windows(*one, (h, w), window), window)
            v[exclude[i]] = c[exclude[i]] = False
            seen += (v | c).sum().item()
            clip += c.sum().item()
        clipped[level] = clip / max(seen, 1)
        log(f"  level {level} ({w}x{h}): window {ww}x{wh} (auto_window; solved with "
            f"{window[0] or 256}x{window[1] or 40}), clipped share of the final maps' visible pairs {clipped[level]:.6f}")
    return kept[0], launches, by_shape, windows, clipped, seconds


def check_anchor_launches(name, by_shape, d):
    """One anchor launch a cost evaluation of the D = ``d`` maps and one a
    mismatch stage, at every level: as many as K1 TPU launches there (the
    cost evaluations below 512x384, the mismatch stage's everywhere) plus
    K3 TPU's, which run a map. Raises otherwise."""
    shapes = sorted({(h, w) for _, h, w in by_shape}, reverse=True)
    total = 0
    for h, w in shapes:
        anchors = by_shape.get(("tile_windows", h, w), 0)
        k1, k3 = by_shape.get(("project_sample_tpu", h, w), 0), by_shape.get(("cost_fused_tpu", h, w), 0)
        if k3 % d or anchors != k1 + k3 // d:
            raise AssertionError(f"step 16 {name} at {w}x{h}: {anchors} anchor launches, K1 TPU {k1}, "
                                 f"K3 TPU {k3} over {d} maps")
        total += anchors
    log(f"  step 16 {name}: one anchor launch a cost evaluation and a mismatch stage at every level, {total} in all")


def run_step16(dev, smi):
    """Step 16: the TPU sampler's semantics. (a) step16_kernels; (b) the
    sphere's ten-level 16-camera 2K pyramid on use_pallas_sampler contexts
    with auto_window's windows: the level-0 median relative error (bar
    LEVEL0_BAR), the share of level-0 pixels whose maps differ from the
    default mode's and the clipped share per level, every TPU kernel (and
    K2) launched and no default-mode K1 or K3; (c) the production FTHETA
    shape (step 13b's rig): the window per level, the clipped share and the
    level-0 error inside the image circles (bar LEVEL0_BAR). (b) and (c)
    print their level-0 maps' digests, then hold their launches to one
    anchor launch a cost evaluation at every level (check_anchor_launches).
    Returns (metrics, the kernel results, launches by phase)."""
    import torch

    from facebook360_dep_tpu_torch.core import camera as cam
    from facebook360_dep_tpu_torch.depth import pipeline, solver
    from facebook360_dep_tpu_torch.render import synthetic

    t = time.time()
    checks = step16_kernels(dev, smi)
    kernels_s = time.time() - t

    rig = synthetic.make_test_rig(NUM_CAMERAS, (WIDTHS[0], height(WIDTHS[0])), ring_radius=0.3)
    sizes = [(w, height(w)) for w in WIDTHS]
    t = _phase_start()
    ref, _ = sphere_pyramid(rig, WIDTHS, dev, lambda ctx, cfg, init: solver.process_level(ctx, cfg, init), keep=(0,))
    default_s, _ = _phase_end("step 16 (b): the default-mode pyramid (the reference for the differing share)", t, smi)
    tpu0, launches, by_shape, windows, clipped, tpu_s = _tpu_pyramid("(b) sphere", rig, dev, smi, sizes)
    digests = map_digests(tpu0)  # printed before any check, so a parent checkout's run prints them too
    log(f"  step 16 (b) level-0 digests: {json.dumps(digests)}")
    want = ("tile_windows", "project_sample_tpu", "ssd_combine", "cost_fused_tpu")
    if min(launches[k] for k in want) <= 0 or launches["project_sample"] or launches["cost_fused"]:
        raise AssertionError(f"step 16 (b): launches {launches}")
    _, gt0 = synthetic.render_sphere_scene(rig, sizes[0], radius=5.0, device=dev)
    a, b = tpu0["disparity"], ref[0]["disparity"]
    med, _ = relative_error(a.cpu().numpy(), gt0.cpu().numpy())
    differ = (a.view(torch.int32) != b.view(torch.int32)).double().mean().item()
    apart = ((a - b).abs() > 0.01 * b.abs()).double().mean().item()  # NaN on either side counts as not apart
    log(f"  level 0 (TPU semantics): median relative disparity error {med:.5f} (bar {LEVEL0_BAR}); the default "
        f"mode's {relative_error(b.cpu().numpy(), gt0.cpu().numpy())[0]:.5f}; maps differ from the default mode's "
        f"at {differ:.5f} of the pixels, by more than 1% at {apart:.5f}; launches {launches}; {smi}")
    if not med < LEVEL0_BAR:
        raise AssertionError(f"step 16 (b): level-0 median relative error {med}")
    del ref, tpu0, a, b

    frig = synthetic.make_ftheta_ring_rig(15, ring_radius=0.33, resolution=FTHETA_RESOLUTION,
                                          distortion=synthetic.PRODUCTION_FTHETA_DISTORTION)
    fsizes = [(w, int(round(w * FTHETA_RESOLUTION[1] / FTHETA_RESOLUTION[0]))) for w in WIDTHS]
    f0, f_launches, f_by_shape, f_windows, f_clipped, f_s = _tpu_pyramid("(c) production FTHETA shape", frig, dev,
                                                                          smi, fsizes)
    f_digests = map_digests(f0)
    log(f"  step 16 (c) level-0 digests: {json.dumps(f_digests)}")
    _, ftruth = synthetic.render_sphere_scene(frig, fsizes[0], radius=5.0, device=dev)
    circles = pipeline.generate_fov_masks(cam.normalize_rig(frig), fsizes[0][::-1], "cpu").numpy()
    f_med, f_cov, f_rmse = level0_error_in(f0["disparity"].cpu().numpy(), ftruth.cpu().numpy(), circles,
                                           "step 16 (c) FTHETA level 0 (TPU semantics) inside the image circles")
    if min(f_launches[k] for k in want) <= 0:
        raise AssertionError(f"step 16 (c): launches {f_launches}")
    check_anchor_launches("(b)", by_shape, NUM_CAMERAS)
    check_anchor_launches("(c)", f_by_shape, frig.cameras.position.shape[0])
    metrics = dict(step16_kernels_s=kernels_s, step16_default_pyramid_s=default_s, step16_tpu_pyramid_s=tpu_s,
                   step16_level0_median_rel_err=med, step16_level0_differing_share=differ,
                   step16_level0_share_apart_1pct=apart, step16_level0_digests=digests,
                   step16_ftheta_level0_digests=f_digests,
                   step16_windows={str(k): v for k, v in windows.items()},
                   step16_clipped_share={str(k): v for k, v in clipped.items()},
                   step16_ftheta_s=f_s, step16_ftheta_level0_median_rel_err=f_med,
                   step16_ftheta_level0_circle_coverage=f_cov, step16_ftheta_level0_covered_rel_rmse=f_rmse,
                   step16_ftheta_windows={str(k): v for k, v in f_windows.items()},
                   step16_ftheta_clipped_share={str(k): v for k, v in f_clipped.items()})
    return metrics, checks, dict(sphere=launches, ftheta=f_launches)


def _oracle_module():
    """tests/torch_oracle.py: the reference's scalar cost oracle and its
    mini-solver oracle without JAX, shared with the CPU tests."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_oracle

    return torch_oracle


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def step15_cost_oracles(oracle, dev, smi: str):
    """Step 15 (a): the port's cost_for_disparity on the card held to the
    reference's scalar cost oracle (tests/torch_oracle.py) with the bounds
    of tests/test_cost_oracle.py: the translation rig against the
    'perpixel' oracle (5e-4 * (1 + |want|), >= 20 pixels) at 64x48 (K1
    then K2) and at 512x384 (K3); the sphere against the literal 'center'
    oracle (median gap < 0.02, > 90% under 0.2) on the 4-camera rig of the
    original at 64x48, and on the 16-camera ring at 256x192 (K1 then K2)
    and at 512x384 (K3). Returns (metrics, launches, the 256x192 scene for
    the K2 check)."""
    import numpy as np

    from facebook360_dep_tpu_torch.core import camera as cam
    from facebook360_dep_tpu_torch.ops import cost
    from facebook360_dep_tpu_torch.render import synthetic

    def cost_map(rig, imgs, disparity):
        ctx, variance = oracle.one_dst_cost_context(rig, imgs, 0, dev)
        return cost.cost_for_disparity(ctx, disparity)[0][0].cpu().numpy(), variance

    def path(size):
        return "K3" if size[0] * size[1] >= cost.FUSED_MIN_PIXELS else "K1 then K2"

    metrics, scene256 = {}, None
    t = _phase_start()
    for size in ((64, 48), (512, 384)):
        checked, worst = oracle.check_translation_rig(cost_map, size=size)
        log(f"  translation rig {size[0]}x{size[1]} ({path(size)}): {checked} pixels within 5e-4 (1 + |want|) of the "
            f"'perpixel' oracle, largest gap {worst:.3e}")
        metrics[f"oracle_translation_{size[0]}x{size[1]}_max_rel"] = float(worst)
    for n, ring, size in ((4, 0.1, (64, 48)), (NUM_CAMERAS, 0.3, (256, 192)), (NUM_CAMERAS, 0.3, (512, 384))):
        rig = synthetic.make_test_rig(num_cameras=n, resolution=size, ring_radius=ring)
        nrig = cam.normalize_rig(rig)
        colors, gt = synthetic.render_sphere_scene(rig, size, radius=5.0, device=dev)
        colors = colors.cpu().numpy()
        disparity = float(np.nanmedian(gt[0].cpu().numpy()))
        c_map, variance = cost_map(nrig, colors, disparity)
        pixels, median, share = oracle.check_general_rig(nrig, colors, disparity, c_map, variance)
        log(f"  sphere, {n} cameras, {size[0]}x{size[1]} ({path(size)}): {pixels} pixels, median gap from the "
            f"'center' oracle {median:.5f} (bar 0.02), share under 0.2 {share:.3f} (bar 0.9)")
        metrics[f"oracle_sphere_{n}cams_{size[0]}x{size[1]}_median"] = median
        if size == (256, 192):
            scene256 = (nrig, colors, disparity)
    seconds, launches = _phase_end("cost oracles on the card (step 15a)", t, smi)
    metrics["step15a_s"] = seconds
    return metrics, launches, scene256


def step15_k2_against_combine_ssds(oracle, scene, dev):
    """Step 15 (a), last: K2's cost and confidence at 256x192 against
    cost.combine_ssds, the sort-based plain combine, on K1's samples (not
    counted as the path's launches). The confidence must be equal; the
    cost within 8 float32 ulps of the total of the unbiased SSDs, scaled
    as the cost is (K2 drops the two worst from a running total, the sort
    keeps a prefix), at all but 1e-4 of the pixels, where a near tie of
    two biased SSDs may order them apart."""
    import torch

    from facebook360_dep_tpu_torch.ops import cost
    from facebook360_dep_tpu_torch.ops import warp_cuda as wc

    nrig, colors, disparity = scene
    ctx, _ = oracle.one_dst_cost_context(nrig, colors, 0, dev)
    d, _, h, w = ctx.dst_planar.shape
    disp = torch.full((d, h, w), disparity, dtype=torch.float32, device=dev)
    sampled, valid = wc.project_sample(ctx.src_rgba, ctx.src_params, ctx.cam_dst.position, disp, ctx.dst_rays)
    k2_cost, k2_conf = wc.ssd_combine(sampled[0], valid[0], ctx.dst_planar[0], ctx.variance[0], ctx.exclude_idx[0])
    biased, unbiased, v = cost.ssd_planar(ctx.dst_planar[0].permute(1, 2, 0), sampled[0], valid[0])
    v = v & (torch.arange(v.shape[0], device=dev) != ctx.exclude_idx[0])[:, None, None]
    plain_cost, plain_conf = cost.combine_ssds(biased, unbiased, v, ctx.variance[0])
    _require(torch.equal(k2_conf, plain_conf), "K2's confidence differs from combine_ssds'")
    _require(torch.equal(k2_cost >= 1e30, plain_cost >= 1e30), "K2's FLT_MAX pixels differ from combine_ssds'")
    keep = torch.clamp(v.sum(0) - 2, min=1).to(torch.float32)
    total = torch.where(v, unbiased, 0.0).sum(0) / (keep * keep) / plain_conf.clamp(min=cost.MIN_VAR)
    finite = plain_cost < 1e30
    gap = torch.where(finite, (k2_cost - plain_cost).abs(), 0.0)
    outside = float(((gap > 8 * 1.1920929e-07 * total) & finite).double().mean())
    max_err = float(gap.max())
    log(f"  K2 against combine_ssds at {w}x{h}: max_abs_err {max_err:.3e}, outside 8 ulps of the total {outside:.2e} "
        f"(allowed 1e-4); confidence equal")
    _require(outside <= 1e-4, f"K2 against combine_ssds: {outside:.2e} of the pixels outside the bound")
    return dict(k2_vs_combine_ssds_max_abs_err=max_err, k2_vs_combine_ssds_outside=outside)


def step15_enlarging_clis(tmp: str, root: str, out_root: str, full_mssim: float, dev, smi: str):
    """Step 15 (b): the CLIs that raised on enlarging resizes before the
    port had them, on the sphere project of step 4: the rephotography of
    the level-1 colors (1024x768, enlarged) against the level-0 maps
    (K4), upsample_disparity of four cameras' level 1 to 2048 with the
    level-1 colors, and view_thresholds color_variance of a level-1 image
    at twice its width. Each must return and write finite outputs; the
    rephotography must meet the repo's bar, 89.95. Returns (metrics,
    launches)."""
    import numpy as np

    from facebook360_dep_tpu_torch.cli import compute_rephotography_errors as cre
    from facebook360_dep_tpu_torch.cli import upsample_disparity, view_thresholds
    from facebook360_dep_tpu_torch.core import io

    rig_path = os.path.join(root, "rigs/rig_calibrated.json")
    level1 = os.path.join(root, "video/color_levels/level_1")
    launches, metrics = {}, {}
    t = _phase_start()
    result = cre.main(device=dev, argv=[
        "--color", level1, "--disparity", os.path.join(out_root, "disparity_levels/level_0"), "--rig", rig_path,
        "--output", os.path.join(tmp, "rephoto_level1"), "--first", "000000", "--last", "000000"])
    metrics["step15_rephoto_s"], launches = _phase_end("rephotography of enlarged level-1 colors (step 15b)", t, smi)
    mssim = 100 * sum(result["total"]) / 3
    small = io.image_size(os.path.join(level1, "cam0", "000000.png"))
    log(f"  TOTAL average MSSIM {mssim:.3f} from {small[0]}x{small[1]} colors enlarged to {WIDTHS[0]}x"
        f"{height(WIDTHS[0])} (bar 89.95; from the full-size colors {full_mssim:.3f}, step 7); K4 launches "
        f"{launches['warp_sample']}")
    _require(launches["warp_sample"] > 0, "K4 never launched by the enlarged rephotography")
    _require(bool(np.isfinite(mssim)) and mssim >= 90.0 - 0.05, f"enlarged rephotography MSSIM {mssim}")
    metrics["step15_rephoto_mssim"] = mssim

    cams = ["cam0", "cam1", "cam2", "cam3"]
    out = os.path.join(tmp, "upsampled")
    t = _phase_start()
    upsample_disparity.main(["--rig", rig_path, "--disparity", os.path.join(out_root, "disparity_levels/level_1"),
                             "--output", out, "--resolution", str(WIDTHS[0]), "--color", level1,
                             "--cameras", ",".join(cams)], device=dev)
    metrics["step15_upsample_s"], _ = _phase_end("upsample_disparity level 1 -> 2048 with level-1 colors (step 15b)",
                                                 t, smi)
    for c in cams:
        up = io.read_disparity(os.path.join(out, c, "000000.pfm"))
        _require(up.shape == (height(WIDTHS[0]), WIDTHS[0]) and bool(np.isfinite(up).all()),
                 f"upsample_disparity {c}: shape {up.shape}, finite {np.isfinite(up).mean():.4f}")

    out = os.path.join(tmp, "thresholds")
    t = _phase_start()
    view_thresholds.main(["color_variance", "--fullsize_image", os.path.join(level1, "cam0", "000000.png"),
                          "--width", str(WIDTHS[0]), "--output_dir", out], device=dev)
    metrics["step15_view_thresholds_s"], _ = _phase_end("view_thresholds at twice the image's width (step 15b)",
                                                        t, smi)
    with open(os.path.join(out, "variance_sweep.json")) as f:
        stats = json.load(f)["variance_stats"]
    pngs = sorted(n for n in os.listdir(out) if n.endswith(".png"))
    vis = io.read_color(os.path.join(out, pngs[0]))
    log(f"  {len(pngs)} visualizations of {vis.shape[1]}x{vis.shape[0]}; variance median {stats['median']:.3e}")
    _require(vis.shape[:2] == (height(WIDTHS[0]), WIDTHS[0]) and all(np.isfinite(v) for v in stats.values()),
             f"view_thresholds wrote {vis.shape} with {stats}")
    return metrics, launches


def step15_reference_solver(tmp: str, oracle, dev, smi: str):
    """Step 15 (c): the sphere scene of tests/test_ref_solver_oracle.py (16
    cameras, 256x192) through the port's solver on the card against
    tools/ref_cpu_baseline.cpp --mini_solver, with its bounds, where g++,
    pkg-config and opencv4 are on this host; else one line says why not.
    Returns (metrics, launches)."""
    missing = oracle.ref_tool_missing()
    if missing:
        log(f"  step 15c: the reference mini-solver did not run: {missing} on this host")
        return dict(step15_ref_solver=f"not run: {missing}"), {}
    tool = oracle.build_ref_tool(os.path.join(tmp, "ref_cpu_baseline"))
    rig, u16, gt = oracle.ref_scene("sphere", device=dev)
    t = _phase_start()
    port_disp, var_floor = oracle.run_port_mini_solver(rig, u16, dev)
    seconds, launches = _phase_end("the port's mini-solver on the card (step 15c)", t, smi)
    ref_disp = oracle.run_reference(tool, rig, u16, var_floor, os.path.join(tmp, "ref_solver"))
    readings = oracle.check_against_reference("sphere", port_disp, ref_disp, gt)
    log(f"  sphere: agree relRMSE {readings['agree_rel_rmse']:.5f} (bar 0.05), median {readings['agree_median']:.5f} "
        f"(bar 0.002); GT relRMSE port {readings['port_gt_rel_rmse']:.5f} vs reference "
        f"{readings['ref_gt_rel_rmse']:.5f} (bar 1.10x)")
    return dict(step15_ref_solver=readings, step15_ref_solver_s=seconds), launches


def run_step15(tmp: str, root: str, out_root: str, full_mssim: float, dev, smi: str):
    """Step 15: parity and oracles on the card. (a) the cost oracles and
    K2 against combine_ssds, (b) the enlarging CLIs, (c) the reference
    mini-solver. Every kernel must launch in it. Returns (metrics,
    launches of (a)-(c) by kernel)."""
    from facebook360_dep_tpu_torch.ops import warp_cuda as wc

    os.makedirs(tmp, exist_ok=True)
    oracle = _oracle_module()
    metrics, launches_a, scene256 = step15_cost_oracles(oracle, dev, smi)
    metrics.update(step15_k2_against_combine_ssds(oracle, scene256, dev))
    m, launches_b = step15_enlarging_clis(tmp, root, out_root, full_mssim, dev, smi)
    metrics.update(m)
    m, launches_c = step15_reference_solver(tmp, oracle, dev, smi)
    metrics.update(m)
    launches = {k: sum(part.get(k, 0) for part in (launches_a, launches_b, launches_c)) for k in wc.LAUNCHES}
    missing = [k for k in ("project_sample", "ssd_combine", "cost_fused", "warp_sample") if launches[k] <= 0]
    _require(not missing, f"kernels never launched in step 15: {missing}")
    log(f"  step 15 launches: {launches}")
    return metrics, launches


@contextlib.contextmanager
def profiled(out_dir, name):
    """torch.profiler over the block when ``out_dir`` is set; writes the
    operator table sorted by device time to DIR/<name>_profile.txt and
    prints its head."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not out_dir:
        yield
        return
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    averages = prof.key_averages()  # slow on a long run's events: once
    table = averages.table(sort_by="cuda_time_total", row_limit=60)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}_profile.txt"), "w") as f:
        f.write(table)
    # device-side events only: an operator's row repeats its kernels' time
    device = [e for e in averages if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in device)
    log(f"profile: device busy {busy_us / 1e6:.3f} s (sum of kernel self time), "
        f"{sum(e.count for e in device)} device events (kernels, copies, fills)")
    log("\n".join(table.splitlines()[:30]))


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    parser.add_argument("--profile", default="",
                        help="profile the derp_cli, rephotography and foreground-solve runs; write the tables here")
    parser.add_argument("--solve", nargs=2, metavar=("ROOT", "OUT"),
                        help="write the sphere scene's project tree to ROOT unless it is there, run derp_cli on it "
                             "into OUT (timed; profiled with --profile), print one JSON line and stop")
    parser.add_argument("--reference", default="",
                        help="with --solve: the OUT of an earlier solve of ROOT, whose level-0 maps OUT's are held to")
    parser.add_argument("--mismatches_start_level", type=int, default=-1,
                        help="with --solve: derp_cli's flag (the mismatch stage at levels L..0; -1, its default, "
                             "skips it)")
    parser.add_argument("--kernels-only", action="store_true",
                        help="build K1-K4, run the K1-K3 checks and per-level times (step 3), print them and stop")
    parser.add_argument("--step14", action="store_true",
                        help="build the kernels, run the multi-GPU path (step 14) alone, print its JSON and stop")
    parser.add_argument("--step16", action="store_true",
                        help="build the kernels, run the TPU sampler's semantics (step 16) alone, print its JSON and "
                             "stop")
    parser.add_argument("--kernel-digests", action="store_true",
                        help="build the kernels, print the digests of the default-mode K1-K3 outputs and the "
                             "anchor kernel's (default_kernel_digests) as one JSON line and stop")
    parser.add_argument("--step15", action="store_true",
                        help="build the kernels, write and solve the sphere tree (steps 4-5), run the parity and "
                             "oracle checks (step 15) on it, print its JSON and stop")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs a GPU",
              file=sys.stderr)
        return 1
    from facebook360_dep_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    t = time.time()
    lib_path = _build.build()
    _build.load()
    log(f"kernels built and loaded in {time.time() - t:.1f} s: {os.path.relpath(lib_path, REPO)}")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas: " + line.strip())
    # the host codecs (PNG unfilter, PIZ, BC7, mesh) build at first use too:
    # built here, their g++ time stays out of the first solve's level
    from facebook360_dep_tpu_torch.stream import native

    t = time.time()
    native_path = native.build()
    native.load()
    log(f"native host codecs built and loaded in {time.time() - t:.1f} s: {os.path.relpath(native_path, REPO)}")

    if args.solve:  # one timed solve, for comparing two checkouts in one call
        from facebook360_dep_tpu_torch.core import camera as cam

        root, out_root = args.solve
        if not os.path.exists(os.path.join(root, "rigs/rig_calibrated.json")):
            write_project(root, dev)
        seconds, est, launches, _ = run_solve(root, out_root, args.profile, dev, args.mismatches_start_level)
        result = dict(solve_s=seconds, mismatches_start_level=args.mismatches_start_level, levels={str(k): v for k, v in sorted(est.level_seconds.items())},
                      launches=launches, peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        if args.reference:
            result["against_reference"] = compare_solves(
                out_root, args.reference, cam.load_rig(os.path.join(root, "rigs/rig_calibrated.json")).ids)
        log(smi)
        log(json.dumps({"solve": result}))
        return 0

    if args.step14:  # the multi-GPU path alone: no kernels or ok line
        with tempfile.TemporaryDirectory(prefix="fdt_step14_") as tmp:
            step14, phases = run_step14(tmp, dev, smi)
        log(smi)
        log(json.dumps({"step14": step14, "phase_launches": phases}))
        return 0

    if args.kernel_digests:  # two checkouts' default kernels, compared by their digests
        log(json.dumps({"kernel_digests": default_kernel_digests(dev)}))
        return 0

    if args.step16:  # the TPU sampler's semantics alone: no ok line
        t = time.time()
        step16, step16_checks, phases = run_step16(dev, smi)
        log(f"TPU sampler's semantics (step 16): {time.time() - t:.1f} s; {smi}")
        log(smi)
        log(json.dumps({"step16": step16, "kernel_table": step16_checks, "phase_launches": phases}))
        return 0

    if args.step15:  # steps 4-5 and 15 alone: no kernels or ok line
        with tempfile.TemporaryDirectory(prefix="fdt_step15_") as root:
            write_project(root, dev)
            out_root = os.path.join(root, "out")
            run_solve(root, out_root, "", dev)
            render, _ = run_rephotography(root, out_root, "", dev)
            t = time.time()
            step15, phases = run_step15(os.path.join(root, "step15"), root, out_root, render["rephoto_mssim"], dev,
                                        smi)
            log(f"parity and oracles (step 15): {time.time() - t:.1f} s; {smi}")
        log(smi)
        log(json.dumps({"step15": step15, "phase_launches": phases}))
        return 0

    t = time.time()
    checks = check_kernels(dev)
    log(f"kernel checks: {time.time() - t:.1f} s")
    if args.kernels_only:  # the main path did not run: no launch counts, no kernels or ok line
        log(smi)
        log(json.dumps({"kernel_table": checks}))
        return 0

    with tempfile.TemporaryDirectory(prefix="fdt_smoke_") as root:
        t = time.time()
        rig, gt0 = write_project(root, dev)
        log(f"scene rendered and written ({len(WIDTHS)} levels x {NUM_CAMERAS} cameras): {time.time() - t:.1f} s")
        out_root = os.path.join(root, "out")
        total, est, launches, by_shape = run_solve(root, out_root, args.profile, dev)
        missing = [k for k in ("project_sample", "ssd_combine", "cost_fused", "joint_bilateral") if launches[k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched by the main path: {missing}")
        count_level_launches(checks, by_shape, launches)
        med, coverage, rmse = check_level0(out_root, rig, gt0)

        t = time.time()
        checks["warp_sample"] = check_warp_sample(root, out_root, dev)
        log(f"K4 check: {time.time() - t:.1f} s")
        render, k4_launches = run_rephotography(root, out_root, args.profile, dev)
        for fmt in ("eqrcolor", "tbstereo"):
            render.update(run_renderer(root, out_root, fmt, dev))
        launches["warp_sample"] = k4_launches

        t = time.time()
        publish, k4_playback = run_publish(root, out_root, dev)
        log(f"publish and playback (step 10): {time.time() - t:.1f} s")

        with tempfile.TemporaryDirectory(prefix="fdt_chain_") as tmp:
            t = time.time()
            chain, chain_launches = run_foreground_chain(tmp, dev, profile_dir=args.profile)
            log(f"foreground chain: {time.time() - t:.1f} s; {smi}")

        t = time.time()
        calibration = run_calibration(root, dev)
        log(f"calibration (step 11): {time.time() - t:.1f} s; {smi}")

        t = time.time()
        shoot = run_shoot(os.path.join(root, "step12"), rig, gt0, dev)
        log(f"shoot from RAW through dep (step 12): {time.time() - t:.1f} s; {smi}")

        t = time.time()
        step13, step13_launches = run_step13(os.path.join(root, "step13"), root, dev, smi)
        log(f"fixture generators, inspection tools and viewer (step 13): {time.time() - t:.1f} s; {smi}")

        t = time.time()
        step14, step14_launches = run_step14(root, dev, smi)
        log(f"multi-GPU path (step 14): {time.time() - t:.1f} s; {smi}")

        t = time.time()
        step15, step15_launches = run_step15(os.path.join(root, "step15"), root, out_root, render["rephoto_mssim"],
                                             dev, smi)
        log(f"parity and oracles (step 15): {time.time() - t:.1f} s; {smi}")

    t = time.time()
    step16, step16_checks, step16_launches = run_step16(dev, smi)
    log(f"TPU sampler's semantics (step 16): {time.time() - t:.1f} s; {smi}")
    checks.update(step16_checks)

    log(json.dumps({"levels": {str(k): v for k, v in sorted(est.level_seconds.items())},
                    "derp_cli_s": total, "level0_median_rel_err": med,
                    "level0_coverage": coverage, "level0_covered_rel_rmse": rmse, **render, **publish, **chain,
                    **calibration, **shoot, **step13, **step14, **step15, **step16}))
    sources = {"project_sample": ("project_sample.cu", 902),
               "ssd_combine": ("ssd_combine.cu", 1301),
               "cost_fused": ("cost_fused.cu", 997),
               "warp_sample": ("warp_sample.cu", 153),
               "joint_bilateral": ("joint_bilateral.cu", None),
               "chamfer": ("chamfer.cu", None)}
    no_tpu_kernel = {"joint_bilateral": "none: the JAX package's XLA filter (facebook360_dep_tpu/ops/filters.py:39-69)",
                     "chamfer": "none: cv2 on the JAX package's host (facebook360_dep_tpu/depth/pipeline.py:125-170)"}
    kernels = []
    for name, (src, line) in sources.items():
        chain_counts = {stage: counts[name] for stage, counts in chain_launches.items() if counts[name]}
        replaces = f"{WARP_PALLAS}:{line}" if line else no_tpu_kernel[name]
        entry = dict(name=name, route="cuda", source=f"{CSRC}/{src}", replaces=replaces, launches=launches[name],
                     **checks[name], chain_launches=chain_counts)
        if name == "warp_sample":  # K4 by phase: rephotography (launches), exports, playback, step 13
            entry["phase_launches"] = dict(rephotography=launches[name], eqrcolor=render["eqrcolor_k4_launches"],
                                           tbstereo=render["tbstereo_k4_launches"], playback=k4_playback,
                                           occluder_rephotography=step13_launches["occluder_rephotography"],
                                           step15=step15_launches[name])
        else:  # K1-K3 and the joint bilateral in step 13's solves, K1 in geometric_consistency, step 14's ranks
            entry["phase_launches"] = {phase: step13_launches[phase][name]
                                       for phase in ("occluder_solve", "ftheta_solve")}
            if name == "project_sample":
                entry["phase_launches"]["geometric_consistency"] = step13_launches["geometric_consistency"]
            entry["phase_launches"].update(
                step14a_ranks=[r[name] for r in step14_launches["step14a_ranks"]],
                step14b_ranks=[r[name] for r in step14_launches["step14b_ranks"]],
                step14c=step14_launches["step14c"][name], step15=step15_launches[name])
        kernels.append(entry)
    # the TPU sampler's kernels: launches by step 16 (b), the sphere pyramid in TPU semantics
    for name, src, line in (("tile_windows", "tile_windows.cu", 486), ("project_sample_tpu", "project_sample.cu", 902),
                            ("cost_fused_tpu", "cost_fused.cu", 997)):
        kernels.append(dict(name=name, route="cuda", source=f"{CSRC}/{src}", replaces=f"{WARP_PALLAS}:{line}",
                            launches=step16_launches["sphere"][name], **checks[name],
                            phase_launches=dict(step16_ftheta=step16_launches["ftheta"][name])))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
