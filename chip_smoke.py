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
   bit), and times each there two ways with CUDA events: ``ms``, one
   launch from the host as the solve makes it, and ``graph_ms``, the
   device time of one launch inside a CUDA graph, which leaves the host's
   launch cost out; beside them the roofline bound from the bytes and
   FLOPs of its shapes and the share bound / graph_ms; the twins are timed
   at 256x192 and 2048x1536;
4. renders the 16-camera sphere scene (the JAX bench's config 2 rig) at the
   ten pyramid widths 2048..50 with the port, writes it as a project tree,
   and runs the port's derp_cli on it with default solver flags;
5. checks that every kernel was launched by that run and that the level-0
   disparity is within 5% median relative error of the ground truth; the
   launches it counted at each level shape complete the per-level table
   (launches a solve, launches x (graph_ms - bound)), and each level must
   show the batched solve's count (K1 11 at each of 256..60 and 150 at 50,
   K2 16 times that, K3 176 at each of its levels);
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
   by both solves and K4 by the export, the masks' IoU against the disk's
   true coverage, and the level-0, in-disk, filtered and upsampled median
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
   the stage times and the peak device memory.

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


def level_inputs(width: int, dev):
    """One level of the solve at a pyramid width, as the solver builds it
    (all 16 cameras as destinations), noisy candidate maps for its 16
    destinations, the ground truth and the FOV masks."""
    import torch

    from facebook360_dep_tpu_torch.core import camera as cam
    from facebook360_dep_tpu_torch.depth import pipeline, solver
    from facebook360_dep_tpu_torch.render import synthetic

    h = height(width)
    rig = mixed_rig((2048, 1536))
    colors, gt = synthetic.render_sphere_scene(rig, (width, h), radius=5.0, device=dev)
    nrig = cam.normalize_rig(rig)
    fov = pipeline.generate_fov_masks(nrig, (h, width), dev)
    ctx = solver.make_level_context(nrig, nrig, colors, fov, full_height=1536)
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


# The card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W):
# the roofline of the kernel table.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
PARAM_BYTES = 24 * 4  # one packed source camera


def k1_flops(c: int) -> int:
    """FLOPs per (destination pixel, source) of K1: the projection (world
    point, rotation, norms, distortion, focal, FOV cone and sensor tests)
    ~70, then a bilinear lerp of 6 per channel."""
    return 70 + 6 * c


def k2_flops(c: int) -> int:
    """FLOPs per (destination pixel, non-self source) of K2: differences,
    squares and their channel sum 3C - 1, separable 3x3 boxes of C + 2
    planes 4 each, the bias compensation 12 + 2C, the top-two fold 4."""
    return (3 * c - 1) + 4 * (c + 2) + (12 + 2 * c) + 4


def roofline(nbytes: float, flops: float):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the FLOPs over the float32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_work(n, c, hs, ws, h, w, d):
    """(bytes, FLOPs) of sampling d destination maps (one launch): the
    sources' C channels (not the pad the kernel's layout adds), cameras,
    positions, disparities and rays read once, the samples and validity
    written once."""
    hw = h * w
    return (4 * n * c * hs * ws + n * PARAM_BYTES + d * (12 + 16 * hw) + d * n * (4 * c + 1) * hw,
            d * n * hw * k1_flops(c))


def k2_work(n, c, h, w):
    """The non-self sources' samples and validity (the kernel skips the
    self source), dst and variance read once, cost and confidence written
    once."""
    hw = h * w
    return 4 * (n - 1) * c * hw + (n - 1) * hw + 4 * c * hw + 4 * hw + 8 * hw, (n - 1) * hw * k2_flops(c)


def k3_work(n, hs, ws, h, w):
    """The non-self sources' three planes, cameras, disparity, rays, dst and
    variance read once, cost and confidence written once."""
    hw = h * w
    return (4 * (n - 1) * 3 * hs * ws + n * PARAM_BYTES + 12 + 4 * 8 * hw + 8 * hw,
            (n - 1) * hw * (k1_flops(3) + k2_flops(3)))


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


def level_row(name, h, w, fn, work, reps, inner):
    """One row of the per-level table; ``fn()`` launches the kernel once."""
    ms = cuda_time_ms(fn, reps)
    graph_ms = graph_time_ms(fn, inner)
    bound_ms, bound_by = roofline(*work)
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
    cost evaluation of all 16 maps, K2 and K3 one a map and evaluation) and
    no launch fell outside the table."""
    for name in ("project_sample", "ssd_combine", "cost_fused"):
        rows = checks[name]["levels"]
        for row in rows:
            row["launches_per_solve"] = n = by_shape.get((name, row["h"], row["w"]), 0)
            row["lost_ms_per_solve"] = n * (row["graph_ms"] - row["bound_ms"])
            log(f"  {name} {row['shape']}: {n} launches a solve, launches x (graph_ms - bound) "
                f"{row['lost_ms_per_solve']:.2f} ms")
            evals = NUM_DEPTHS if row["w"] == WIDTHS[-1] else EVALS_FINE
            want = evals if name == "project_sample" else NUM_CAMERAS * evals
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
    as one launch for one map.
    Below K3 the solver's batched cost must equal the 16 single-destination
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
    results = {k: dict(max_abs_err=0.0, levels=[]) for k in ("project_sample", "ssd_combine", "cost_fused")}

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
    warnings)."""

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


def write_project(root: str, dev, widths=WIDTHS):
    """The 16-camera sphere scene rendered at every pyramid width, as a
    project tree (color_levels/level_N/<cam>/000000.png + rig). Returns the
    level-0 ground-truth disparity (N, H, W) numpy."""
    from facebook360_dep_tpu_torch.core import camera as cam
    from facebook360_dep_tpu_torch.core import imagetypes, io
    from facebook360_dep_tpu_torch.render import synthetic

    rig = synthetic.make_test_rig(NUM_CAMERAS, (widths[0], height(widths[0])), ring_radius=0.3)
    gt0 = None
    for level, w in enumerate(widths):
        colors, gt = synthetic.render_sphere_scene(rig, (w, height(w)), radius=5.0, device=dev)
        colors = colors.cpu().numpy()
        if level == 0:
            gt0 = gt.cpu().numpy()
        for i, cam_id in enumerate(rig.ids):
            d = imagetypes.image_dir(root, "color_levels", level, cam_id)
            os.makedirs(d, exist_ok=True)
            io.write_color(os.path.join(d, "000000.png"), colors[i], bit_depth=16)
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

    from facebook360_dep_tpu_torch.core import imagetypes, io

    disp = np.stack([io.read_disparity(imagetypes.gen_filename(out_root, "disparity_levels", 0, cam_id,
                                                                "000000", "pfm")) for cam_id in rig.ids])
    if disp.shape != gt.shape:
        raise AssertionError(f"level-0 maps {disp.shape}, expected {gt.shape}")
    med, coverage = relative_error(disp, gt)
    ok = np.isfinite(disp)
    rmse = float(np.sqrt(np.mean((disp[ok] - gt[ok]) ** 2)) / np.mean(gt[ok]))
    log(f"level 0: median relative disparity error {med:.5f} (bar 0.05), "
        f"coverage {coverage:.4f}, covered relative RMSE {rmse:.5f}")
    if not np.isfinite(med) or med >= 0.05:
        raise AssertionError(f"level-0 median relative error {med}")
    return med, coverage, rmse


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
                              ("derp foreground", ("project_sample", "ssd_combine", "cost_fused")),
                              ("export eqrcolor", ("warp_sample",))):
            missing = [k for k in kernels if launches[name][k] <= 0]
            if missing:
                raise AssertionError(f"foreground chain: {name} never launched {missing}")

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
        missing = [k for k in ("project_sample", "ssd_combine", "cost_fused") if launches[k] <= 0]
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

    log(json.dumps({"levels": {str(k): v for k, v in sorted(est.level_seconds.items())},
                    "derp_cli_s": total, "level0_median_rel_err": med,
                    "level0_coverage": coverage, "level0_covered_rel_rmse": rmse, **render, **publish, **chain,
                    **calibration}))
    sources = {"project_sample": ("project_sample.cu", 902),
               "ssd_combine": ("ssd_combine.cu", 1301),
               "cost_fused": ("cost_fused.cu", 997),
               "warp_sample": ("warp_sample.cu", 153)}
    kernels = []
    for name, (src, line) in sources.items():
        chain_counts = {stage: counts[name] for stage, counts in chain_launches.items() if counts[name]}
        entry = dict(name=name, route="cuda", source=f"{CSRC}/{src}",
                     replaces=f"{WARP_PALLAS}:{line}", launches=launches[name], **checks[name],
                     chain_launches=chain_counts)
        if name == "warp_sample":  # K4 by phase: rephotography (launches), exports, playback
            entry["phase_launches"] = dict(rephotography=launches[name], eqrcolor=render["eqrcolor_k4_launches"],
                                           tbstereo=render["tbstereo_k4_launches"], playback=k4_playback)
        kernels.append(entry)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
