#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. refuses to run without CUDA; prints the card and its power limit;
2. builds the CUDA kernels of facebook360_dep_tpu_torch/csrc from source;
3. holds each kernel against its plain PyTorch twin on the card, on a
   16-camera rig of all four camera types with distortion, at main-path
   shapes (K1/K2 at 256x192, K3 at 2048x1536), and times both with CUDA
   events;
4. renders the 16-camera sphere scene (the JAX bench's config 2 rig) at the
   ten pyramid widths 2048..50 with the port, writes it as a project tree,
   and runs the port's derp_cli on it with default solver flags;
5. checks that every kernel was launched by that run and that the level-0
   disparity is within 5% median relative error of the ground truth.

Any failure raises (exit code != 0). The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

    python3 chip_smoke.py --profile DIR

also runs the derp_cli phase under torch.profiler and writes its kernel
table (device and host time by operator) to DIR/derp_profile.txt.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

WIDTHS = [2048, 1024, 512, 256, 200, 128, 100, 80, 60, 50]
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


def main_path_inputs(width: int, dev):
    """The cost context of destination 0 and a noisy candidate disparity map
    at one pyramid width, as the solver builds them."""
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
    cctx = solver._cost_ctx(ctx, 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = 1.0 + 0.05 * (2.0 * torch.rand((h, width), generator=gen, device=dev) - 1.0)
    disp = (torch.nan_to_num(gt[0], nan=1e-4) * noise).contiguous()
    return cctx, disp, gt, fov


def compare(name, kernel, plain, atol, rtol, max_outlier_frac):
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
    log(f"  {name}: max_abs_err {max_err:.3e}, outside tol {frac:.2e} (allowed {max_outlier_frac:.0e})")
    if frac > max_outlier_frac:
        raise AssertionError(f"{name}: {frac:.2e} of values outside atol {atol} rtol {rtol}")
    return max_err


def compare_validity(name, kernel, plain, max_frac):
    frac = (kernel != plain).double().mean().item()
    log(f"  {name}: validity differs at {frac:.2e} of pixels (allowed {max_frac:.0e})")
    if frac > max_frac:
        raise AssertionError(f"{name}: validity differs at {frac:.2e} of pixels")


def check_kernels(dev):
    """Each kernel against its twin at main-path shapes. Tolerances: the
    kernels and twins round every product alike (-fmad=false); what is left
    is atan2f/sqrt/exp last-ulp noise, which flips validity at a sensor or
    FOV edge for a few pixels and, through the bias compensation's
    cancellation and the drop-two-worst choice, moves a few costs."""
    import torch

    from facebook360_dep_tpu_torch.ops import cost as cost_ops
    from facebook360_dep_tpu_torch.ops import warp_cuda as wc

    results = {}
    flt_max = cost_ops.FLT_MAX

    # ---- K1 / K2 at 256x192 x 16 sources ----
    cctx, disp, gt, fov = main_path_inputs(256, dev)
    k1_args = (cctx.src_planar, cctx.src_params, cctx.cam_dst.position, disp, cctx.dst_rays)
    s_k, v_k = wc.project_sample(*k1_args)
    s_p, v_p = wc.project_sample_plain(*k1_args)
    torch.cuda.synchronize()
    log("K1 project_sample C=3 (16 x 256x192):")
    compare_validity("valid", v_k, v_p, 1e-4)
    both = (v_k & v_p)[:, None].expand_as(s_k)
    err3 = compare("sampled", s_k[both], s_p[both], 1e-5, 0.0, 1e-4)
    ms3 = cuda_time_ms(lambda: wc.project_sample(*k1_args), 20)
    pms3 = cuda_time_ms(lambda: wc.project_sample_plain(*k1_args), 5)
    log(f"  time: kernel {ms3:.4f} ms, plain {pms3:.4f} ms")

    # C=1 on a NaN-holding disparity stack, as handle_mismatches samples it
    stack = torch.where(fov, gt, float("nan"))[:, None].clone()
    stack[:, :, :8, :8] = float("nan")
    k1c1 = (stack.contiguous(),) + k1_args[1:]
    d_k, dv_k = wc.project_sample(*k1c1)
    d_p, dv_p = wc.project_sample_plain(*k1c1)
    torch.cuda.synchronize()
    log("K1 project_sample C=1 (16 x 256x192, NaN taps):")
    compare_validity("valid", dv_k, dv_p, 1e-4)
    b1 = dv_k & dv_p
    err1 = compare("sampled", d_k[:, 0][b1], d_p[:, 0][b1], 1e-7, 1e-5, 1e-4)
    ms1 = cuda_time_ms(lambda: wc.project_sample(*k1c1), 20)
    pms1 = cuda_time_ms(lambda: wc.project_sample_plain(*k1c1), 5)
    log(f"  time: kernel {ms1:.4f} ms, plain {pms1:.4f} ms")
    results["project_sample"] = dict(max_abs_err=max(err3, err1), ms=ms3, plain_ms=pms3,
                                     c1_max_abs_err=err1, c1_ms=ms1, c1_plain_ms=pms1)

    # K2 on the twin's samples
    k2_args = (s_p, v_p, cctx.dst_planar, cctx.variance, cctx.exclude_idx)
    c_k, f_k = wc.ssd_combine(*k2_args)
    c_p, f_p = wc.ssd_combine_plain(*k2_args)
    torch.cuda.synchronize()
    log("K2 ssd_combine (16 x 256x192):")
    compare_validity("cost finite", c_k < flt_max, c_p < flt_max, 1e-4)
    fin = (c_k < flt_max) & (c_p < flt_max)
    err2 = compare("cost", c_k[fin], c_p[fin], 1e-6, 1e-4, 1e-4)
    compare("confidence", f_k, f_p, 0.0, 0.0, 1e-4)
    ms2 = cuda_time_ms(lambda: wc.ssd_combine(*k2_args), 20)
    pms2 = cuda_time_ms(lambda: wc.ssd_combine_plain(*k2_args), 5)
    log(f"  time: kernel {ms2:.4f} ms, plain {pms2:.4f} ms")
    results["ssd_combine"] = dict(max_abs_err=err2, ms=ms2, plain_ms=pms2)
    del cctx, s_k, s_p, d_k, d_p

    # ---- K3 at 2048x1536 x 16 sources ----
    cctx, disp, gt, fov = main_path_inputs(2048, dev)
    k3_args = (cctx.src_planar, cctx.src_params, cctx.cam_dst.position, disp, cctx.dst_rays,
               cctx.dst_planar, cctx.variance, cctx.exclude_idx)
    c_k, f_k = wc.cost_fused(*k3_args)
    c_p, f_p = wc.cost_fused_plain(*k3_args)
    s12, v12 = wc.project_sample(*k3_args[:5])
    c_12, f_12 = wc.ssd_combine(s12, v12, *k3_args[5:])
    del s12, v12
    torch.cuda.synchronize()
    log("K3 cost_fused (16 x 2048x1536):")
    same = bool(torch.equal(c_k, c_12) and torch.equal(f_k, f_12))
    log(f"  bit-identical to K1 -> K2: {same}")
    if not same:
        compare("cost vs K1 -> K2", c_k, c_12, 0.0, 0.0, 0.0)
    compare_validity("cost finite", c_k < flt_max, c_p < flt_max, 1e-4)
    fin = (c_k < flt_max) & (c_p < flt_max)
    err = compare("cost", c_k[fin], c_p[fin], 1e-6, 1e-4, 1e-4)
    compare("confidence", f_k, f_p, 0.0, 0.0, 1e-4)
    ms = cuda_time_ms(lambda: wc.cost_fused(*k3_args), 20)
    pms = cuda_time_ms(lambda: wc.cost_fused_plain(*k3_args), 3, warmup=1)
    log(f"  time: kernel {ms:.4f} ms, plain {pms:.4f} ms")
    results["cost_fused"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bit_identical_to_k1_k2=same)
    del cctx, c_p, f_p
    torch.cuda.empty_cache()
    return results


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


def check_level0(out_root: str, rig, gt):
    """Median relative error (interior, finite pixels) against ground truth,
    as tests/test_derp_cli.py:61-65 checks it; coverage and covered RMSE."""
    import numpy as np

    from facebook360_dep_tpu_torch.core import imagetypes, io

    rels, errs, gts, finite = [], [], [], []
    for i, cam_id in enumerate(rig.ids):
        disp = io.read_disparity(imagetypes.gen_filename(out_root, "disparity_levels", 0, cam_id, "000000", "pfm"))
        if disp.shape != gt[i].shape:
            raise AssertionError(f"{cam_id}: level-0 map {disp.shape}, expected {gt[i].shape}")
        ok = np.isfinite(disp)
        finite.append(ok.mean())
        m = np.zeros(disp.shape, bool)
        m[6:-6, 6:-6] = True
        v = ok & m
        rels.append(np.abs(disp[v] - gt[i][v]) / gt[i][v])
        errs.append(disp[ok] - gt[i][ok])
        gts.append(gt[i][ok])
    med = float(np.median(np.concatenate(rels)))
    e, g = np.concatenate(errs), np.concatenate(gts)
    rmse = float(np.sqrt(np.mean(e * e)) / np.mean(g))
    log(f"level 0: median relative disparity error {med:.5f} (bar 0.05), "
        f"coverage {np.mean(finite):.4f}, covered relative RMSE {rmse:.5f}")
    if not np.isfinite(med) or med >= 0.05:
        raise AssertionError(f"level-0 median relative error {med}")
    return med, float(np.mean(finite)), rmse


@contextlib.contextmanager
def profiled(out_dir):
    """torch.profiler over the block when ``out_dir`` is set; writes the
    operator table sorted by device time and prints its head."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not out_dir:
        yield
        return
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=60)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "derp_profile.txt"), "w") as f:
        f.write(table)
    busy_us = sum(e.self_device_time_total for e in prof.key_averages())
    log(f"profile: device busy {busy_us / 1e6:.3f} s (sum of kernel self time)")
    log("\n".join(table.splitlines()[:30]))


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    parser.add_argument("--profile", default="", help="profile the derp_cli run; write the table here")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs a GPU",
              file=sys.stderr)
        return 1
    from facebook360_dep_tpu_torch.cli import derp_cli
    from facebook360_dep_tpu_torch.ops import _build
    from facebook360_dep_tpu_torch.ops import warp_cuda as wc

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

    t = time.time()
    checks = check_kernels(dev)
    log(f"kernel checks: {time.time() - t:.1f} s")

    with tempfile.TemporaryDirectory(prefix="fdt_smoke_") as root:
        t = time.time()
        rig, gt0 = write_project(root, dev)
        log(f"scene rendered and written ({len(WIDTHS)} levels x {NUM_CAMERAS} cameras): {time.time() - t:.1f} s")
        out_root = os.path.join(root, "out")
        wc.reset_launch_counts()
        t = time.time()
        with profiled(args.profile):
            est = derp_cli.main([
                "--input_root", root, "--output_root", out_root,
                "--min_depth_m", "1", "--max_depth_m", "100", "--resolution", "2048",
            ])
            torch.cuda.synchronize()
        total = time.time() - t
        launches = dict(wc.LAUNCHES)
        log(f"derp_cli: {total:.2f} s for {NUM_CAMERAS} destination maps, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for level in sorted(est.level_seconds, reverse=True):
            w, h = est.level_sizes[level]
            log(f"  level {level} ({w}x{h}): {est.level_seconds[level]:.3f} s")
        log(f"kernel launches in the derp_cli run: {launches}")
        missing = [k for k, v in launches.items() if v <= 0]
        if missing:
            raise AssertionError(f"kernels never launched by the main path: {missing}")
        med, coverage, rmse = check_level0(out_root, rig, gt0)

    log(json.dumps({"levels": {str(k): v for k, v in sorted(est.level_seconds.items())},
                    "derp_cli_s": total, "level0_median_rel_err": med,
                    "level0_coverage": coverage, "level0_covered_rel_rmse": rmse}))
    sources = {"project_sample": ("project_sample.cu", 902),
               "ssd_combine": ("ssd_combine.cu", 1301),
               "cost_fused": ("cost_fused.cu", 997)}
    kernels = []
    for name, (src, line) in sources.items():
        kernels.append(dict(name=name, route="cuda", source=f"{CSRC}/{src}",
                            replaces=f"{WARP_PALLAS}:{line}", launches=launches[name], **checks[name]))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
