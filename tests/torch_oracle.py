"""The scalar computeCost oracle without JAX, on the port's camera.

A copy of ``scalar_cost_oracle`` and its helpers (``_bilinear``,
``_reproject``, ``_translation_rig``, ``_smooth_images``) from
tests/test_cost_oracle.py, lines 36-172, which hold the JAX package to the
reference's per-pixel cost: computeCost (Derp.cpp:104-226) and computeSSD
(DerpUtil.cpp:126-162). The copy imports numpy, torch and the port only, so
the card's machine, which has no JAX, can hold the port's kernels to it
(chip_smoke.py step 15). tests/test_torch_cost_oracle.py holds the copy
equal to the original on the same pixels, so the two cannot drift apart.
The second half does the same for the reference mini-solver oracle of
tests/test_ref_solver_oracle.py.

Its cameras are the port's float64 cameras on the host. ``patch_mode`` is
as in the original: 'perpixel' mirrors the framework's sampling (each patch
member reprojected alone, masked normalization, MIN_PATCH_SUPPORT), so the
port's costs match it to float tolerance; 'center' is the literal
reference (the patch sampled around the warped center), whose gap from the
port is the documented sampling deviation (PARITY.md).
"""

import os
import shutil
import subprocess

import numpy as np
import torch

from facebook360_dep_tpu_torch.core import camera as cam
from facebook360_dep_tpu_torch.ops import cost as cost_ops
from facebook360_dep_tpu_torch.ops import sampling, warp_cuda

FLT_MAX = np.float32(np.finfo(np.float32).max)


def _bilinear(img, x, y):
    """Clamp-to-edge bilinear at pixel-center coords (cv_util
    getPixelBilinear semantics; sampling.bilinear_sample docstring)."""
    h, w = img.shape[:2]
    x = min(max(x - 0.5, 0.0), w - 1.0)
    y = min(max(y - 0.5, 0.0), h - 1.0)
    x0, y0 = int(np.floor(x)), int(np.floor(y))
    x1, y1 = min(x0 + 1, w - 1), min(y0 + 1, h - 1)
    ax, ay = x - x0, y - y0
    top = img[y0, x0] * (1 - ax) + img[y0, x1] * ax
    bot = img[y1, x0] * (1 - ax) + img[y1, x1] * ax
    return top * (1 - ay) + bot * ay


def _reproject(rig, src_idx, world):
    """world point -> (x, y, valid) in src pixel-center units."""
    cam_src = rig.camera(src_idx)
    pix, valid = cam.sees(cam_src, torch.as_tensor(np.asarray(world), dtype=cam_src.position.dtype))
    return float(pix[0]), float(pix[1]), bool(valid)


def scalar_cost_oracle(rig, imgs, variance, dst_idx, disparity, x, y, radius=1,
                       patch_mode="center"):
    """computeCost(pyramidLevel, dstIdx, disparity, x, y) — Derp.cpp:104-226.

    ``rig`` is a port rig of float64 host cameras; ``imgs`` (N, H, W, 3)
    and ``variance`` (H, W) are numpy arrays. Returns (cost, confidence)."""
    n = imgs.shape[0]
    h, w = imgs.shape[1:3]
    cam_dst = rig.camera(dst_idx)

    def dst_world(px_i, py_i):
        # (1)-(2) dstToWorldPoint (DerpUtil.cpp:38-52): normalized pixel units
        p = np.asarray([(px_i + 0.5) / w, (py_i + 0.5) / h], np.float32)
        ray = cam.ray_dir(cam_dst, torch.as_tensor(p, dtype=cam_dst.position.dtype)).numpy()
        return cam_dst.position.numpy() + ray / disparity

    offsets = [(dx, dy) for dy in range(-radius, radius + 1)
               for dx in range(-radius, radius + 1)]
    n_patch = len(offsets)
    dst_img = imgs[dst_idx]
    dst_patch = np.stack([
        dst_img[min(max(y + dy, 0), h - 1), min(max(x + dx, 0), w - 1)]
        for dx, dy in offsets
    ]).astype(np.float64)

    ssds = []
    for s in range(n):
        if s == dst_idx:  # no SSD if src = dst (Derp.cpp:152-155)
            continue
        if patch_mode == "center":
            xs, ys, valid = _reproject(rig, s, dst_world(x, y))
            if not valid:
                continue
            xs, ys = xs * w, ys * h
            # src patch at fixed offsets around the warped center
            src_patch = np.stack([
                _bilinear(imgs[s], xs + dx, ys + dy) for dx, dy in offsets
            ]).astype(np.float64)
            bias = dst_patch.mean(axis=0) - src_patch.mean(axis=0)
            diff = dst_patch - src_patch
            diff_nobias = diff - bias
            ssds.append((float((diff * diff).sum()),
                         float((diff_nobias * diff_nobias).sum())))
        else:
            # per-member reprojection with masked normalization
            diffs, valids = [], []
            for dx, dy in offsets:
                xs, ys, valid = _reproject(rig, s, dst_world(x + dx, y + dy))
                if valid:
                    sample = _bilinear(imgs[s], xs * w, ys * h)
                    diffs.append(dst_patch[offsets.index((dx, dy))] - sample)
                else:
                    diffs.append(np.zeros(3))
                valids.append(valid)
            cnt = sum(valids)
            center_valid = valids[offsets.index((0, 0))]
            if not center_valid or cnt < cost_ops.MIN_PATCH_SUPPORT:
                continue
            diffs = np.stack(diffs)
            scale = n_patch / cnt
            biased = float((diffs * diffs).sum()) * scale
            mean_diff = diffs.sum(axis=0) / cnt
            unbiased = max(biased - n_patch * float((mean_diff * mean_diff).sum()), 0.0)
            ssds.append((biased, unbiased))

    min_keep = cost_ops.MIN_OVERLAPPING_CAMS - 1
    if len(ssds) < min_keep:
        return FLT_MAX, 0.0
    keep = max(min_keep, len(ssds) - 2)
    ssds.sort()  # nth_element on (biased, unbiased) pairs (Derp.cpp:212)
    total = sum(u for _, u in ssds[:keep]) / keep
    trust = 1.0 / keep
    conf = max(float(variance[y, x]), float(cost_ops.MIN_VAR))
    return total * trust / conf, conf


def _translation_rig(n=4, size=(64, 48), spread=0.08):
    """Identical-intrinsics rectilinear cameras offset by pure translations:
    the dst->src warp at any constant disparity is a pixel-space translation."""
    w, h = size
    rng = np.random.RandomState(3)
    cams, ids = [], []
    for i in range(n):
        pos = rng.uniform(-spread, spread, 3)
        pos[2] = 0.0  # keep image-plane-parallel so the warp stays uniform
        cams.append(cam.make_camera(
            type_code=cam.RECTILINEAR, position=list(pos), rotation=np.eye(3),
            resolution=[w, h], focal=[0.45 * w, -0.45 * w],
        ))
        ids.append(f"cam{i}")
    return cam.Rig(cameras=cam.stack_cameras(cams), ids=tuple(ids), groups=("",) * n)


def _smooth_images(n, h, w, seed=5):
    rng = np.random.RandomState(seed)
    imgs = rng.rand(n, h + 16, w + 16, 3).astype(np.float32)
    out = np.empty((n, h, w, 3), np.float32)
    for i in range(n):
        for c in range(3):
            a = imgs[i, :, :, c]
            s = np.cumsum(np.cumsum(a, 0), 1)
            # 5x5 box via integral image
            b = (s[5:5 + h + 11, 5:5 + w + 11] - s[:h + 11, 5:5 + w + 11]
                 - s[5:5 + h + 11, :w + 11] + s[:h + 11, :w + 11]) / 25.0
            out[i, :, :, c] = b[4:4 + h, 4:4 + w]
    return out


def one_dst_cost_context(nrig, imgs: np.ndarray, dst_idx: int, device) -> tuple:
    """The port's cost context of destination ``dst_idx`` against every
    camera of the normalized rig, on ``device``, built as the original test
    builds the JAX one (no FOV masking of the rays). Returns (ctx, the
    destination's variance as a host array)."""
    imgs_t = torch.as_tensor(imgs, dtype=torch.float32, device=device)
    cams = nrig.cameras.to(device, torch.float32)
    cam_dst = cams.index([dst_idx])
    h, w = imgs.shape[1:3]
    src_rgba = warp_cuda.rgba_stack(imgs_t)
    variance = sampling.rgb_variance(imgs_t)[[dst_idx]]
    ctx = cost_ops.CostContext(
        cam_dst=cam_dst,
        src_params=warp_cuda.pack_camera_params(cams),
        dst_planar=warp_cuda.planar_view(src_rgba)[[dst_idx]].contiguous(),
        variance=variance,
        exclude_idx=(dst_idx,),
        dst_rays=cost_ops.dst_ray_dirs(cam_dst, h, w).permute(0, 3, 1, 2).contiguous(),
        src_rgba=src_rgba,
    )
    return ctx, variance[0].cpu().numpy()


def _require(ok: bool, *what) -> None:
    if not ok:
        raise AssertionError(what)


def check_translation_rig(cost_map_of, size=(64, 48), disparities=(0.05, 0.2, 0.5), per_disparity=12):
    """The original's tight test on the translation rig at ``size``: at 12
    random pixels for each disparity the port's cost is within
    5e-4 * (1 + |want|) of the 'perpixel' oracle, with the same FLT_MAX
    pixels, and at least 20 pixels are checked. ``cost_map_of(rig, imgs,
    disparity)`` returns destination 0's (H, W) host costs and variance.
    Returns the pixels checked and the largest relative gap."""
    rig = cam.normalize_rig(_translation_rig(4, size))
    imgs = _smooth_images(4, size[1], size[0])
    rng = np.random.RandomState(11)
    checked, worst = 0, 0.0
    for disparity in disparities:
        c_map, variance = cost_map_of(rig, imgs, disparity)
        for _ in range(per_disparity):
            x = int(rng.randint(6, size[0] - 6))
            y = int(rng.randint(6, size[1] - 6))
            got = c_map[y, x]
            want, _ = scalar_cost_oracle(rig, imgs, variance, 0, disparity, x, y, patch_mode="perpixel")
            if want >= 1e30 or got >= 1e30:
                _require((want >= 1e30) == (got >= 1e30), x, y, want, got)
                continue
            # residual is f32-vs-f64 arithmetic only; semantic errors (wrong
            # keep/trust/bias/normalization) shift costs by whole percents
            _require(abs(got - want) <= 5e-4 * (1.0 + abs(want)), x, y, got, want)
            worst = max(worst, abs(got - want) / (1.0 + abs(want)))
            checked += 1
    _require(checked >= 20, "pixels checked", checked)
    return checked, worst


def check_general_rig(rig, colors: np.ndarray, disparity: float, c_map: np.ndarray, variance: np.ndarray,
                      samples: int = 40, margin: int = 8, seed: int = 7):
    """The original's bounded-deviation test: on a rig with real parallax,
    at ``samples`` random pixels ``margin`` px and more from the border, the
    relative gap from the 'center' oracle has a median below 0.02 and is
    under 0.2 at more than 90% of them (at least 25 finite). Returns
    (pixels, median, share under 0.2)."""
    h, w = colors.shape[1:3]
    rng = np.random.RandomState(seed)
    rels = []
    for _ in range(samples):
        x = int(rng.randint(margin, w - margin))
        y = int(rng.randint(margin, h - margin))
        want, _ = scalar_cost_oracle(rig, colors, variance, 0, disparity, x, y, patch_mode="center")
        got = c_map[y, x]
        if want >= 1e30 or got >= 1e30:
            continue
        rels.append(abs(got - want) / (1.0 + abs(want)))
    rels = np.asarray(rels)
    _require(len(rels) >= 25, "finite pixels", len(rels))
    # median deviation well under the quality budget; recorded in PARITY.md
    _require(np.median(rels) < 0.02, "median", float(np.median(rels)))
    _require(np.mean(rels < 0.2) > 0.9, "share under 0.2", float(np.mean(rels < 0.2)))
    return len(rels), float(np.median(rels)), float(np.mean(rels < 0.2))


# ---------------------------------------------------------------------------
# The reference mini-solver oracle (tests/test_ref_solver_oracle.py) on the
# port: tools/ref_cpu_baseline.cpp --mini_solver (brute-force init, one
# Jacobi ping-pong pass, masked median; Derp.cpp:264-541) and the port's
# solver on the same uint16 pixels.
# ---------------------------------------------------------------------------

REF_W, REF_H = 256, 192
REF_CAMS = 16
REF_MIN_DEPTH, REF_MAX_DEPTH = 1.0, 100.0
REF_TOOL_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tools", "ref_cpu_baseline.cpp")
# the original's per-scene bounds on (agreement rel RMSE, median rel diff),
# ~1.5x its round-4 measurement (tests/test_ref_solver_oracle.py _BOUNDS)
REF_BOUNDS = {"sphere": (0.05, 0.002), "occluder": (0.11, 0.045), "outward": (0.18, 0.10)}


def ref_tool_missing() -> str | None:
    """Why the reference tool cannot be built here, or None."""
    if shutil.which("g++") is None or shutil.which("pkg-config") is None:
        return "no g++ / pkg-config"
    if subprocess.run(["pkg-config", "--exists", "opencv4"]).returncode != 0:
        return "no opencv4"
    return None


def build_ref_tool(out: str) -> str:
    """Build tools/ref_cpu_baseline.cpp with g++ and opencv4 into ``out``
    (raises if the build fails)."""
    flags = subprocess.run(["pkg-config", "--cflags", "--libs", "opencv4"], capture_output=True, text=True,
                           check=True)
    subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", REF_TOOL_SRC, "-o", out]
                   + flags.stdout.split() + ["-lpthread"], check=True)
    return out


def ref_scene(name: str, device=None):
    """The original's scenes on the port's renderers: (rig, uint16 colors
    (N, H, W, 3), camera 0's ground-truth disparity). 'sphere' and
    'outward' are the textured sphere seen from the forward and the outward
    ring, 'occluder' the raytraced room with four occluders."""
    from facebook360_dep_tpu_torch.render import raytrace, synthetic

    if name == "outward":
        rig = synthetic.make_outward_ring_rig(num_cameras=REF_CAMS, resolution=(REF_W, REF_H), ring_radius=0.3)
    else:
        rig = synthetic.make_test_rig(num_cameras=REF_CAMS, resolution=(REF_W, REF_H), ring_radius=0.3)
    if name in ("sphere", "outward"):
        colors, gt = synthetic.render_sphere_scene(rig, (REF_W, REF_H), radius=5.0, device=device)
    else:
        mesh = raytrace.box_room_with_occluders(seed=11, num_occluders=4)
        colors, gt = raytrace.render_mesh_scene(rig, (REF_W, REF_H), mesh, device=device)
    colors = np.nan_to_num(colors[..., :3].cpu().numpy(), nan=0.0)
    # quantize ONCE to uint16; both solvers consume exactly these values
    u16 = np.clip(np.round(colors * 65535.0), 0, 65535).astype(np.uint16)
    return rig, u16, gt[0].cpu().numpy()


def run_reference(tool: str, rig, u16: np.ndarray, var_floor: float, workdir: str) -> np.ndarray:
    """The tool's mini-solver disparity of camera 0 on ``u16``."""
    ind, outd = os.path.join(workdir, "in"), os.path.join(workdir, "out")
    os.makedirs(ind, exist_ok=True)
    os.makedirs(outd, exist_ok=True)
    cams = cam.camera_to_numpy(rig.cameras)
    with open(os.path.join(ind, "meta.txt"), "w") as f:
        f.write(f"{REF_CAMS} {REF_W} {REF_H} {REF_MIN_DEPTH} {REF_MAX_DEPTH} 1 {var_floor:.10g}\n")
        for i in range(REF_CAMS):
            p = np.asarray(cams.position)[i]
            fx, fy = np.asarray(cams.focal)[i]
            cx, cy = np.asarray(cams.principal)[i]
            rot = " ".join(f"{v:.17g}" for v in np.asarray(cams.rotation)[i].reshape(9))
            f.write(f"{p[0]:.17g} {p[1]:.17g} {p[2]:.17g} {fx:.17g} {fy:.17g} {cx:.17g} {cy:.17g} {rot}\n")
    for s in range(REF_CAMS):
        u16[s].tofile(os.path.join(ind, f"color{s:02d}.u16"))
    subprocess.run([tool, "--mini_solver", "--input", ind, "--output", outd, "--threads", str(os.cpu_count() or 1)],
                   check=True)
    return np.fromfile(os.path.join(outd, "disp00.f32"), np.float32).reshape(REF_H, REF_W)


def run_port_mini_solver(rig, u16: np.ndarray, device) -> tuple:
    """The port's solver on camera 0 as the tool runs it: the 150-hypothesis
    sweep, one ping-pong pass, the masked median; on ``device``. Returns
    (disparity (H, W) on the host, the level's variance noise floor)."""
    from facebook360_dep_tpu_torch.depth import pipeline, solver

    nrig = cam.normalize_rig(rig)
    dst_rig = nrig.subset([0])
    colors = torch.as_tensor(u16.astype(np.float32) / 65535.0, device=device)
    fov = pipeline.generate_fov_masks(dst_rig, (REF_H, REF_W), device=device)
    ctx = solver.make_level_context(nrig, dst_rig, colors, fov, full_height=REF_H)
    cfg = solver.SolverConfig(
        min_depth=REF_MIN_DEPTH, max_depth=REF_MAX_DEPTH,
        num_random_proposals=0, ping_pong_iterations=1,
        do_bilateral_filter=False, do_median_filter=True,
        level=0, num_levels=2,  # non-coarsest so ping-pong runs
    )
    disparity, costs, confidences = solver.brute_force_all(ctx, cfg)
    disparity, costs, confidences = solver.ping_pong(ctx, cfg, disparity, costs, confidences)
    disparity = solver.median_filter(ctx, cfg, disparity)
    return disparity[0].cpu().numpy(), float(ctx.var_noise_floor)


def _rel_rmse(a, b, ok):
    return float(np.sqrt(np.mean((a[ok] - b[ok]) ** 2)) / np.mean(b[ok]))


def check_against_reference(scene: str, port_disp: np.ndarray, ref_disp: np.ndarray, gt: np.ndarray) -> dict:
    """The original's two-part contract on camera 0, 2 px in from the
    border: agreement with the reference algorithm under REF_BOUNDS, and
    dominance (the port's ground-truth rel RMSE at most 1.10x the
    reference's). Raises on a miss; returns the readings."""
    r = 2  # exclude the brute-force margin band + its clamp extension
    a = port_disp[r:REF_H - r, r:REF_W - r]
    b = ref_disp[r:REF_H - r, r:REF_W - r]
    g = gt[r:REF_H - r, r:REF_W - r]
    ok = np.isfinite(a) & np.isfinite(b) & (b > 0) & np.isfinite(g)
    readings = dict(scene=scene, valid=float(ok.mean()))
    _require(ok.mean() > (0.5 if scene == "outward" else 0.95), scene, "valid share", float(ok.mean()))
    readings.update(agree_rel_rmse=_rel_rmse(a, b, ok), agree_median=float(np.median(np.abs(a[ok] - b[ok]) / b[ok])),
                    port_gt_rel_rmse=_rel_rmse(a, g, ok), ref_gt_rel_rmse=_rel_rmse(b, g, ok))
    rmse_bound, median_bound = REF_BOUNDS[scene]
    _require(readings["agree_rel_rmse"] < rmse_bound, scene, "diverged from the reference algorithm", readings)
    _require(readings["agree_median"] < median_bound, scene, "bulk-pixel divergence", readings)
    _require(readings["port_gt_rel_rmse"] <= readings["ref_gt_rel_rmse"] * 1.10, scene,
             "the port's solver is worse than the reference algorithm on identical inputs", readings)
    return readings
