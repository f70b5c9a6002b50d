"""Plain reference of the foreground pass: ``derp_cli --use_foreground_masks true``.

The solve of ``solve.py`` (imported from it: the level, its cost, the
draws, the filters) with the branches the program takes when a frame has
foreground masks and a background plate (``depth/solver.py``,
``ops/cost.py``, ``depth/pipeline.py`` of the program at commit
333b90b8dff82158fe5b89a32ae48aa267530e0a):

- brute force: a probe at or behind the plate costs FLT_MAX, and outside
  the mask (inside the FOV) the map is the plate;
- random proposals: the lower bound is the plate, a pixel takes part only
  inside ``fov & fg``, and outside the mask the map is the plate;
- ping-pong: a candidate below the plate is refused, and outside the mask
  the map is the plate;
- the bilateral: only pixels inside ``fov & fg`` are filtered or read;
- the median: outside ``fov & fg`` a pixel takes the plate, not 0;
- the init between levels (``pipeline.upsample_disparity_fg``,
  UpsampleDisparityLib.cpp:97-141): the coarser map, NaN outside the
  coarser mask, nearest-upsampled as cv2 INTER_NEAREST, NaN outside this
  level's mask; holes inside the mask take the value of their nearest
  valid pixel by OpenCV's chamfer labels; what is still not finite takes
  the plate.

Every elementwise expression is the program's, in its order, so the
float32 reference gives the program's bits where the program runs its
plain twins. The chamfer (:func:`chamfer_labels`) follows OpenCV's
``distanceTransformEx_5x5`` (imgproc/distransform.cpp), which
``cv2.distanceTransformWithLabels(..., DIST_L2, ..., DIST_LABEL_PIXEL)``
runs whatever mask size it is given: a forward and a backward raster pass
of the 5x5 mask (1, 1.4, 2.1969) in 16.16 fixed point, strict compares, so
the first of equal candidates is kept. Departures from the C++, none of
which changes a label: a row of every map is relaxed at once, on the
device, in int64 (the C++ adds in 32-bit unsigned ints, which no sum here
overflows); the in-row step is a running minimum over the row in place of
the C++'s left-to-right (right-to-left) loop; a label is the flat index of
the nearest valid pixel, -1 where there is none, in place of OpenCV's
running number of the zero pixels; the backward pass relaxes every pixel,
where the C++ skips those at a distance of one step or less, for which no
candidate can be strictly nearer.

``inputs`` are the layers the harness hands over:
``{"foreground_masks_levels": {level: (N, H, W) bool},
"background_disp_levels": {level: (N, H, W) float32}}``. Nothing here
imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from depbench.reference import solve as base

MASKS = "foreground_masks_levels"
BACKGROUND = "background_disp_levels"

# distanceTransformEx_5x5's mask for DIST_L2 (metrics 1, 1.4f, 2.1969f) in
# 16.16 fixed point, CV_FLT_TO_FIX(m, 16) = cvRound(m * 2^16), and its
# initial distance INIT_DIST0 = INT_MAX >> 2
DT_HV, DT_DIAG, DT_LONG = (int(np.rint(np.float32(m) * np.float32(65536))) for m in (1.0, 1.4, 2.1969))
DT_INIT = (2**31 - 1) >> 2
# the neighbours each pass reads from finished rows, as (dy, dx, step), in
# the C++'s order of compares; the in-row neighbour (left, then right) is last
DT_FORWARD = ((-2, -1, DT_LONG), (-2, 1, DT_LONG), (-1, -2, DT_LONG), (-1, -1, DT_DIAG), (-1, 0, DT_HV),
              (-1, 1, DT_DIAG), (-1, 2, DT_LONG))
DT_BACKWARD = ((2, 1, DT_LONG), (2, -1, DT_LONG), (1, 2, DT_LONG), (1, 1, DT_DIAG), (1, 0, DT_HV),
               (1, -1, DT_DIAG), (1, -2, DT_LONG))


def _relax_row(dist, label, r, neighbours, backward):
    """One row ``r`` (padded index) of every (H+4, W+4) map: its own value
    and the neighbours of finished rows compared in order, the first
    strict minimum kept (argmin's first index); then the in-row step."""
    w = dist.shape[2] - 4
    cand = [dist[:, r, 2:w + 2]] + [dist[:, r + dy, 2 + dx:2 + dx + w] + c for dy, dx, c in neighbours]
    labs = [label[:, r, 2:w + 2]] + [label[:, r + dy, 2 + dx:2 + dx + w] for dy, dx, _ in neighbours]
    cand = torch.stack(cand)
    pick = cand.argmin(dim=0, keepdim=True)
    a = cand.gather(0, pick)[0]
    lab = torch.stack(labs).gather(0, pick)[0]
    if backward:
        a, lab = a.flip(-1), lab.flip(-1)
    # v[j] = a[j] unless v[j-1] + HV < a[j]: v[j] = j HV + min_{k<=j} (a[k] - k HV), and the label is
    # that of the last k at the minimum (a tie keeps a[j]). The key makes the minimum unique.
    j = torch.arange(w, device=a.device, dtype=torch.int64)
    key = (a - j * DT_HV) * w + (w - 1 - j)
    low = torch.cummin(key, dim=-1).values
    src = (w - 1) - torch.remainder(low, w)
    v = torch.div(low - (w - 1 - src), w, rounding_mode="floor") + j * DT_HV
    lab = lab.gather(-1, src)
    if backward:
        v, lab = v.flip(-1), lab.flip(-1)
    dist[:, r, 2:w + 2] = v
    label[:, r, 2:w + 2] = lab


def chamfer_labels(valid: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool -> (B, H, W) int64: the flat index y * W + x of each
    pixel's nearest valid pixel by OpenCV's chamfer labels, -1 in a map with
    no valid pixel."""
    b, h, w = valid.shape
    dev = valid.device
    dist = torch.full((b, h + 4, w + 4), DT_INIT, dtype=torch.int64, device=dev)
    label = torch.full((b, h + 4, w + 4), -1, dtype=torch.int64, device=dev)
    own = torch.arange(h * w, device=dev, dtype=torch.int64).reshape(h, w)
    dist[:, 2:h + 2, 2:w + 2] = torch.where(valid, 0, DT_INIT)
    label[:, 2:h + 2, 2:w + 2] = torch.where(valid, own, -1)
    for y in range(h):
        _relax_row(dist, label, y + 2, DT_FORWARD, False)
    for y in range(h - 1, -1, -1):
        _relax_row(dist, label, y + 2, DT_BACKWARD, True)
    return label[:, 2:h + 2, 2:w + 2]


def nearest_index(src: int, dst: int, device) -> torch.Tensor:
    """cv::resizeNN's source index of each output index: min(floor(d * (1 / (dst / src))), src - 1)."""
    return torch.from_numpy(np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src))).astype(np.int64),
                                       src - 1)).to(device)


def upsample_fg(prev, mask, mask_up, bg_up, size_wh):
    """The init of a level from the coarser level's (D, h, w) maps ``prev``
    and masks ``mask``, this level's masks ``mask_up`` and plate ``bg_up``."""
    w_out, h_out = int(size_wh[0]), int(size_wh[1])
    d = torch.where(mask, prev, math.nan)
    h, w = d.shape[1:]
    d_up = d[:, nearest_index(h, h_out, d.device)][:, :, nearest_index(w, w_out, d.device)]
    d_up = torch.where(mask_up, d_up, math.nan)
    valid = torch.isfinite(d_up)
    hole = ~valid & mask_up
    lab = chamfer_labels(valid)
    fill = d_up.reshape(d_up.shape[0], -1).gather(1, lab.clamp(min=0).reshape(d_up.shape[0], -1))
    d_up = torch.where(hole & (lab >= 0), fill.reshape(d_up.shape), d_up)
    return torch.where(torch.isfinite(d_up), d_up, bg_up)


def brute_force(lv: base.Level, fg, bg, min_depth, max_depth):
    """The sweep of ``solve.brute_force`` with the plate as a floor."""
    disparities = base.probe_disparities(base.NUM_DEPTHS, 1.0 / max_depth, 1.0 / min_depth)
    shape = lv.fov.shape
    big = min(base.FLT_MAX, torch.finfo(lv.dtype).max)
    best_cost = torch.full(shape, big, dtype=lv.dtype, device=lv.device)
    best_disp = torch.full(shape, float(disparities[-1]), dtype=lv.dtype, device=lv.device)
    best_conf = torch.zeros(shape, dtype=lv.dtype, device=lv.device)
    for d in disparities.tolist():
        cost, conf = lv.cost(torch.full(shape, d, dtype=lv.dtype, device=lv.device))
        cost = torch.where(bg < d, cost, big)
        better = cost < best_cost
        best_cost = torch.where(better, cost, best_cost)
        best_disp = torch.where(better, d, best_disp)
        best_conf = torch.where(better, conf, best_conf)
    disparity = torch.where(lv.fov, best_disp, float("nan"))
    disparity = torch.where(fg | ~lv.fov, disparity, bg)
    return disparity, torch.where(best_cost == big, float("nan"), best_cost), best_conf


def random_proposals(lv: base.Level, disparity, uniforms, fg, bg, min_depth):
    """``solve.random_proposals`` bounded below by the plate, inside ``fov & fg``."""
    p = uniforms.shape[1]
    max_disp = 1.0 / min_depth
    var_high_dev = np.float32(base.RANDOM_PROP_HIGH_VAR_DEVIATION) * np.float32(lv.var_high_thresh)
    var_thresh = float(max(var_high_dev, np.float32(lv.var_noise_floor)))
    min_disp = bg
    active = lv.fov & fg & (lv.variance >= var_thresh)
    cost0, conf0 = lv.cost(disparity)
    cost_thresh = torch.clamp(0.5 * cost0, max=base.RANDOM_PROP_MAX_COST)
    disp, cost, conf = disparity, cost0, conf0
    amp = (max_disp - min_disp) / 2.0
    for k in range(p):
        lo = torch.maximum(min_disp, disp - amp)
        hi = torch.clamp(disp + amp, max=max_disp)
        prop = lo + uniforms[:, k].to(lv.dtype) * (hi - lo)
        pcost, pconf = lv.cost(torch.where(active, prop, disp))
        accept = active & (pcost < cost) & (pcost < cost_thresh)
        disp = torch.where(accept, prop, disp)
        cost = torch.where(accept, pcost, cost)
        conf = torch.where(accept, pconf, conf)
        amp = torch.where(accept, amp / 2.0, amp)
    disp = torch.where(active, disp, disparity)
    disp = torch.where(fg | ~lv.fov, disp, bg)
    return disp, torch.where(active, cost, cost0), torch.where(active, conf, conf0)


def ping_pong(lv: base.Level, disparity, costs, confidences, fg, bg):
    """``solve.ping_pong`` floored at the plate, inside ``fov & fg``."""
    active = lv.fov & fg & (lv.variance >= lv.var_noise_floor)
    disp, cost, conf = disparity, costs, confidences
    center_ok = lv.fov & (disp >= bg) & torch.isfinite(disp)
    best_cost = torch.where(center_ok, cost, math.inf)
    best_disp, best_conf = disp, conf
    for dy, dx in base.PING_PONG_OFFSETS[1:]:
        cand = base._shift(disp, dy, dx)
        ok = base._shift(lv.fov, dy, dx) & (cand >= bg) & torch.isfinite(cand)
        ccost, cconf = lv.cost(torch.where(ok, cand, disp))
        ccost = torch.where(ok, ccost, math.inf)
        better = ccost < best_cost
        best_cost = torch.where(better, ccost, best_cost)
        best_disp = torch.where(better, cand, best_disp)
        best_conf = torch.where(better, cconf, best_conf)
    disp = torch.where(active, best_disp, disp)
    disp = torch.where(fg | ~lv.fov, disp, bg)
    return disp, torch.where(active, best_cost, cost), torch.where(active, best_conf, conf)


def bilateral(lv: base.Level, disparity, fg):
    """``solve.joint_bilateral`` at the level's radius, reading and filtering only inside ``fov & fg``."""
    radius = max(math.ceil(base.BILATERAL_SPACE_RADIUS_MAX * base.LEVEL_SCALE ** lv.level),
                 base.BILATERAL_SPACE_RADIUS_MIN)
    return base.joint_bilateral(disparity, lv.colors[..., :3], lv.fov & fg, radius)


def median(lv: base.Level, disparity, fg, bg):
    """``solve.masked_median`` (radius 1) inside ``fov & fg``, the plate outside it."""
    inside = lv.fov & fg
    return torch.where(inside, base.masked_median(disparity, inside, radius=1), bg)


def solve_level(lv: base.Level, init, fg, bg, num_levels, min_depth, max_depth, random_proposal_count=2):
    """process_level with derp_cli's default flags and foreground masks: (D, H, W), NaN outside the FOV."""
    if lv.level == num_levels - 1 or init is None:
        disparity, _, _ = brute_force(lv, fg, bg, min_depth, max_depth)
    else:
        d, h, w = lv.fov.shape
        uniforms = base.draw_uniforms(lv.level, d, random_proposal_count, h, w, lv.device)
        disparity, costs, confs = random_proposals(lv, init.to(lv.dtype), uniforms, fg, bg, min_depth)
        del uniforms
        disparity, _, _ = ping_pong(lv, disparity, costs, confs, fg, bg)
    disparity = median(lv, bilateral(lv, disparity, fg), fg, bg)
    return torch.where(lv.fov, disparity, float("nan"))


def solve_pyramid(cams_norm, colors_by_level, sizes, full_height, min_depth, max_depth, device,
                  dtype=torch.float32, keep=(), reverse_sum=False, inputs=None):
    """Every level of one frame, coarsest first, as ``solve.solve_pyramid``,
    with the frame's masks and the plate's disparity from ``inputs``;
    returns {level: (D, H, W) float32 numpy} for the levels in ``keep``."""
    if inputs is None or MASKS not in inputs or BACKGROUND not in inputs:
        raise ValueError(f"the foreground pass needs inputs {MASKS!r} and {BACKGROUND!r}")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        levels = sorted(colors_by_level, reverse=True)
        num_levels = max(sizes) + 1
        out, prev, prev_fg = {}, None, None
        for level in levels:
            u16 = colors_by_level[level]
            colors = torch.from_numpy(u16.astype(np.float32) / np.float32(65535.0)).to(device)
            lv = base.Level(cams_norm, colors, level, full_height, dtype, reverse_sum)
            fg = torch.from_numpy(np.asarray(inputs[MASKS][level], bool)).to(device)
            bg = torch.from_numpy(np.asarray(inputs[BACKGROUND][level], np.float32)).to(device, dtype)
            init = None
            if prev is not None:
                init = upsample_fg(prev, prev_fg, fg, bg, sizes[level])
            prev, prev_fg = solve_level(lv, init, fg, bg, num_levels, min_depth, max_depth), fg
            if level in keep:
                out[level] = prev.to(torch.float32).cpu().numpy()
            del lv, colors, init
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
