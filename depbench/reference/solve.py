"""Plain reference of the depth solve that ``derp_cli`` runs with its default solver flags.

Frozen copy, batched over destination cameras, of the plain PyTorch twins
and stages of the program at commit 73fe11c54864db6ce32ac485256a11aec4484c40:
``ops/sampling.py`` (bilinear sampling, box sums, RGB variance, Lanczos4),
``ops/cost.py`` (reprojection, patch SSD, drop-two-worst combine, brute
force), ``ops/warp_cuda.py`` (the twins of K1, K2 and K3), ``ops/filters.py``
(joint bilateral, masked median), ``depth/solver.py`` (random proposals
drawn from the per-level generator, ping-pong, FOV mask) and
``depth/pipeline.py`` (FOV masks, the Lanczos4 init between levels). Every
elementwise expression is the program's, in its order, so a batch of
destinations gives the bits of the program's plain path; only the layout
(a block of destinations and all sources in one tensor) differs.

It works every level out from the colors the benchmark made (the 16-bit
values it wrote as PNG, over 65535) and the rig file, coarsest level first,
never from the program's maps. ``dtype`` sets the precision of every float
tensor: float32 is the reference, bfloat16 the control of the correctness
check. Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from depbench.reference import camera as cam

SEARCH_WINDOW_RADIUS = 1
MIN_OVERLAPPING_CAMS = 2
MIN_PATCH_SUPPORT = 5
NUM_DEPTHS = 150
RANDOM_PROP_MAX_COST = 5.0
RANDOM_PROP_HIGH_VAR_DEVIATION = 0.1
MIN_VAR = 1.0 / 12.0 / 65025.0
LEVEL_SCALE = 0.9
FLT_MAX = float(np.finfo(np.float32).max)
BILATERAL_SPACE_RADIUS_MIN = 1
BILATERAL_SPACE_RADIUS_MAX = 5
BILATERAL_SIGMA = 0.005
BILATERAL_WEIGHTS_RGB = (1.0, 1.0, 0.5)
PING_PONG_OFFSETS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (-2, -2), (2, -2), (-2, 2), (2, 2))
# a block of destinations holds at most this many (destination, source,
# pixel) elements, so that a 2K level fits beside nothing else on the card
BLOCK_ELEMENTS = 1 << 27


def pixel_center_grid(h, w, device, dtype):
    ys = torch.arange(h, device=device, dtype=dtype) + 0.5
    xs = torch.arange(w, device=device, dtype=dtype) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def box_sum_ringed(padded, radius):
    h, w = padded.shape[-2] - 2 * radius, padded.shape[-1] - 2 * radius
    lead = padded.shape[:-2]
    padded = padded.reshape((-1,) + padded.shape[-2:])
    acc = padded[:, 0:h]
    for dy in range(1, 2 * radius + 1):
        acc = acc + padded[:, dy:dy + h]
    out = acc[:, :, 0:w]
    for dx in range(1, 2 * radius + 1):
        out = out + acc[:, :, dx:dx + w]
    return out.reshape(lead + (h, w))


def box_sum_planar(x, radius):
    h, w = x.shape[-2:]
    padded = F.pad(x.reshape((-1, h, w)), (radius,) * 4, mode="reflect")
    return box_sum_ringed(padded, radius).reshape(x.shape)


def rgb_variance(img, radius=1):
    """(..., H, W, 3) -> (..., H, W): per-channel windowed variance, RGB-weighted (DerpUtil.cpp:214-237)."""
    rgb = img[..., :3].movedim(-1, -3)
    k = 2 * radius + 1
    mean = box_sum_planar(rgb, radius) / (k * k)
    mean_sq = box_sum_planar(rgb * rgb, radius) / (k * k)
    var = mean_sq - mean * mean
    return var[..., 0, :, :] * 0.3333 + var[..., 1, :, :] * 0.3334 + var[..., 2, :, :] * 0.3333


def bilinear_sample_sources(src, coords):
    """Clamp-to-edge bilinear samples of each source at its coords: src (N,
    Hs, Ws, C), coords (B, N, H, W, 2) in the pixel-center convention ->
    (B, N, H, W, C), NaN where a coordinate is not finite."""
    n, hs, ws, c = src.shape
    x = coords[..., 0] - 0.5
    y = coords[..., 1] - 0.5
    finite = torch.isfinite(x) & torch.isfinite(y)
    x = torch.where(finite, x, torch.zeros_like(x))
    y = torch.where(finite, y, torch.zeros_like(y))
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x0u, y0u = x0.to(torch.int64), y0.to(torch.int64)
    x0i, x1i = x0u.clamp(0, ws - 1), (x0u + 1).clamp(0, ws - 1)
    y0i, y1i = y0u.clamp(0, hs - 1), (y0u + 1).clamp(0, hs - 1)
    flat = src.reshape(n * hs * ws, c)
    base = (torch.arange(n, device=src.device) * (hs * ws))[None, :, None, None]

    def take(yi, xi):
        return flat[base + yi * ws + xi]

    top = take(y0i, x0i) * (1 - wx) + take(y0i, x1i) * wx
    bot = take(y1i, x0i) * (1 - wx) + take(y1i, x1i) * wx
    out = top * (1 - wy) + bot * wy
    return torch.where(finite[..., None], out, math.nan)


def ssd_ringed(dst, sampled, valid, radius=SEARCH_WINDOW_RADIUS):
    """dst (B, C, H', W'), sampled (B, N, C, H', W'), valid (B, N, H', W'),
    each with its ``radius``-pixel ring -> biased, unbiased, valid (B, N, H, W)."""
    n_patch = (2 * radius + 1) ** 2
    diff = torch.where(valid[:, :, None], dst[:, None] - sampled, 0.0)
    cnt = box_sum_ringed(valid.to(dst.dtype), radius)
    cnt_safe = torch.clamp(cnt, min=1.0)
    scale = n_patch / cnt_safe
    c = diff.shape[2]
    d2 = diff[:, :, 0] * diff[:, :, 0]
    for ch in range(1, c):
        d2 = d2 + diff[:, :, ch] * diff[:, :, ch]
    biased = box_sum_ringed(d2, radius) * scale
    mean_diff = box_sum_ringed(diff, radius) / cnt_safe[:, :, None]
    md_sq = mean_diff[:, :, 0] * mean_diff[:, :, 0]
    for ch in range(1, c):
        md_sq = md_sq + mean_diff[:, :, ch] * mean_diff[:, :, ch]
    unbiased = torch.clamp(biased - n_patch * md_sq, min=0.0)
    core = valid[:, :, radius:valid.shape[2] - radius, radius:valid.shape[3] - radius]
    return biased, unbiased, core & (cnt >= MIN_PATCH_SUPPORT)


def combine_top2(biased, unbiased, valid, variance, reverse_sum=False):
    """Drop-two-worst combine over the sources (dim 1) of (B, N, H, W)
    stacks; variance (B, H, W) -> cost, confidence (B, H, W).
    ``reverse_sum`` adds the sources' SSDs last to first: the same
    arithmetic rounded in another order, which the calibration reads to see
    how far a rounding-level change to the kernels moves the maps."""
    n = biased.shape[1]
    big = min(FLT_MAX, torch.finfo(biased.dtype).max)  # FLT_MAX in float32; the control's dtype may not hold it
    neg = -big
    b = torch.where(valid, biased, neg)
    u = torch.where(valid, unbiased, 0.0)
    i1 = torch.argmax(b, dim=1, keepdim=True)
    u1 = torch.gather(u, 1, i1)[:, 0]
    lane = torch.arange(n, device=b.device)[None, :, None, None]
    i2 = torch.argmax(torch.where(lane == i1, neg, b), dim=1, keepdim=True)
    u2 = torch.gather(u, 1, i2)[:, 0]
    count = valid.sum(dim=1)
    order = range(n - 1, -1, -1) if reverse_sum else range(n)
    total_u = u[:, order[0]]
    for i in order[1:]:
        total_u = total_u + u[:, i]
    min_keep = MIN_OVERLAPPING_CAMS - 1
    keep = torch.clamp(torch.clamp(count - 2, min=min_keep), 1, n)
    drop = count - keep
    cost_sum = total_u - torch.where(drop >= 1, u1, 0.0) - torch.where(drop >= 2, u2, 0.0)
    keepf = keep.to(biased.dtype)
    confidence = torch.clamp(variance, min=MIN_VAR)
    cost = cost_sum / (keepf * keepf) / confidence
    enough = count >= min_keep
    return torch.where(enough, cost, big), torch.where(enough, confidence, 0.0)


def _edge_pad(img, radius):
    """Clamp-to-edge pad of axes 1 and 2 of a (D, H, W, ...) stack."""
    h, w = img.shape[1:3]
    iy = torch.arange(-radius, h + radius, device=img.device).clamp(0, h - 1)
    ix = torch.arange(-radius, w + radius, device=img.device).clamp(0, w - 1)
    return img[:, iy][:, :, ix]


def _window(padded, radius, dy, dx, h, w):
    return padded[:, radius + dy:radius + dy + h, radius + dx:radius + dx + w]


def _shift(img, dy, dx):
    h, w = img.shape[1:3]
    iy = (torch.arange(h, device=img.device) + dy).clamp(0, h - 1)
    ix = (torch.arange(w, device=img.device) + dx).clamp(0, w - 1)
    return img[:, iy][:, :, ix]


def joint_bilateral(image, guide, mask, radius, sigma=BILATERAL_SIGMA, weights=BILATERAL_WEIGHTS_RGB):
    """(D, H, W) maps guided by (D, H, W, 3) colors (filters.py:39-69)."""
    h, w = image.shape[1:]
    guide_p = _edge_pad(guide, radius)
    mask_p = _edge_pad(mask.to(image.dtype), radius)
    image_p = _edge_pad(image, radius)
    sum_w = torch.zeros_like(image)
    sum_wv = torch.zeros_like(image)
    inv = 1.0 / (2.0 * sigma * sigma)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            d = guide - _window(guide_p, radius, dy, dx, h, w)
            dist = weights[0] * d[..., 0] * d[..., 0]
            for c in (1, 2):
                dist = dist + weights[c] * d[..., c] * d[..., c]
            weight = torch.exp(-(dist / 3.0) * inv) * _window(mask_p, radius, dy, dx, h, w)
            sum_w += weight
            sum_wv += weight * _window(image_p, radius, dy, dx, h, w)
    filtered = sum_wv / torch.where(sum_w == 0, 1.0, sum_w)
    out = torch.where(sum_w == 0, image, filtered)
    return torch.where(mask, out, image)


def _sorting_network_pairs(n):
    size = 1
    while size < n:
        size <<= 1
    pairs = []
    p = 1
    while p < size:
        k = p
        while k >= 1:
            for j in range(k % p, size - k, 2 * k):
                for i in range(k):
                    if (i + j) // (p * 2) == (i + j + k) // (p * 2) and i + j + k < n:
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def masked_median(image, mask, radius=1):
    """Median of the in-bounds, masked, finite, non-zero window samples of
    (D, H, W) maps (filters.py:97-149), 0 outside the mask."""
    h, w = image.shape[1:]
    image_p = _edge_pad(image, radius)
    mask_p = _edge_pad(mask, radius)
    ys = torch.arange(h, device=image.device)
    xs = torch.arange(w, device=image.device)
    big = torch.finfo(image.dtype).max
    planes, valid = [], []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            in_bounds = ((ys + dy >= 0) & (ys + dy < h))[:, None] & ((xs + dx >= 0) & (xs + dx < w))[None, :]
            v = _window(image_p, radius, dy, dx, h, w)
            m = _window(mask_p, radius, dy, dx, h, w) & in_bounds
            m = m & torch.isfinite(v) & (v != 0)
            planes.append(torch.where(m, v, big))
            valid.append(m)
    for i, j in _sorting_network_pairs(len(planes)):
        planes[i], planes[j] = torch.minimum(planes[i], planes[j]), torch.maximum(planes[i], planes[j])
    n = torch.stack(valid).sum(dim=0)
    half = n // 2
    upper = planes[0]
    lower = planes[0]
    for i in range(1, len(planes)):
        upper = torch.where(half >= i, planes[i], upper)
        lower = torch.where(half - 1 >= i, planes[i], lower)
    median = torch.where(n % 2 == 1, upper, (lower + upper) / 2.0)
    out = torch.where(n > 0, median, 0.0)
    return torch.where(mask, out, torch.zeros_like(image))


def _lanczos4_taps(src, dst):
    """cv2.resize(INTER_LANCZOS4) taps along one axis (imgproc/resize.cpp)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(f).astype(np.int64)
    fx = (f - sx.astype(np.float32)).astype(np.float64)
    s45 = 0.70710678118654752440084436210485
    cs = np.array([[1, 0], [-s45, -s45], [0, 1], [s45, -s45], [-1, 0], [s45, s45], [0, -1], [-s45, s45]])
    y0 = -(fx + 3) * np.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    coeffs = np.empty((dst, 8), np.float32)
    for i in range(8):
        y0_ = (fx + 3 - i).astype(np.float32)
        y = -y0_.astype(np.float64) * np.pi * 0.25
        with np.errstate(divide="ignore", invalid="ignore"):
            v = ((cs[i, 0] * s0 + cs[i, 1] * c0) / (y * y)).astype(np.float32)
        coeffs[:, i] = np.where(np.abs(y0_) >= 1e-6, v, np.float32(1e30))
    total = np.zeros(dst, np.float32)
    for i in range(8):
        total = total + coeffs[:, i]
    coeffs = coeffs * (np.float32(1.0) / total)[:, None]
    return np.clip(sx[:, None] + np.arange(-3, 5)[None, :], 0, src - 1), coeffs


def resize_lanczos4(img, size_wh):
    """(D, H, W) maps resized as cv2.resize(INTER_LANCZOS4): horizontal pass first, taps in order."""
    w_out, h_out = int(size_wh[0]), int(size_wh[1])
    h, w = img.shape[1:]
    xi, xw = _lanczos4_taps(w, w_out)
    yi, yw = _lanczos4_taps(h, h_out)
    dev, dt = img.device, img.dtype
    xi, xw = torch.from_numpy(xi).to(dev), torch.from_numpy(xw).to(dev, dt)
    yi, yw = torch.from_numpy(yi).to(dev), torch.from_numpy(yw).to(dev, dt).reshape(h_out, 1, 8)
    rows = img[:, :, xi[:, 0]] * xw[:, 0]
    for k in range(1, 8):
        rows = rows + img[:, :, xi[:, k]] * xw[:, k]
    out = rows[:, yi[:, 0]] * yw[:, :, 0]
    for k in range(1, 8):
        out = out + rows[:, yi[:, k]] * yw[:, :, k]
    return out


def probe_disparities(num, min_disparity, max_disparity):
    fraction = np.arange(num, dtype=np.float32) / np.float32(num - 1)
    return fraction * np.float32(min_disparity) + (np.float32(1) - fraction) * np.float32(max_disparity)


def _f32(x):
    return float(np.float32(x))


class Level:
    """One pyramid level of one frame: every camera is a source and a destination."""

    def __init__(self, cams_norm, colors, level, full_height, dtype, reverse_sum=False):
        """``cams_norm``: the rig's normalized cameras (float64, CPU);
        ``colors``: (N, H, W, 3) in [0, 1] on the device."""
        self.dtype = dtype
        self.reverse_sum = reverse_sum
        self.device = colors.device
        self.colors = colors.to(dtype)
        n, h, w = colors.shape[:3]
        self.level, self.h, self.w = level, h, w
        self.cams = cams_norm.to(self.device, dtype)
        grid = pixel_center_grid(h, w, self.device, dtype) / torch.tensor([w, h], dtype=dtype, device=self.device)
        grid = grid.expand((n,) + grid.shape)
        self.fov = ~cam.is_outside_image_circle(self.cams, grid)
        rays = cam.ray_dir(self.cams, grid)
        self.rays = torch.where(self.fov[..., None], rays, float("nan")).permute(0, 3, 1, 2).contiguous()
        self.variance = rgb_variance(self.colors)
        scale = w / float(full_height)
        self.var_noise_floor = _f32(max(4e-5 * scale * scale, MIN_VAR))
        self.var_high_thresh = _f32(1e-3)
        self.block = max(1, min(n, BLOCK_ELEMENTS // (n * h * w)))

    def cost(self, disparity):
        """Cost and confidence (D, H, W) of (D, H, W) disparity maps: the
        twins of K1 then K2 (or K3), a block of destinations at a time."""
        n = self.colors.shape[0]
        costs, confs = [], []
        src_cams = self.cams.unsqueeze()
        size = torch.tensor([self.w, self.h], dtype=self.dtype, device=self.device)
        for b0 in range(0, n, self.block):
            sl = slice(b0, min(n, b0 + self.block))
            disp = disparity[sl]
            depth = 1.0 / torch.clamp(disp, min=1e-12)
            world = (self.cams.position[sl][:, :, None, None] + self.rays[sl] * depth[:, None]).permute(0, 2, 3, 1)
            pix, valid = cam.sees(src_cams, world[:, None])
            coords = pix * size
            valid = valid & (disp > 0)[:, None] & torch.isfinite(coords).all(dim=-1)
            sampled = bilinear_sample_sources(self.colors, coords)
            sampled = torch.where(valid[..., None], sampled, 0.0).permute(0, 1, 4, 2, 3)
            del pix, coords
            bsz, nn_, c, h, w = sampled.shape
            ring_s = F.pad(sampled.reshape(bsz * nn_, c, h, w), (1,) * 4, mode="reflect").reshape(bsz, nn_, c, h + 2, w + 2)
            ring_v = F.pad(valid.to(self.dtype), (1,) * 4, mode="reflect") > 0
            dst = self.colors[sl].permute(0, 3, 1, 2)
            biased, unbiased, v = ssd_ringed(F.pad(dst, (1,) * 4, mode="reflect"), ring_s, ring_v)
            del sampled, ring_s, ring_v
            lanes = torch.arange(n, device=self.device)[None, :, None, None]
            own = torch.arange(sl.start, sl.stop, device=self.device)[:, None, None, None]
            c_, f_ = combine_top2(biased, unbiased, v & (lanes != own), self.variance[sl], self.reverse_sum)
            costs.append(c_)
            confs.append(f_)
        return torch.cat(costs), torch.cat(confs)


def brute_force(lv: Level, min_depth, max_depth):
    disparities = probe_disparities(NUM_DEPTHS, 1.0 / max_depth, 1.0 / min_depth)
    shape = lv.fov.shape
    big = min(FLT_MAX, torch.finfo(lv.dtype).max)  # FLT_MAX in float32; the control's dtype may not hold it
    best_cost = torch.full(shape, big, dtype=lv.dtype, device=lv.device)
    best_disp = torch.full(shape, float(disparities[-1]), dtype=lv.dtype, device=lv.device)
    best_conf = torch.zeros(shape, dtype=lv.dtype, device=lv.device)
    for d in disparities.tolist():
        cost, conf = lv.cost(torch.full(shape, d, dtype=lv.dtype, device=lv.device))
        better = cost < best_cost
        best_cost = torch.where(better, cost, best_cost)
        best_disp = torch.where(better, d, best_disp)
        best_conf = torch.where(better, conf, best_conf)
    disparity = torch.where(lv.fov, best_disp, float("nan"))
    return disparity, torch.where(best_cost == big, float("nan"), best_cost), best_conf


def random_proposals(lv: Level, disparity, uniforms, min_depth, max_depth):
    p = uniforms.shape[1]
    max_disp = 1.0 / min_depth
    var_high_dev = np.float32(RANDOM_PROP_HIGH_VAR_DEVIATION) * np.float32(lv.var_high_thresh)
    var_thresh = float(max(var_high_dev, np.float32(lv.var_noise_floor)))
    min_disp = torch.full_like(disparity, 1.0 / max_depth)
    active = lv.fov & (lv.variance >= var_thresh)
    cost0, conf0 = lv.cost(disparity)
    cost_thresh = torch.clamp(0.5 * cost0, max=RANDOM_PROP_MAX_COST)
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
    return disp, torch.where(active, cost, cost0), torch.where(active, conf, conf0)


def ping_pong(lv: Level, disparity, costs, confidences):
    active = lv.fov & (lv.variance >= lv.var_noise_floor)
    bg_floor = torch.zeros_like(disparity)
    disp, cost, conf = disparity, costs, confidences
    center_ok = lv.fov & (disp >= bg_floor) & torch.isfinite(disp)
    best_cost = torch.where(center_ok, cost, math.inf)
    best_disp, best_conf = disp, conf
    for dy, dx in PING_PONG_OFFSETS[1:]:
        cand = _shift(disp, dy, dx)
        ok = _shift(lv.fov, dy, dx) & (cand >= bg_floor) & torch.isfinite(cand)
        ccost, cconf = lv.cost(torch.where(ok, cand, disp))
        ccost = torch.where(ok, ccost, math.inf)
        better = ccost < best_cost
        best_cost = torch.where(better, ccost, best_cost)
        best_disp = torch.where(better, cand, best_disp)
        best_conf = torch.where(better, cconf, best_conf)
    return (torch.where(active, best_disp, disp), torch.where(active, best_cost, cost),
            torch.where(active, best_conf, conf))


def draw_uniforms(level, d, p, h, w, device):
    """The program's draws at a level: a generator on the device seeded with
    the level, one (P, H, W) draw a destination in destination order."""
    g = torch.Generator(device=device).manual_seed(level)
    return torch.stack([torch.rand((p, h, w), generator=g, device=device) for _ in range(d)])


def solve_level(lv: Level, init, num_levels, min_depth, max_depth, random_proposal_count=2):
    """process_level with derp_cli's default flags: (D, H, W) disparity, NaN outside the FOV."""
    if lv.level == num_levels - 1 or init is None:
        disparity, _, _ = brute_force(lv, min_depth, max_depth)
    else:
        d, h, w = lv.fov.shape
        uniforms = draw_uniforms(lv.level, d, random_proposal_count, h, w, lv.device)
        disparity, costs, confs = random_proposals(lv, init.to(lv.dtype), uniforms, min_depth, max_depth)
        del uniforms
        disparity, _, _ = ping_pong(lv, disparity, costs, confs)
    radius = max(math.ceil(BILATERAL_SPACE_RADIUS_MAX * LEVEL_SCALE ** lv.level), BILATERAL_SPACE_RADIUS_MIN)
    disparity = joint_bilateral(disparity, lv.colors[..., :3], lv.fov, radius)
    disparity = masked_median(disparity, lv.fov, radius=1)
    return torch.where(lv.fov, disparity, float("nan"))


def solve_pyramid(cams_norm, colors_by_level, sizes, full_height, min_depth, max_depth, device,
                  dtype=torch.float32, keep=(), reverse_sum=False):
    """Every level of one frame, coarsest first. ``colors_by_level`` maps a
    level to its (N, H, W, 3) uint16 colors (host numpy), ``sizes`` a level
    to (w, h); returns {level: (D, H, W) float32 numpy} for the levels in
    ``keep``."""
    levels = sorted(colors_by_level, reverse=True)
    num_levels = max(sizes) + 1
    out, prev = {}, None
    for level in levels:
        u16 = colors_by_level[level]
        colors = torch.from_numpy(u16.astype(np.float32) / np.float32(65535.0)).to(device)
        lv = Level(cams_norm, colors, level, full_height, dtype, reverse_sum)
        init = None
        if prev is not None:
            init = resize_lanczos4(torch.nan_to_num(prev.to(lv.dtype), nan=1e-4), sizes[level])
        prev = solve_level(lv, init, num_levels, min_depth, max_depth)
        if level in keep:
            out[level] = prev.to(torch.float32).cpu().numpy()
        del lv, colors, init
    return out
