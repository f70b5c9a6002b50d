"""Software ISP: RAW Bayer -> RGB on the device.

Reference: ``isp/CameraIsp.h:42-1299``, through the JAX package's
``isp/pipeline.py``, which this module follows stage for stage. Stage order
mirrors ``executePipeline`` (CameraIsp.h:1227-1237): black level ->
anti-vignette -> white balance -> clamp/stretch -> stuck-pixel removal ->
demosaic -> color correct (CCM + saturation + gamma/key-boost/contrast tone
curve, :360-415) -> sharpen. Every stage runs in float32 on the mosaic's
device.

Demosaic filters (CameraIsp.h:32-38): BILINEAR, EDGE_AWARE, FREQUENCY and
CHROMA_SUPPRESSED. The 3x3 [1,2,1]x[1,2,1] correlation of the bilinear and
chroma paths is separable shifts and adds, so no library convolution (and
no TF32 rounding on the card) touches it. FREQUENCY runs its orthonormal
DCT-II and its inverse on the device through ``torch.fft`` (Makhoul's
reordering), where the JAX package pins that mode to the host.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import sampling

BAYER_OFFSETS = {
    # (y, x) offsets of R, G1, G2, B within each 2x2 tile
    "RGGB": {"r": (0, 0), "g": ((0, 1), (1, 0)), "b": (1, 1)},
    "GRBG": {"r": (0, 1), "g": ((0, 0), (1, 1)), "b": (1, 0)},
    "GBRG": {"r": (1, 0), "g": ((0, 0), (1, 1)), "b": (0, 1)},
    "BGGR": {"r": (1, 1), "g": ((0, 1), (1, 0)), "b": (0, 0)},
}

DEMOSAIC_FILTERS = ("BILINEAR", "EDGE_AWARE", "FREQUENCY", "CHROMA_SUPPRESSED")


@dataclass
class IspConfig:
    """isp.json "CameraIsp" schema (CameraIsp.h:520-566)."""

    bits_per_pixel: int = 8
    width: int = 0  # sensor dims; 0 = take from the image
    height: int = 0
    bayer_pattern: str = "GBRG"
    companding_lut: list = field(default_factory=lambda: [(0.0, 0.0), (1.0, 1.0)])
    black_level: tuple = (0.0, 0.0, 0.0)
    clamp_min: tuple = (0.0, 0.0, 0.0)
    clamp_max: tuple = (1.0, 1.0, 1.0)
    stuck_pixel_threshold: float = 0.0
    stuck_pixel_darkness_threshold: float = 0.0
    stuck_pixel_radius: int = 0
    vignette_roll_off_h: list = field(default_factory=lambda: [(1.0, 1.0, 1.0)])
    vignette_roll_off_v: list = field(default_factory=lambda: [(1.0, 1.0, 1.0)])
    white_balance_gain: tuple = (1.0, 1.0, 1.0)
    ccm: tuple = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
    saturation: float = 1.0
    gamma: tuple = (1.0, 1.0, 1.0)
    contrast: float = 1.0
    low_key_boost: tuple = (0.0, 0.0, 0.0)
    high_key_boost: tuple = (0.0, 0.0, 0.0)
    sharpening: tuple = (0.0, 0.0, 0.0)
    sharpening_support: float = 10.0 / 2048.0
    noise_core: float = 1000.0
    demosaic_filter: str = "BILINEAR"
    apply_tone_curve: bool = True

    @classmethod
    def from_json(cls, path) -> "IspConfig":
        with open(path) as f:
            obj = json.load(f).get("CameraIsp", {})
        cfg = cls()
        cfg.bits_per_pixel = obj.get("bitsPerPixel", cfg.bits_per_pixel)
        cfg.width = obj.get("width", cfg.width)
        cfg.height = obj.get("height", cfg.height)
        cfg.bayer_pattern = obj.get("bayerPattern", cfg.bayer_pattern).upper()[:4]
        for name, attr in [
            ("blackLevel", "black_level"),
            ("clampMin", "clamp_min"),
            ("clampMax", "clamp_max"),
            ("whiteBalanceGain", "white_balance_gain"),
            ("gamma", "gamma"),
            ("lowKeyBoost", "low_key_boost"),
            ("highKeyBoost", "high_key_boost"),
            ("sharpening", "sharpening"),
        ]:
            if name in obj:
                v = obj[name]
                setattr(cfg, attr, tuple(v.values()) if isinstance(v, dict) else tuple(v))
        if "ccm" in obj:
            cfg.ccm = tuple(tuple(row) for row in obj["ccm"])
        for name, attr in [
            ("vignetteRollOffH", "vignette_roll_off_h"),
            ("vignetteRollOffV", "vignette_roll_off_v"),
            ("compandingLut", "companding_lut"),
        ]:
            if name in obj:
                setattr(
                    cfg, attr,
                    [tuple(p.values()) if isinstance(p, dict) else tuple(p) for p in obj[name]],
                )
        cfg.saturation = obj.get("saturation", cfg.saturation)
        cfg.contrast = obj.get("contrast", cfg.contrast)
        cfg.sharpening_support = obj.get("sharpeningSupport", cfg.sharpening_support)
        cfg.noise_core = obj.get("noiseCore", cfg.noise_core)
        cfg.stuck_pixel_threshold = obj.get("stuckPixelThreshold", cfg.stuck_pixel_threshold)
        cfg.stuck_pixel_darkness_threshold = obj.get(
            "stuckPixelDarknessThreshold", cfg.stuck_pixel_darkness_threshold
        )
        cfg.stuck_pixel_radius = obj.get("stuckPixelRadius", cfg.stuck_pixel_radius)
        return cfg


def bayer_masks(pattern: str, height: int, width: int, device=None):
    """(H, W) boolean masks for the R/G/B sites of a Bayer pattern."""
    off = BAYER_OFFSETS[pattern]
    ys = torch.arange(height, device=device)[:, None] % 2
    xs = torch.arange(width, device=device)[None, :] % 2

    def site(yx):
        return (ys == yx[0]) & (xs == yx[1])

    r = site(off["r"])
    g = site(off["g"][0]) | site(off["g"][1])
    b = site(off["b"])
    return r, g, b


def per_site(pattern: str, height: int, width: int, rgb_triple, device=None) -> torch.Tensor:
    """(H, W) float32 map holding the per-channel value at each Bayer site."""
    r, g, b = bayer_masks(pattern, height, width, device)
    v = torch.tensor(rgb_triple, dtype=torch.float32, device=device)
    return r * v[0] + g * v[1] + b * v[2]


def companding(raw: torch.Tensor, lut_points) -> torch.Tensor:
    """Piecewise-linear companding curve (compandingLut, CameraIsp.h:53):
    ``jnp.interp`` with its index rule (the segment right of a breakpoint
    that is hit exactly) and its constant ends."""
    pts = np.asarray(lut_points, np.float32)
    if len(pts) < 2 or (len(pts) == 2 and np.allclose(pts, [[0, 0], [1, 1]])):
        return raw
    xp = torch.from_numpy(np.ascontiguousarray(pts[:, 0])).to(raw.device)
    fp = torch.from_numpy(np.ascontiguousarray(pts[:, 1])).to(raw.device)
    i = torch.searchsorted(xp, raw.contiguous(), right=True).clamp(1, len(pts) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = raw - xp[i - 1]
    dx0 = dx.abs() <= np.spacing(np.finfo(np.float32).eps)
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(raw < xp[0], fp[0], f)
    return torch.where(raw > xp[-1], fp[-1], f)


def _divide(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` rounded alike on every device. With a Python number
    for a divisor the card multiplies by its float32 reciprocal where the CPU
    divides, and the ulp between the two can flip the edge-aware demosaic's
    homogeneity vote: 4 votes flipped on a 2048x1536 sphere frame and 83 on
    uniform noise, moving pixels by up to 2.1e-5 and 2.8e-2
    (``tools/isp_card_cpu_diff.py``, NVIDIA H100 80GB HBM3, 700.00 W). A
    tensor divisor divides on both."""
    return x / torch.tensor(divisor, dtype=x.dtype, device=x.device)


def _box_mean(img: torch.Tensor, radius: int) -> torch.Tensor:
    """``sampling.box_mean`` with its division by the window's area made by
    :func:`_divide`."""
    return _divide(sampling.box_sum(img, radius), float((2 * radius + 1) ** 2))


def _conv121(img: torch.Tensor) -> torch.Tensor:
    """The 3x3 [1,2,1]x[1,2,1] correlation with zero "SAME" padding, as
    separable shifts and adds: every product is by a power of two, so the
    result is float32 arithmetic throughout (no TF32 on the card)."""
    h, w = img.shape
    p = F.pad(img[None, None], (1, 1, 1, 1))[0, 0]
    v = p[0:h] + 2.0 * p[1:h + 1] + p[2:h + 2]
    return v[:, 0:w] + 2.0 * v[:, 1:w + 1] + v[:, 2:w + 2]


def _spread(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Normalized [1,2,1]x[1,2,1] average of ``values`` over the sites of ``mask``."""
    mf = mask.to(values.dtype)
    return _conv121(values * mf) / torch.clamp(_conv121(mf), min=1e-12)


def demosaic_bilinear(raw: torch.Tensor, pattern: str) -> torch.Tensor:
    """Mask-multiplied convolution demosaic: for each channel, convolve the
    masked mosaic and the mask with one normalized 3x3 kernel and divide
    (the BILINEAR method of CameraIsp.h:93-127, vectorized)."""
    h, w = raw.shape
    return torch.stack([_spread(raw, m) for m in bayer_masks(pattern, h, w, raw.device)], dim=-1)


def _chroma_suppressed(raw, green, rm, bm):
    """R/B reconstruction by spreading chroma differences over the full
    green plane (demosaicChromaSuppressed, CameraIsp.h:250+)."""
    red = green + _spread(raw - green, rm)
    blue = green + _spread(raw - green, bm)
    return torch.stack([red, green, blue], dim=-1)


def _pad_reflect(img: torch.Tensor, pad: int) -> torch.Tensor:
    """``jnp.pad(mode="reflect")`` of an (H, W) plane (the edge sample is not repeated)."""
    return F.pad(img[None, None], (pad, pad, pad, pad), mode="reflect")[0, 0]


def demosaic_chroma_suppressed(raw: torch.Tensor, pattern: str) -> torch.Tensor:
    """CHROMA_SUPRESSED_BILINEAR demosaic (CameraIsp.h:32-38 enum, dispatch
    :1161-1163, demosaicGreenBilinear :227-248).

    Green at non-green sites is the bilinear average of the 4 cross
    neighbors (all of which are green on a Bayer grid); R/B then finish
    with the same constant-hue chroma-suppressed reconstruction the
    EDGE_AWARE path uses (demosaicChromaSuppressed, :250+)."""
    h, w = raw.shape
    rm, gm, bm = bayer_masks(pattern, h, w, raw.device)
    pad = _pad_reflect(raw, 1)
    cross = (pad[:-2, 1:-1] + pad[2:, 1:-1] + pad[1:-1, :-2] + pad[1:-1, 2:]) * 0.25
    green = torch.where(gm, raw, cross)
    return _chroma_suppressed(raw, green, rm, bm)


def demosaic_edge_aware(raw: torch.Tensor, pattern: str, homogeneity_radius: int = 4) -> torch.Tensor:
    """Edge-aware demosaic (EDGE_AWARE, CameraIsp.h:161-226), vectorized.

    Directional green estimates gV/gH at non-green sites (neighbor average
    plus the co-site channel's Laplacian correction), directional activity
    measures dV/dH, then a (2r+1)^2 homogeneity vote of (dH <= dV) blends
    gV toward gH; R/B finish with chroma suppression. Shifts read a
    reflect-padded plane, as the JAX package's do.
    """
    h, w = raw.shape
    rm, gm, bm = bayer_masks(pattern, h, w, raw.device)
    pad2 = _pad_reflect(raw, 2)

    def shift(dy, dx):
        return pad2[2 + dy:2 + dy + h, 2 + dx:2 + dx + w]

    up, down = shift(-1, 0), shift(1, 0)
    left, right = shift(0, -1), shift(0, 1)
    up2, down2 = shift(-2, 0), shift(2, 0)
    left2, right2 = shift(0, -2), shift(0, 2)

    # at green sites: identity green, activity from 2-step green diffs
    dv_g = ((down2 - raw).abs() + (raw - up2).abs()) * 0.5
    dh_g = ((right2 - raw).abs() + (raw - left2).abs()) * 0.5

    # at R/B sites: neighbor-average green + own-channel Laplacian correction
    gv_c = (up + down) * 0.5 + (2.0 * raw - up2 - down2) * 0.25
    gh_c = (left + right) * 0.5 + (2.0 * raw - left2 - right2) * 0.25
    dv_c = (up - down).abs() * 0.5 + (-2.0 * raw + up2 + down2).abs() * 0.5
    dh_c = (left - right).abs() * 0.5 + (-2.0 * raw + left2 + right2).abs() * 0.5

    gv = torch.where(gm, raw, gv_c)
    gh = torch.where(gm, raw, gh_c)
    dv = torch.where(gm, dv_g, dv_c)
    dh = torch.where(gm, dh_g, dh_c)

    # homogeneity vote over the (2r+1)^2 window: fraction preferring H
    frac_h = _box_mean((dh <= dv).to(raw.dtype), homogeneity_radius)
    green = gv + (gh - gv) * frac_h  # lerp(gV, gH, hCount/diameter^2)
    return _chroma_suppressed(raw, green, rm, bm)


def _butterworth(d, cutoff, order):
    """|H(d)| of a Butterworth low-pass over normalized distance."""
    return 1.0 / torch.sqrt(1.0 + (d / cutoff) ** (2.0 * order))


def dct_ortho(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Orthonormal DCT-II along ``dim`` through one FFT (Makhoul 1980): the
    even samples ascending, then the odd ones descending, transformed and
    turned by exp(-i pi k / 2N)."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    v = torch.cat([x[..., 0::2], x[..., 1::2].flip(-1)], dim=-1)
    k = torch.arange(n, device=x.device, dtype=x.dtype)
    turn = torch.polar(torch.ones_like(k), -math.pi * k / (2 * n))
    y = 2.0 * (torch.fft.fft(v, dim=-1) * turn).real
    scale = torch.full((n,), 1.0 / math.sqrt(2 * n), dtype=x.dtype, device=x.device)
    scale[0] = 1.0 / math.sqrt(4 * n)
    return (y * scale).movedim(-1, dim)


def idct_ortho(y: torch.Tensor, dim: int) -> torch.Tensor:
    """Inverse of :func:`dct_ortho` (orthonormal DCT-III) through one inverse
    FFT: V[k] = exp(i pi k / 2N) (Y[k] - i Y[N-k]) / 2 with Y[N] = 0, then
    the samples put back in place."""
    y = y.movedim(dim, -1)
    n = y.shape[-1]
    scale = torch.full((n,), math.sqrt(2 * n), dtype=y.dtype, device=y.device)
    scale[0] = math.sqrt(4 * n)
    y = y * scale  # unnormalized DCT-II coefficients
    y_rev = torch.cat([torch.zeros_like(y[..., :1]), y[..., 1:].flip(-1)], dim=-1)  # Y[N-k]
    k = torch.arange(n, device=y.device, dtype=y.dtype)
    turn = torch.polar(torch.ones_like(k), math.pi * k / (2 * n))
    v = torch.fft.ifft(turn * torch.complex(y, -y_rev) * 0.5, dim=-1).real
    x = torch.empty_like(v)
    half = (n + 1) // 2
    x[..., 0::2] = v[..., :half]
    x[..., 1::2] = v[..., half:].flip(-1)
    return x.movedim(-1, dim)


def dct2(a: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.fft.dctn(a, type=2, norm="ortho")`` of an (H, W) plane."""
    return dct_ortho(dct_ortho(a, 0), 1)


def idct2(a: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.fft.idctn(a, type=2, norm="ortho")`` of an (H, W) plane."""
    return idct_ortho(idct_ortho(a, 1), 0)


def demosaic_frequency(raw: torch.Tensor, pattern: str) -> torch.Tensor:
    """Frequency-domain demosaic (FREQUENCY, CameraIsp.h:129-159), on the
    mosaic's device.

    The zero-stuffed channel planes (green on its quincunx, half density,
    DC halved; R/B on quarter-density grids) are filtered in DCT space: a
    4th-order Butterworth low-pass with diagonal-distance sharpening on
    green, whose 2x/4x gains restore amplitude, and a 2nd-order crossover
    that blends R/B toward green at high frequencies (chroma alias
    suppression).
    """
    h, w = raw.shape
    rm, gm, bm = bayer_masks(pattern, h, w, raw.device)
    r0, g0, b0 = raw * rm, raw * gm, raw * bm

    ys = torch.linspace(0.0, 1.0, h, device=raw.device)[:, None]
    xs = torch.linspace(0.0, 1.0, w, device=raw.device)[None, :]
    d = (xs + ys) * 1.2  # kDScale diagonal distance
    sharpen_gain = _divide(d, 2.5) + 1.0
    g_gain = 2.0 * _butterworth(d, 2.0, 4.0) * sharpen_gain
    rb_gain = 4.0 * _butterworth(d, 2.0, 4.0)
    alpha = _butterworth(d * 2.0 * 3.0, 2.0, 2.0)  # crossover

    gd = dct2(g0) * g_gain
    g_f = idct2(gd)
    r_f = idct2(gd * (1 - alpha) + dct2(r0) * rb_gain * alpha)
    b_f = idct2(gd * (1 - alpha) + dct2(b0) * rb_gain * alpha)
    return torch.stack([r_f, g_f, b_f], dim=-1).clamp(0.0, 1.0)


def remove_stuck_pixels(
    raw: torch.Tensor, pattern: str, radius: int, threshold: float, darkness_threshold: float = 0.0
) -> torch.Tensor:
    """Replace outlier sensels with the median of same-color neighbors
    (removeStuckPixels, CameraIsp.h). Same-color Bayer neighbors sit at even
    offsets, so the window is a stack of rolled planes; like the JAX
    package's ``jnp.roll`` they wrap around at the frame edges.

    The (2r+1)^2 - 1 neighbors are an even count, whose median is the mean
    of the two middle values, as ``jnp.median`` takes it (``torch.median``
    returns the lower one).
    """
    if radius <= 0:
        return raw
    offs = [
        (dy, dx)
        for dy in range(-2 * radius, 2 * radius + 1, 2)
        for dx in range(-2 * radius, 2 * radius + 1, 2)
        if not (dy == 0 and dx == 0)
    ]
    stack = torch.stack([torch.roll(raw, (dy, dx), (0, 1)) for dy, dx in offs])
    ordered = stack.sort(dim=0).values
    half = len(offs) // 2
    med = (ordered[half - 1] + ordered[half]) * 0.5
    replace = (raw - med).abs() > threshold
    if darkness_threshold > 0:
        replace &= med >= darkness_threshold
    return torch.where(replace, med, raw)


def bezier(control_points: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """De Casteljau evaluation; control_points (K, C), t (...,) -> (..., C).
    Mirrors math_util::BezierCurve used for vignette rolloff (MathUtil.h)."""
    pts = [p.expand(t.shape + p.shape) for p in control_points]
    tt = t[..., None]
    while len(pts) > 1:
        pts = [(1 - tt) * a + tt * b for a, b in zip(pts[:-1], pts[1:])]
    return pts[0]


def _key_bezier(a, b, c, d, t):
    """Cubic bezier through 4 scalar controls, elementwise t."""
    ab = a + (b - a) * t
    bc = b + (c - b) * t
    cd = c + (d - c) * t
    abc = ab + (bc - ab) * t
    bcd = bc + (cd - bc) * t
    return abc + (bcd - abc) * t


def tone_curve(x: torch.Tensor, cfg: IspConfig) -> torch.Tensor:
    """Gamma -> low/high key boost beziers -> contrast S-slope
    (buildToneCurveLut, CameraIsp.h:382-415) applied directly, per channel
    along the last axis."""
    dev = x.device
    gamma = torch.tensor(cfg.gamma, dtype=torch.float32, device=dev)
    v = torch.pow(x.clamp(0.0, 1.0), gamma)

    lo = torch.tensor(cfg.low_key_boost, dtype=torch.float32, device=dev)
    hi = torch.tensor(cfg.high_key_boost, dtype=torch.float32, device=dev)
    b_lo = (0.1666 + lo).clamp(0.0, 1.0)
    c_hi = (0.8333 + hi).clamp(0.0, 1.0)
    low = _key_bezier(0.0, b_lo, 0.3333, 0.5, (v * 2.0).clamp(0.0, 1.0))
    high = _key_bezier(0.5, 0.6666, c_hi, 1.0, ((v - 0.5) * 2.0).clamp(0.0, 1.0))
    v = torch.where(v <= 0.5, low, high)

    slope = math.tan(math.pi * 0.25 * cfg.contrast)
    bias = 0.5 * (1.0 - slope)
    return (slope * v + bias).clamp(0.0, 1.0)


def iir_low_pass(img: torch.Tensor, support: float) -> torch.Tensor:
    """Separable low pass with the support fraction of the reference's IIR
    blur (CameraIsp sharpen; isp/Filter.h iirLowPass), realized as a
    Gaussian-like box cascade sized from the support."""
    h, w = img.shape[:2]
    radius = max(int(round(support * max(h, w))), 1)
    out = img
    for _ in range(3):  # box^3 ~ Gaussian
        out = _box_mean(out, radius)
    return out


def sharpen(rgb: torch.Tensor, cfg: IspConfig) -> torch.Tensor:
    """Noise-cored unsharp mask (sharpenWithIirLowPass)."""
    sharp = np.asarray(cfg.sharpening, np.float32)
    if not np.any(sharp != 0):
        return rgb
    low = iir_low_pass(rgb, cfg.sharpening_support)
    detail = rgb - low
    # noise coring: suppress amplification of tiny (noise) details
    core = 1.0 - torch.exp(-detail.abs() * cfg.noise_core)
    return (rgb + torch.from_numpy(sharp).to(rgb.device) * detail * core).clamp(0.0, 1.0)


def process(raw: torch.Tensor, cfg: IspConfig) -> torch.Tensor:
    """RAW mosaic float [0,1] (H, W) -> RGB float [0,1] (H, W, 3), on the
    mosaic's device.

    Stage order = executePipeline (CameraIsp.h:1227-1237)."""
    raw = torch.as_tensor(raw).to(torch.float32)
    dev = raw.device
    h, w = raw.shape
    pattern = cfg.bayer_pattern

    raw = companding(raw, cfg.companding_lut)

    # black level (per channel, on the mosaic)
    black = per_site(pattern, h, w, cfg.black_level, dev)
    raw = (raw - black) / torch.clamp(1.0 - black, min=1e-6)

    # anti-vignette: separable H/V Bezier rolloff (CameraIsp.h:1096)
    def rolloff(points, n):
        ctrl = torch.tensor(points, dtype=torch.float32, device=dev)
        return bezier(ctrl, _divide(torch.arange(n, dtype=torch.float32, device=dev), float(max(n - 1, 1))))

    roll_h, roll_v = rolloff(cfg.vignette_roll_off_h, w), rolloff(cfg.vignette_roll_off_v, h)
    vignette = roll_v[:, None, :] * roll_h[None, :, :]  # (H, W, 3)
    r_m, g_m, b_m = bayer_masks(pattern, h, w, dev)
    vig_site = r_m * vignette[..., 0] + g_m * vignette[..., 1] + b_m * vignette[..., 2]
    raw = raw / torch.clamp(vig_site, min=1e-6)

    # white balance (on the mosaic)
    raw = raw * per_site(pattern, h, w, cfg.white_balance_gain, dev)

    # clamp and stretch
    raw = torch.clamp(raw, per_site(pattern, h, w, cfg.clamp_min, dev), per_site(pattern, h, w, cfg.clamp_max, dev))

    raw = remove_stuck_pixels(
        raw, pattern, cfg.stuck_pixel_radius,
        cfg.stuck_pixel_threshold, cfg.stuck_pixel_darkness_threshold,
    )

    filt = cfg.demosaic_filter.upper()
    if filt == "EDGE_AWARE":
        rgb = demosaic_edge_aware(raw, pattern)
    elif filt == "FREQUENCY":
        rgb = demosaic_frequency(raw, pattern)
    elif filt in ("CHROMA_SUPPRESSED", "CHROMA_SUPRESSED_BILINEAR"):
        rgb = demosaic_chroma_suppressed(raw, pattern)
    else:
        rgb = demosaic_bilinear(raw, pattern)

    # color correct: CCM then saturation in Y/chroma space (colorCorrect),
    # each output channel three float32 multiply-adds
    ccm = [[float(v) for v in row] for row in cfg.ccm]
    rgb = torch.stack([rgb[..., 0] * m[0] + rgb[..., 1] * m[1] + rgb[..., 2] * m[2] for m in ccm], dim=-1)
    if cfg.saturation != 1.0:
        y = (rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114)[..., None]
        rgb = y + (rgb - y) * cfg.saturation

    if cfg.apply_tone_curve:
        rgb = tone_curve(rgb, cfg)
    else:
        rgb = rgb.clamp(0.0, 1.0)

    return sharpen(rgb, cfg)


def mosaic(rgb, pattern: str) -> torch.Tensor:
    """RGB (H, W, 3) -> Bayer mosaic (H, W) float32 on the input's device
    (testing helper / RigSimulator RAW output)."""
    rgb = torch.as_tensor(rgb).to(torch.float32)
    h, w = rgb.shape[:2]
    r, g, b = bayer_masks(pattern, h, w, rgb.device)
    zero = torch.zeros((), dtype=torch.float32, device=rgb.device)
    return torch.where(r, rgb[..., 0], torch.where(g, rgb[..., 1], torch.where(b, rgb[..., 2], zero)))
