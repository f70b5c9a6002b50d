"""Image sampling and windowed filters: the port of ``ops/sampling.py``.

Coordinate convention: pixel (i, j)'s center sits at (j + 0.5, i + 0.5),
matching the reference's ``getPixelBilinear`` with clamp-to-edge.

Box sums are shifted adds over a reflect-101 pad, as in the JAX package,
not ``F.conv2d``: cuDNN runs float32 convolutions in TF32 by default, which
would put ~1e-3 relative noise into every patch sum.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def pixel_center_grid(height: int, width: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """(H, W, 2) tensor of (x + 0.5, y + 0.5) pixel-center coordinates."""
    ys = torch.arange(height, device=device, dtype=dtype) + 0.5
    xs = torch.arange(width, device=device, dtype=dtype) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Clamp-to-edge bilinear sampling (sampling.py:26-67).

    img: (H, W) or (H, W, C); coords: (..., 2) as (x, y) in the pixel-center
    convention. Non-finite coords produce NaN outputs. Every tap is clamped
    on its own; the lerp runs over all four taps, so a NaN tap propagates
    even where its weight is zero.
    """
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape

    x = coords[..., 0] - 0.5
    y = coords[..., 1] - 0.5
    finite = torch.isfinite(x) & torch.isfinite(y)
    x = torch.where(finite, x, torch.zeros_like(x))
    y = torch.where(finite, y, torch.zeros_like(y))

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]

    x0u = x0.to(torch.int64)
    y0u = y0.to(torch.int64)
    x0i = x0u.clamp(0, w - 1)
    x1i = (x0u + 1).clamp(0, w - 1)
    y0i = y0u.clamp(0, h - 1)
    y1i = (y0u + 1).clamp(0, h - 1)

    flat = img.reshape(h * w, c)

    def take(yi, xi):
        return flat[yi * w + xi]

    top = take(y0i, x0i) * (1 - wx) + take(y0i, x1i) * wx
    bot = take(y1i, x0i) * (1 - wx) + take(y1i, x1i) * wx
    out = top * (1 - wy) + bot * wy
    out = torch.where(finite[..., None], out, math.nan)
    return out[..., 0] if squeeze else out


def box_sum_planar(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)^2 windowed sum over the last two axes, reflect-101 borders.

    Rows first, then columns, each as a left-to-right chain of shifted adds
    (the summation order of sampling.py:88-99 and of the CUDA kernels).
    """
    if radius == 0:
        return x
    h, w = x.shape[-2:]
    flat = x.reshape((-1, h, w))
    padded = F.pad(flat, (radius, radius, radius, radius), mode="reflect")
    return box_sum_ringed(padded, radius).reshape(x.shape)


def box_sum_ringed(padded: torch.Tensor, radius: int) -> torch.Tensor:
    """box_sum_planar of planes that already carry their ``radius``-pixel
    border: (..., H + 2r, W + 2r) -> (..., H, W), in the same order."""
    h, w = padded.shape[-2] - 2 * radius, padded.shape[-1] - 2 * radius
    lead = padded.shape[:-2]
    padded = padded.reshape((-1,) + padded.shape[-2:])
    k = 2 * radius + 1
    acc = padded[:, 0:h]
    for dy in range(1, k):
        acc = acc + padded[:, dy:dy + h]
    out = acc[:, :, 0:w]
    for dx in range(1, k):
        out = out + acc[:, :, dx:dx + w]
    return out.reshape(lead + (h, w))


def box_sum(img: torch.Tensor, radius: int) -> torch.Tensor:
    """box_sum of the JAX package's layout: (H, W) or channels-last (H, W, C)."""
    if img.ndim == 2:
        return box_sum_planar(img, radius)
    return box_sum_planar(img.movedim(-1, 0), radius).movedim(0, -1)


def box_mean(img: torch.Tensor, radius: int) -> torch.Tensor:
    k = 2 * radius + 1
    return box_sum(img, radius) / (k * k)


def dilate_bool(mask: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """8-connected boolean dilation (sampling.py:113-116): the (2r+1)^2 box
    count over reflect-101 borders is nonzero."""
    return box_sum_planar(mask.to(torch.float32), radius) > 0


def erode_bool(mask: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Boolean erosion (sampling.py:119-122): the whole (2r+1)^2 box is set,
    with reflect-101 borders, so the image edge erodes like its mirror."""
    k = 2 * radius + 1
    return box_sum_planar(mask.to(torch.float32), radius) >= k * k


def rgb_variance(img: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Per-channel windowed variance, combined with the reference's RGB
    weights. DerpUtil.cpp:214-237. img: (..., H, W, >=3) -> (..., H, W)."""
    rgb = img[..., :3].movedim(-1, -3)  # (..., 3, H, W)
    k = 2 * radius + 1
    mean = box_sum_planar(rgb, radius) / (k * k)
    mean_sq = box_sum_planar(rgb * rgb, radius) / (k * k)
    var = mean_sq - mean * mean
    return var[..., 0, :, :] * 0.3333 + var[..., 1, :, :] * 0.3334 + var[..., 2, :, :] * 0.3333


def _lanczos4_taps(src: int, dst: int):
    """Source indices and weights of cv2.resize(INTER_LANCZOS4) along one
    axis (imgproc/resize.cpp: interpolateLanczos4, clamp-to-edge taps
    sx-3 .. sx+4). Returns (dst, 8) int64 indices and float32 weights."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(f).astype(np.int64)
    fx = (f - sx.astype(np.float32)).astype(np.float64)
    s45 = 0.70710678118654752440084436210485
    cs = np.array([[1, 0], [-s45, -s45], [0, 1], [s45, -s45],
                   [-1, 0], [s45, s45], [0, -1], [-s45, s45]])
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
    idx = np.clip(sx[:, None] + np.arange(-3, 5)[None, :], 0, src - 1)
    return idx, coeffs


def resize_lanczos4(img: torch.Tensor, size_wh) -> torch.Tensor:
    """cv2.resize(img, size_wh, interpolation=INTER_LANCZOS4) for a float
    (H, W) map or (H, W, C) image: 8-tap separable, horizontal pass first,
    float32 sums in tap order, clamp-to-edge borders."""
    w_out, h_out = int(size_wh[0]), int(size_wh[1])
    h, w = img.shape[:2]
    xi, xw = _lanczos4_taps(w, w_out)
    yi, yw = _lanczos4_taps(h, h_out)
    dev = img.device
    chan = (1,) * (img.ndim - 2)
    xi, xw = torch.from_numpy(xi).to(dev), torch.from_numpy(xw).to(dev).reshape((w_out, 8) + chan)
    yi, yw = torch.from_numpy(yi).to(dev), torch.from_numpy(yw).to(dev).reshape((h_out, 1, 8) + chan)
    rows = img[:, xi[:, 0]] * xw[:, 0]
    for k in range(1, 8):
        rows = rows + img[:, xi[:, k]] * xw[:, k]
    out = rows[yi[:, 0]] * yw[:, :, 0]
    for k in range(1, 8):
        out = out + rows[yi[:, k]] * yw[:, :, k]
    return out
