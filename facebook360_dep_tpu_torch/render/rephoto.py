"""Rephotography quality metric: the port of ``facebook360_dep_tpu/render/rephoto.py``.

MSSIM / NCC score maps (``render/RephotographyUtil.h:20-183``: Wang et al.
2004 SSIM with a Gaussian window of sigma 1.5; NCC = SSIM with
alpha = beta = 0, gamma = 1). The maps and their masked means are computed
on the device of the images; only the three channel means reach the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SSIM_SIGMA = 1.5  # RephotographyUtil.h:24-27
C1 = 0.0001  # (0.01 * L)^2, L = 1
C2 = 0.0009  # (0.03 * L)^2
C3 = C2 / 2.0


def gaussian_kernel(radius: int, sigma: float = SSIM_SIGMA, device=None, dtype=torch.float32):
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    if sigma <= 0:  # OpenCV's default sigma from kernel size
        sigma = 0.3 * ((2 * radius + 1 - 1) * 0.5 - 1) + 0.8
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return torch.as_tensor(k / k.sum(), dtype=dtype, device=device)


def gaussian_blur(img: torch.Tensor, radius: int, sigma: float = SSIM_SIGMA) -> torch.Tensor:
    """Separable Gaussian with reflect-101 borders (cv::GaussianBlur default)
    on an (H, W) or (H, W, C) image: weighted sums of shifted images, rows
    then columns, in the JAX package's order (not F.conv2d, which cuDNN
    would run in TF32)."""
    if radius < 1:
        return img
    squeeze = img.ndim == 2
    planar = img[None] if squeeze else img.permute(2, 0, 1)  # (C, H, W)
    k = gaussian_kernel(radius, sigma, img.device, img.dtype)
    p = F.pad(planar[None], (radius, radius, radius, radius), mode="reflect")[0]
    h, w = planar.shape[1:]
    out_rows = sum(k[i + radius] * p[:, radius + i:radius + i + h, :] for i in range(-radius, radius + 1))
    out = sum(k[j + radius] * out_rows[:, :, radius + j:radius + j + w] for j in range(-radius, radius + 1))
    return out[0] if squeeze else out.permute(1, 2, 0)


def compute_ssim(x, y, blur_radius: int = 1, alpha: float = 1.0, beta: float = 1.0,
                 gamma: float = 1.0) -> torch.Tensor:
    """Per-pixel, per-channel SSIM map for float RGB images in [0, 1].
    RephotographyUtil.h:56-106. NCC: alpha=beta=0, gamma=1."""
    mu_x = gaussian_blur(x, blur_radius)
    mu_y = gaussian_blur(y, blur_radius)
    mu2_x, mu2_y, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig2_x = gaussian_blur((x - mu_x) * (x - mu_x), blur_radius)
    sig2_y = gaussian_blur((y - mu_y) * (y - mu_y), blur_radius)
    sig_xy = gaussian_blur((x - mu_x) * (y - mu_y), blur_radius)
    sig_x = torch.sqrt(torch.clamp(sig2_x, min=0.0))
    sig_y = torch.sqrt(torch.clamp(sig2_y, min=0.0))

    luminance = (2 * mu_xy + C1) / (mu2_x + mu2_y + C1)
    contrast = (2 * sig_x * sig_y + C2) / (sig2_x + sig2_y + C2)
    structure = (sig_xy + C3) / (sig_x * sig_y + C3)
    return torch.pow(luminance, alpha) * torch.pow(contrast, beta) * torch.pow(structure, gamma)


def compute_score_map(method: str, x, y, blur_radius: int = 1) -> torch.Tensor:
    if method == "MSSIM":
        return compute_ssim(x, y, blur_radius, 1.0, 1.0, 1.0)
    if method == "NCC":
        return compute_ssim(x, y, blur_radius, 0.0, 0.0, 1.0)
    raise ValueError(f"invalid method {method}")


def average_score(score_map: torch.Tensor, mask=None) -> np.ndarray:
    """Per-channel mean over (mask & finite) pixels, 0 where none
    (RephotographyUtil.h:108-127). Summed in float64 on the map's device."""
    s = score_map.double()
    m = torch.isfinite(s)
    if mask is not None:
        m &= (torch.as_tensor(mask, device=s.device) > 0)[..., None]
    count = m.sum(dim=tuple(range(s.ndim - 1)))
    total = torch.where(m, s, 0.0).sum(dim=tuple(range(s.ndim - 1)))
    return torch.where(count > 0, total / count.clamp(min=1), 0.0).cpu().numpy()


def format_results(avg_rgb) -> str:
    return f"R {100*avg_rgb[0]:.2f}%, G {100*avg_rgb[1]:.2f}%, B {100*avg_rgb[2]:.2f}%"
