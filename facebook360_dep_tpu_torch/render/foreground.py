"""Foreground masks by background subtraction: the port of ``render/foreground.py``.

Reference: ``render/BackgroundSubtractionUtil.h:20-88``: Gaussian-blur both
images, threshold the L2 norm of the RGB difference, then a morphological
closing (dilate, then erode) fills holes.
"""

from __future__ import annotations

import torch

from ..ops import sampling
from . import rephoto


def generate_foreground_mask(
    background: torch.Tensor,  # (H, W, 3) float [0,1]
    frame: torch.Tensor,  # (H, W, 3)
    blur_radius: int = 1,
    threshold: float = 0.04,
    morph_closing_size: int = 4,
) -> torch.Tensor:
    """(H, W) bool: where ``frame`` differs from ``background``. The blur's
    sigma comes from its radius as in cv::GaussianBlur (sigma=0)."""
    bg, fr = background[..., :3], frame[..., :3]
    if blur_radius > 0:
        bg = rephoto.gaussian_blur(bg, blur_radius, sigma=0.0)
        fr = rephoto.gaussian_blur(fr, blur_radius, sigma=0.0)
    d = (bg - fr).abs()
    mask = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]) > threshold
    r = morph_closing_size // 2 if morph_closing_size > 0 else 0
    if r > 0:
        mask = sampling.erode_bool(sampling.dilate_bool(mask, r), r)
    return mask


def generate_foreground_masks(backgrounds: torch.Tensor, frames: torch.Tensor, **kw) -> torch.Tensor:
    """(N, H, W) bool masks of stacked backgrounds and frames."""
    return torch.stack([generate_foreground_mask(b, f, **kw) for b, f in zip(backgrounds, frames)])
