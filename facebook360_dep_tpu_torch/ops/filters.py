"""Edge-aware disparity filters: the port of ``ops/filters.py``.

Joint bilateral, temporal bilateral and masked median
(``TemporalBilateralFilter.h:39-215``, ``util/CvUtil.h:336-385``) as loops
over window offsets of whole-image tensor ops. Each filter edge-pads its
inputs once and reads every offset as a view of the padded tensor, which is
``_shift`` without a copy per tap. The solver filters all of a level's maps
in one launch of ``warp_cuda.joint_bilateral``, whose plain twin is
:func:`joint_bilateral` a map at a time.
"""

from __future__ import annotations

import torch

# Spatial bilateral constants (Derp.h:43-48); weights in RGB channel order.
BILATERAL_SPACE_RADIUS_MIN = 1
BILATERAL_SPACE_RADIUS_MAX = 5
BILATERAL_SIGMA = 0.005
BILATERAL_WEIGHTS_RGB = (1.0, 1.0, 0.5)


def _edge_pad(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Clamp-to-edge pad of the leading (H, W) axes by ``radius`` (any dtype)."""
    h, w = img.shape[:2]
    iy = torch.arange(-radius, h + radius, device=img.device).clamp(0, h - 1)
    ix = torch.arange(-radius, w + radius, device=img.device).clamp(0, w - 1)
    return img[iy][:, ix]


def _window(padded: torch.Tensor, radius: int, dy: int, dx: int, h: int, w: int) -> torch.Tensor:
    """The (dy, dx)-shifted (H, W) view of a tensor padded by ``radius``."""
    return padded[radius + dy:radius + dy + h, radius + dx:radius + dx + w]


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Clamp-to-edge shifted image: out[y, x] = img[clip(y+dy), clip(x+dx)]."""
    h, w = img.shape[:2]
    iy = (torch.arange(h, device=img.device) + dy).clamp(0, h - 1)
    ix = (torch.arange(w, device=img.device) + dx).clamp(0, w - 1)
    return img[iy][:, ix]


def joint_bilateral(
    image: torch.Tensor,  # (H, W) values to filter
    guide: torch.Tensor,  # (H, W, 3) color guide in [0,1]
    mask: torch.Tensor,  # (H, W) bool
    radius: int,
    sigma: float = BILATERAL_SIGMA,
    weights=BILATERAL_WEIGHTS_RGB,
) -> torch.Tensor:
    """Color-guided joint bilateral filter (filters.py:39-69).

    weight = exp(-(sum_c w_c dc^2 / 3) / (2 sigma^2)); masked-out samples
    skipped; masked-out centers pass through.
    """
    h, w = image.shape
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


def temporal_bilateral(
    guides: torch.Tensor,  # (T, H, W, 3)
    images: torch.Tensor,  # (T, H, W)
    masks: torch.Tensor,  # (T, H, W) bool
    frame_offset: int,
    sigma: float,
    spatial_radius: int,
    weights=BILATERAL_WEIGHTS_RGB,
) -> torch.Tensor:
    """Cross-frame joint bilateral filter for one output frame
    (filters.py:152-186; TemporalBilateralFilter.h:126-215).

    As in the reference, the value averaged is each frame's CENTER pixel:
    the spatial offsets only shape the guide-difference weights,
    exp(-sum_c w_c dc^2 / sigma^2), of the neighbors' colors against the
    output frame's color. Centers outside the output frame's mask pass
    through.
    """
    ref_guide = guides[frame_offset]
    h, w = images.shape[1:]
    sum_w = torch.zeros_like(images[0])
    sum_wv = torch.zeros_like(images[0])
    inv_sigma_sq = 1.0 / (sigma * sigma)
    r = spatial_radius
    for t in range(guides.shape[0]):
        center_val = images[t]
        guide_p = _edge_pad(guides[t], r)
        mask_p = _edge_pad(masks[t].to(images.dtype), r)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                d = ref_guide - _window(guide_p, r, dy, dx, h, w)
                dist = weights[0] * d[..., 0] * d[..., 0]
                for c in (1, 2):
                    dist = dist + weights[c] * d[..., c] * d[..., c]
                weight = torch.exp(-dist * inv_sigma_sq) * _window(mask_p, r, dy, dx, h, w)
                sum_w += weight
                sum_wv += weight * center_val
    filtered = sum_wv / torch.where(sum_w == 0, 1.0, sum_w)
    return torch.where(masks[frame_offset], filtered, images[frame_offset])


def _sorting_network_pairs(n: int) -> list[tuple[int, int]]:
    """Batcher odd-even mergesort comparator pairs for ``n`` inputs.

    Built over the next power of two with out-of-range comparators dropped
    (the dropped lanes behave as +inf padding, which never needs to move
    down).
    """
    size = 1
    while size < n:
        size <<= 1
    pairs: list[tuple[int, int]] = []
    p = 1
    while p < size:
        k = p
        while k >= 1:
            for j in range(k % p, size - k, 2 * k):
                for i in range(k):
                    if (i + j) // (p * 2) == (i + j + k) // (p * 2):
                        if i + j + k < n:
                            pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def masked_median(
    image: torch.Tensor,  # (H, W)
    background: torch.Tensor | None,  # (H, W) or None
    mask: torch.Tensor,  # (H, W) bool
    radius: int,
    ignore_nan: bool = True,
) -> torch.Tensor:
    """Median over in-bounds, masked, non-NaN/non-zero window samples
    (filters.py:97-149): a Batcher network of elementwise min/max, then a
    rank select; an even count averages the two middle samples. Unmasked
    centers take the background value (or 0); masked centers with an empty
    window take 0.
    """
    h, w = image.shape
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
            if ignore_nan:
                m = m & torch.isfinite(v) & (v != 0)
            # invalid samples become +FLT_MAX so the network never sees NaNs
            planes.append(torch.where(m, v, big))
            valid.append(m)
    for i, j in _sorting_network_pairs(len(planes)):
        planes[i], planes[j] = torch.minimum(planes[i], planes[j]), torch.maximum(planes[i], planes[j])
    n = torch.stack(valid).sum(dim=0)
    half = n // 2
    # rank select without gathers: planes are sorted ascending per pixel
    upper = planes[0]
    lower = planes[0]
    for i in range(1, len(planes)):
        upper = torch.where(half >= i, planes[i], upper)  # planes[half]
        lower = torch.where(half - 1 >= i, planes[i], lower)  # planes[max(half-1, 0)]
    median = torch.where(n % 2 == 1, upper, (lower + upper) / 2.0)
    out = torch.where(n > 0, median, 0.0)
    passthrough = torch.zeros_like(image) if background is None else background
    return torch.where(mask, out, passthrough)
