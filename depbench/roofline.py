"""Operations and bytes of the port's kernels, and the card's published peaks.

Frozen copy of ``chip_smoke.py``'s ``HBM_BYTES_PER_S``, ``FP32_FLOP_PER_S``,
``k1_flops``, ``k2_flops``, ``roofline``, ``k1_work``, ``k2_work`` and
``k3_work`` at commit 73fe11c54864db6ce32ac485256a11aec4484c40. A kernel's
bound is the larger of its bytes (each input read once, each output written
once) over the memory rate and its FLOPs over the float32 rate; its share of
the roofline is the bound over the time it took.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
PARAM_BYTES = 24 * 4  # one packed source camera


def k1_flops(c: int) -> int:
    """A (destination pixel, source) of K1: the projection ~70, a bilinear lerp of 6 a channel."""
    return 70 + 6 * c


def k2_flops(c: int) -> int:
    """A (destination pixel, non-self source) of K2: differences and squares, separable 3x3
    boxes of C + 2 planes, the bias compensation, the top-two fold."""
    return (3 * c - 1) + 4 * (c + 2) + (12 + 2 * c) + 4


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds the card can take for this work."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


def k1_work(n, c, hs, ws, h, w, d):
    """(bytes, FLOPs) of sampling d destination maps from n sources of C channels in one launch."""
    hw = h * w
    return (4 * n * c * hs * ws + n * PARAM_BYTES + d * (12 + 16 * hw) + d * n * (4 * c + 1) * hw,
            d * n * hw * k1_flops(c))


def k2_work(n, c, h, w):
    """The non-self sources' samples and validity, dst and variance read once, cost and confidence written once."""
    hw = h * w
    return 4 * (n - 1) * c * hw + (n - 1) * hw + 4 * c * hw + 4 * hw + 8 * hw, (n - 1) * hw * k2_flops(c)


def k3_work(n, hs, ws, h, w):
    """The non-self sources' three planes, cameras, disparity, rays, dst and variance read once, outputs once."""
    hw = h * w
    return (4 * (n - 1) * 3 * hs * ws + n * PARAM_BYTES + 12 + 4 * 8 * hw + 8 * hw,
            (n - 1) * hw * (k1_flops(3) + k2_flops(3)))
