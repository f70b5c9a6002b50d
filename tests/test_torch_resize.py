"""The port's host resize (facebook360_dep_tpu_torch/core/io.py::resize_image)
against the JAX package's io.resize_image, which is cv2.resize: every
interpolation mode of every depth that cv2 interpolates, with one, three and
four channels, shrinking, enlarging and mixed axes.

Tolerances (largest difference from cv2 on this grid):
- exact: nearest; area and linear of uint8, uint16 and float32; Lanczos4 of
  uint8. Area of float32 shrinks and of every enlargement is cv2's own
  arithmetic; linear follows OpenCV's 8-bit fixed point and, for the other
  depths, its double coordinates with one rounding per pass.
- float64: 1e-6 (the shrinking area path sums in float32, as it always
  has; linear and Lanczos4 differ from cv2's double sums by rounding only).
- within one level: int16 linear, cubic of the integer depths and Lanczos4
  of 16-bit (cv2's vector code rounds its sums in another order).
- float32 cubic and Lanczos4: 1e-5.
"""

import cv2
import numpy as np
import pytest

from facebook360_dep_tpu.core import io as jio
from facebook360_dep_tpu_torch.core import io

import torch_parity  # noqa: F401  (thread count)

SHAPES = [((48, 64), (128, 96)), ((38, 50), (133, 101)), ((5, 7), (20, 9)), ((48, 64), (40, 96)),
          ((48, 64), (128, 30)), ((48, 64), (40, 30)), ((48, 64), (32, 24)), ((48, 64), (16, 12)),
          ((101, 77), (50, 33))]
DTYPES = [np.uint8, np.uint16, np.int16, np.float32, np.float64]
MODES = ["area", "linear", "nearest", "cubic", "lanczos"]
EXACT = {("area", np.uint8), ("area", np.uint16), ("area", np.int16), ("area", np.float32),
         ("linear", np.uint8), ("linear", np.uint16), ("linear", np.float32), ("lanczos", np.uint8)}


def _tolerance(mode, dtype):
    if mode == "nearest" or (mode, dtype) in EXACT:
        return 0.0
    if dtype == np.float64:
        return 1e-6
    if dtype == np.float32:
        return 1e-5
    return 1.0


def _image(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    if np.dtype(dtype).kind == "f":
        return rng.rand(*shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.randint(info.min, int(info.max) + 1, shape).astype(dtype)


@pytest.mark.parametrize("src_hw,dst_wh", SHAPES)
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
def test_resize_image_matches_cv2(mode, dtype, channels, src_hw, dst_wh):
    shape = src_hw + (channels,)
    img = _image(shape, dtype, seed=channels * 1000 + dst_wh[0] + src_hw[1])
    want = jio.resize_image(img, dst_wh, mode)
    got = io.resize_image(img, dst_wh, mode)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
    assert err <= _tolerance(mode, dtype), (mode, np.dtype(dtype).name, err)


@pytest.mark.parametrize("mode", MODES)
def test_resize_image_gray_and_same_size(mode):
    """An (H, W) image stays (H, W); the same size is a copy in both."""
    img = _image((38, 50), np.uint16, seed=7)
    for size in [(133, 101), (50, 38)]:
        want = jio.resize_image(img, size, mode)
        got = io.resize_image(img, size, mode)
        assert got.shape == want.shape == (size[1], size[0])
        assert np.abs(got.astype(np.int64) - want).max() <= _tolerance(mode, np.uint16)
    assert np.array_equal(io.resize_image(img, (50, 38), mode), img)
