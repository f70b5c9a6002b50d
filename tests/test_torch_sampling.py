"""The port's sampling ops (facebook360_dep_tpu_torch/ops/sampling.py) against
the JAX package's, float32 inputs made with numpy."""

import jax.numpy as jnp
import numpy as np
import pytest

from facebook360_dep_tpu.ops import sampling as js
from facebook360_dep_tpu_torch.ops import sampling as ts

from torch_parity import f32, tt


def test_pixel_center_grid():
    np.testing.assert_array_equal(ts.pixel_center_grid(5, 7).numpy(), np.asarray(js.pixel_center_grid(5, 7)))


@pytest.mark.parametrize("channels", [None, 1, 3])
def test_bilinear_sample(channels):
    """Every tap clamps to the edge, non-finite coords give NaN, and a NaN
    tap propagates even with zero weight. The lerp runs in the same order on
    both sides: exact up to the product rounding XLA may fuse (1e-6)."""
    rng = np.random.RandomState(0)
    shape = (9, 13) if channels is None else (9, 13, channels)
    img = f32(rng.rand(*shape))
    img[4, 6] = np.nan
    coords = f32(rng.uniform(-3, 16, (7, 11, 2)))
    coords[0, 0] = [np.nan, 2.0]
    coords[0, 1] = [np.inf, 2.0]
    coords[1, 0] = [6.5, 4.5]  # exactly on the NaN pixel's center: zero-weight neighbours
    want = np.asarray(js.bilinear_sample(jnp.asarray(img), jnp.asarray(coords)))
    got = ts.bilinear_sample(tt(img), tt(coords)).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("shape", [(10, 14), (10, 14, 3)])
def test_box_sum_reflect101(radius, shape):
    """Same shifted-add order as the JAX package (rows, then columns)."""
    img = f32(np.random.RandomState(radius).rand(*shape))
    np.testing.assert_allclose(ts.box_sum(tt(img), radius).numpy(), np.asarray(js.box_sum(jnp.asarray(img), radius)),
                               rtol=1e-6)
    np.testing.assert_allclose(ts.box_mean(tt(img), radius).numpy(), np.asarray(js.box_mean(jnp.asarray(img), radius)),
                               rtol=1e-6)


def test_box_sum_planar_batches_leading_axes():
    x = tt(np.random.RandomState(5).rand(2, 3, 8, 9))
    out = ts.box_sum_planar(x, 1)
    for i in range(2):
        for c in range(3):
            np.testing.assert_array_equal(out[i, c].numpy(), ts.box_sum(x[i, c], 1).numpy())


def test_rgb_variance():
    """var = E[x^2] - E[x]^2 cancels; 1e-7 absolute on O(1e-2) variances."""
    img = f32(np.random.RandomState(6).rand(3, 12, 15, 3))
    want = np.stack([np.asarray(js.rgb_variance(jnp.asarray(i))) for i in img])
    np.testing.assert_allclose(ts.rgb_variance(tt(img)).numpy(), want, atol=1e-7)
