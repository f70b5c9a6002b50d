"""The port's disparity filters (facebook360_dep_tpu_torch/ops/filters.py)
against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest

from facebook360_dep_tpu.ops import filters as jf
from facebook360_dep_tpu_torch.ops import filters as tf

from torch_parity import f32, tt


@pytest.mark.parametrize("dy,dx", [(0, 0), (-2, 1), (3, -4), (1, 1)])
def test_shift_clamps_to_edge(dy, dx):
    img = f32(np.random.RandomState(0).rand(6, 8, 3))
    np.testing.assert_array_equal(tf._shift(tt(img), dy, dx).numpy(), np.asarray(jf._shift(jnp.asarray(img), dy, dx)))
    m = img[..., 0] > 0.5
    np.testing.assert_array_equal(tf._shift(tt(m), dy, dx).numpy(), np.asarray(jf._shift(jnp.asarray(m), dy, dx)))


@pytest.mark.parametrize("radius", [1, 3, 5])
def test_joint_bilateral(radius):
    """121 taps at radius 5; exp() differs by ulps between XLA and PyTorch,
    so 2e-6 relative on disparities of O(0.1)."""
    rng = np.random.RandomState(radius)
    h, w = 17, 23
    guide = f32(rng.rand(h, w, 3) * 0.05 + np.linspace(0, 1, w)[None, :, None])
    image = f32(rng.rand(h, w) * 0.2 + 0.1)
    mask = rng.rand(h, w) > 0.2
    want = np.asarray(jf.joint_bilateral(jnp.asarray(image), jnp.asarray(guide), jnp.asarray(mask), radius))
    got = tf.joint_bilateral(tt(image), tt(guide), tt(mask), radius).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6)


def test_sorting_network_pairs_identical():
    for n in (2, 5, 9, 25):
        assert tf._sorting_network_pairs(n) == jf._sorting_network_pairs(n)


@pytest.mark.parametrize("with_background", [False, True])
def test_masked_median(with_background):
    """NaN and zero samples are skipped, even counts average, unmasked
    centers pass the background through: exact."""
    rng = np.random.RandomState(7)
    h, w = 14, 19
    image = f32(rng.rand(h, w))
    image[rng.rand(h, w) < 0.1] = np.nan
    image[rng.rand(h, w) < 0.1] = 0.0
    mask = rng.rand(h, w) > 0.3
    bg = f32(rng.rand(h, w)) if with_background else None
    want = np.asarray(jf.masked_median(jnp.asarray(image), None if bg is None else jnp.asarray(bg), jnp.asarray(mask), 1))
    got = tf.masked_median(tt(image), None if bg is None else tt(bg), tt(mask), 1).numpy()
    np.testing.assert_array_equal(got, want)
