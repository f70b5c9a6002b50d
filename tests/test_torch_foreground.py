"""The port's foreground-mask and temporal-filter ops against the JAX
package's: boolean dilation and erosion (reflect-101 borders),
generate_foreground_mask(s) (render/foreground.py) and
filters.temporal_bilateral."""

import jax.numpy as jnp
import numpy as np
import pytest

from facebook360_dep_tpu.ops import filters as jfilters
from facebook360_dep_tpu.ops import sampling as jsampling
from facebook360_dep_tpu.render import foreground as jfg
from facebook360_dep_tpu_torch.ops import filters as tfilters
from facebook360_dep_tpu_torch.ops import sampling as tsampling
from facebook360_dep_tpu_torch.render import foreground as tfg

from torch_parity import f32, tt


@pytest.mark.parametrize("radius", [1, 2, 3])
def test_dilate_erode_match_jax_at_borders(radius):
    """Box counts over reflect-101 borders, identical booleans. Masks set
    along the image edge make the border rule visible: erosion there
    follows the mirrored pixels (zero padding would erode every edge)."""
    rng = np.random.RandomState(radius)
    mask = rng.rand(23, 31) < 0.3
    full = np.ones((23, 31), bool)
    full[10:13, 12:15] = False
    edge = np.zeros((23, 31), bool)
    edge[:, :2] = edge[:1, :] = True
    for m in (mask, ~mask, full, edge):
        np.testing.assert_array_equal(tsampling.dilate_bool(tt(m), radius).numpy(),
                                      np.asarray(jsampling.dilate_bool(jnp.asarray(m), radius)))
        np.testing.assert_array_equal(tsampling.erode_bool(tt(m), radius).numpy(),
                                      np.asarray(jsampling.erode_bool(jnp.asarray(m), radius)))
    # the image edge survives erosion of an all-set border band
    assert tsampling.erode_bool(tt(full), radius).numpy()[0].all()


def _scene(seed, h=40, w=52):
    """A textured background and a frame with two textured patches on it."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    bg = np.stack([np.sin(x / 5.0 + c) * np.cos(y / 7.0 - c) for c in range(3)], -1) * 0.3 + 0.5
    bg = f32(bg + rng.rand(h, w, 3) * 0.02)
    frame = bg.copy()
    frame[8:20, 10:25] = f32(rng.rand(12, 15, 3))
    frame[25:33, 30:47] += f32(rng.rand(8, 17, 3) * 0.1)
    frame[2, 2] += 0.5  # a lone speck: closing keeps it, blur spreads it
    return bg, frame


@pytest.mark.parametrize("blur,threshold,closing", [(1, 0.04, 4), (2, 0.02, 3), (0, 0.1, 0), (1, 0.04, 6)])
def test_generate_foreground_mask_matches_jax(blur, threshold, closing):
    """Identical booleans, except where the difference norm lies within 1e-5
    of the threshold (float32 blur order): there the closing may spread a
    flipped pixel, so those pixels' closing windows are excluded."""
    bg, frame = _scene(blur + closing)
    want = np.asarray(jfg.generate_foreground_mask(jnp.asarray(bg), jnp.asarray(frame), blur, threshold, closing))
    got = tfg.generate_foreground_mask(tt(bg), tt(frame), blur, threshold, closing).numpy()
    assert 0.05 < want.mean() < 0.9
    diff = np.abs(bg - frame)
    if blur:
        diff = np.abs(np.asarray(jfg.rephoto.gaussian_blur(jnp.asarray(bg), blur, sigma=0.0)
                                 - jfg.rephoto.gaussian_blur(jnp.asarray(frame), blur, sigma=0.0)))
    near = np.abs(np.linalg.norm(diff, axis=-1) - threshold) < 1e-5
    r = closing // 2
    if r:
        near = np.asarray(jsampling.dilate_bool(jnp.asarray(near), 2 * r))
    assert near.mean() < 0.01
    np.testing.assert_array_equal(got[~near], want[~near])


def test_generate_foreground_masks_batched():
    scenes = [_scene(s) for s in (5, 6, 7)]
    bgs, frames = f32([b for b, _ in scenes]), f32([f for _, f in scenes])
    want = np.asarray(jfg.generate_foreground_masks(jnp.asarray(bgs), jnp.asarray(frames), blur_radius=1))
    got = tfg.generate_foreground_masks(tt(bgs), tt(frames), blur_radius=1).numpy()
    assert got.shape == want.shape == (3, 40, 52)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("frames,offset,radius,sigma", [(3, 1, 1, 0.01), (5, 0, 2, 0.05), (2, 1, 1, 0.3)])
def test_temporal_bilateral_matches_jax(frames, offset, radius, sigma):
    """The reference's quirk kept: each frame's CENTER value is averaged and
    the spatial taps only weight it; NaN disparities outside the masks pass
    through. atol 1e-6 on values in [0.1, 0.4]."""
    rng = np.random.RandomState(frames + radius)
    h, w = 24, 33
    guides = f32(rng.rand(frames, h, w, 3) * 0.2 + 0.4)
    guides[:, :, 16:] += 0.3  # an edge the weights respect
    images = f32(rng.rand(frames, h, w) * 0.3 + 0.1)
    masks = rng.rand(frames, h, w) < 0.85
    images[offset][~masks[offset]] = np.nan
    want = np.asarray(jfilters.temporal_bilateral(jnp.asarray(guides), jnp.asarray(images), jnp.asarray(masks),
                                                  offset, sigma, radius, weights=(1.0, 1.0, 0.5)))
    got = tfilters.temporal_bilateral(tt(guides), tt(images), tt(masks), offset, sigma, radius,
                                      weights=(1.0, 1.0, 0.5)).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert not np.allclose(want[masks[offset]], images[offset][masks[offset]])  # it filtered
