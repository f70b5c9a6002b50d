"""The port's corner detection and epipolar ZNCC matching
(``calib/features``) against the JAX package's, in float32 on the CPU, on
the JAX sphere scene of tests/test_features.py (4 cameras, 160x120).

The port takes the Shi-Tomasi gradients with reflect-101 borders where the
JAX package's ``jnp.roll`` wraps around (its image corners become the
strongest "corners"): the responses agree two pixels and more from the
border, and the gray images the detectors are compared on have a constant
frame, on which the two border rules agree too.

Tolerances: the response map to 1e-6 of its maximum (measured 8e-8: the
box sums add in another order); corner positions to 1e-6 px in the same
order with equal scores' ranks; patches to 1e-6; matches are the same pairs
with ZNCC scores within 2e-6 (measured 8e-7: the float32 matmul sums in
another order than XLA's dot).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from facebook360_dep_tpu.calib import features as jf
from facebook360_dep_tpu.render import synthetic as jsyn
from facebook360_dep_tpu_torch.calib import features as tf
from facebook360_dep_tpu_torch.core import camera as tcam

from torch_parity import jax_f32, port_rig

MAX_CORNERS = 300
FRAME = 8  # px of constant border


def framed(gray):
    out = gray.copy()
    out[:FRAME], out[-FRAME:], out[:, :FRAME], out[:, -FRAME:] = 0.5, 0.5, 0.5, 0.5
    return out


@pytest.fixture(scope="module")
def scene():
    """The rigs of both packages and the framed green channels."""
    rig = jsyn.make_test_rig(num_cameras=4, resolution=(160, 120), ring_radius=0.1)
    colors, _ = jsyn.render_sphere_scene(rig, (160, 120), radius=5.0, seed=11)
    grays = np.stack([framed(g) for g in np.asarray(colors)[..., 1].astype(np.float32)])
    return rig, port_rig(tcam, rig), grays, np.asarray(colors)[..., 1].astype(np.float32)


@pytest.fixture(scope="module")
def corners(scene):
    _, _, grays, _ = scene
    return [jf.detect_corners(g, max_corners=MAX_CORNERS, octaves=2) for g in grays]


def cams32(rig, trig, i):
    """Camera i of both packages in float32, as match_corners casts them."""
    return jax_f32(rig.camera(i)), trig.camera(i).to(dtype=torch.float32)


@pytest.mark.parametrize("i", range(4))
def test_shi_tomasi_response(scene, i):
    _, _, grays, raw = scene
    for img, inner in ((grays[i], slice(None)), (raw[i], slice(2, -2))):
        want = np.asarray(jf.shi_tomasi_response(jnp.asarray(img)))[inner, inner]
        got = tf.shi_tomasi_response(torch.from_numpy(img)).numpy()[inner, inner]
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_shi_tomasi_border_does_not_wrap():
    """On a ramp with a faint square the wrapped differences make the
    image's corners the strongest response (the JAX package's); with
    reflect-101 borders the square's corners lead."""
    ys, xs = np.mgrid[0:64, 0:64].astype(np.float32)
    img = (xs + ys) / 128.0
    img[20:44, 20:44] += 0.05
    want = np.asarray(jf.shi_tomasi_response(jnp.asarray(img)))
    got = tf.shi_tomasi_response(torch.from_numpy(img)).numpy()
    y, x = np.unravel_index(np.argmax(want), want.shape)
    assert min(y, 63 - y) <= 1 and min(x, 63 - x) <= 1
    assert max(got[:2].max(), got[-2:].max(), got[:, :2].max(), got[:, -2:].max()) < 0.1 * got.max()
    corners = tf.detect_corners(img, max_corners=4, min_distance=3, octaves=1)
    assert len(corners.xy) == 4
    for x, y in corners.xy:
        assert min(abs(x - 20), abs(x - 44)) <= 2 and min(abs(y - 20), abs(y - 44)) <= 2, corners.xy


@pytest.mark.parametrize("i", range(4))
def test_detect_corners(scene, corners, i):
    _, _, grays, _ = scene
    got = tf.detect_corners(torch.from_numpy(grays[i]), max_corners=MAX_CORNERS, octaves=2)
    want = corners[i]
    assert len(got.xy) == len(want.xy) > 50
    np.testing.assert_allclose(got.xy, want.xy, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.score, want.score, rtol=1e-6, atol=0)


@pytest.mark.parametrize("i,hw", [(0, (120, 160)), (1, (120, 160)), (2, (111, 151)), (3, (97, 133))])
def test_detect_corners_fov_mask(scene, i, hw):
    """``fov_mask`` as the JAX package applies it: at each octave the mask,
    as uint8, is area-resized to the response (by 2 or by a non-integer
    factor on odd sizes) and the response is -inf outside it. Same corners,
    all inside the mask."""
    _, _, grays, _ = scene
    h, w = hw
    img = framed(grays[i][:h, :w])
    ys, xs = np.mgrid[0:h, 0:w]
    mask = (xs - 0.45 * w) ** 2 + (ys - 0.55 * h) ** 2 < (0.4 * h) ** 2
    want = jf.detect_corners(img, max_corners=MAX_CORNERS, octaves=2, fov_mask=mask)
    got = tf.detect_corners(torch.from_numpy(img), max_corners=MAX_CORNERS, octaves=2, fov_mask=torch.from_numpy(mask))
    assert len(got.xy) == len(want.xy) > 10
    np.testing.assert_allclose(got.xy, want.xy, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.score, want.score, rtol=1e-6, atol=0)
    inside = mask[np.clip(got.xy[:, 1].astype(int), 0, h - 1), np.clip(got.xy[:, 0].astype(int), 0, w - 1)]
    assert inside.mean() > 0.9
    unmasked = tf.detect_corners(img, max_corners=MAX_CORNERS, octaves=2)
    assert len(unmasked.xy) > len(got.xy)


def test_detect_corners_finds_checker():
    img = np.zeros((64, 64), np.float32)
    img[16:48, 16:48] = 1.0  # a bright square: 4 strong corners
    got = tf.detect_corners(img, max_corners=8, min_distance=3, octaves=1)
    want = jf.detect_corners(img, max_corners=8, min_distance=3, octaves=1)
    np.testing.assert_allclose(got.xy, want.xy, atol=1e-6)
    found = {tuple(np.round(p).astype(int)) for p in got.xy}
    for target in [(16, 16), (48, 16), (16, 48), (48, 48)]:
        assert any(abs(f[0] - target[0]) <= 2 and abs(f[1] - target[1]) <= 2 for f in found), (target, found)


def test_extract_patches(scene, corners):
    _, _, _, raw = scene
    xy = np.concatenate([corners[0].xy, [[1.5, 60.0], [158.7, 2.2]]]).astype(np.float32)  # two over the edge
    want = np.asarray(jf.extract_patches(jnp.asarray(raw[0]), jnp.asarray(xy)))
    got = tf.extract_patches(torch.from_numpy(raw[0]), torch.from_numpy(xy)).numpy()
    assert got.shape == (len(xy), 121)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("pair", [(0, 1), (1, 3)])
def test_epipolar_proximity(scene, corners, pair):
    rig, trig, _, _ = scene
    a, b = pair
    (ja, ta), (jb, tb) = cams32(rig, trig, a), cams32(rig, trig, b)
    xa, xb = corners[a].xy.astype(np.float32), corners[b].xy.astype(np.float32)
    want = np.asarray(jf.epipolar_proximity(ja, jb, jnp.asarray(xa), jnp.asarray(xb), 1.0, 100.0))
    got = tf.epipolar_proximity(ta, tb, torch.from_numpy(xa), torch.from_numpy(xb), 1.0, 100.0).numpy()
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pair", [(0, 1), (0, 2), (2, 3)])
def test_camera_overlap(scene, pair):
    rig, trig, _, _ = scene
    (ja, ta), (jb, tb) = cams32(rig, trig, pair[0]), cams32(rig, trig, pair[1])
    assert tf.camera_overlap(ta, tb) == jf.camera_overlap(ja, jb) > 0.5


def test_match_pair(scene, corners):
    rig, trig, grays, _ = scene
    (ja, ta), (jb, tb) = cams32(rig, trig, 0), cams32(rig, trig, 3)
    want = jf.match_pair(ja, jb, grays[0], grays[3], corners[0], corners[3], 1.0, 100.0)
    got = tf.match_pair(ta, tb, torch.from_numpy(grays[0]), torch.from_numpy(grays[3]), corners[0], corners[3],
                        1.0, 100.0)
    assert len(want[0]) > 30
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=2e-6)


def test_match_corners(scene):
    rig, trig, grays, _ = scene
    want = jf.match_corners(rig.subset([0, 1, 2]), grays[:3], max_corners=MAX_CORNERS, min_depth=1.0,
                            max_depth=100.0)
    got = tf.match_corners(trig.subset([0, 1, 2]), grays[:3], max_corners=MAX_CORNERS, min_depth=1.0, max_depth=100.0)
    assert list(got["images"]) == list(want["images"])
    for k, pts in want["images"].items():
        np.testing.assert_allclose([[p["x"], p["y"]] for p in got["images"][k]],
                                   [[p["x"], p["y"]] for p in pts], rtol=0, atol=1e-5)
    assert len(got["all_matches"]) == len(want["all_matches"]) == 3
    for g, w in zip(got["all_matches"], want["all_matches"]):
        assert (g["image1"], g["image2"]) == (w["image1"], w["image2"])
        assert [(m["idx1"], m["idx2"]) for m in g["matches"]] == [(m["idx1"], m["idx2"]) for m in w["matches"]]
        np.testing.assert_allclose([m["score"] for m in g["matches"]], [m["score"] for m in w["matches"]],
                                   rtol=0, atol=2e-6)
    assert sum(len(m["matches"]) for m in got["all_matches"]) > 100
