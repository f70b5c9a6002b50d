"""The port's rig builders and analytic scenes (render/synthetic.py) against
the JAX package's, on the same arguments.

Tolerances: every camera field of every rig builder within 1e-12 (both
build on the host in float64); renders within 1e-5 in color (the finest
octave's sine arguments reach O(100), where a float32 ulp is ~1e-5) and
1e-6 relative in disparity.
"""

import numpy as np
import pytest
import torch

from facebook360_dep_tpu.render import synthetic as jsyn
from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.render import synthetic as tsyn

import torch_parity  # noqa: F401  (two torch threads per worker)

RIG_ATOL = 1e-12
COLOR_ATOL = 1e-5
DISP_RTOL = 1e-6

BUILDERS = {
    "outward_ring": lambda m: m.make_outward_ring_rig(6, (64, 48), ring_radius=0.25),
    "ftheta_ring": lambda m: m.make_ftheta_ring_rig(5, 0.33, (60, 80), distortion=m.PRODUCTION_FTHETA_DISTORTION),
    "ftheta_ring_no_top": lambda m: m.make_ftheta_ring_rig(4, 0.2, (3360, 2160), image_circle_radius_px=900.0,
                                                           circle_fov_deg=180.0, add_top=False),
    "dodecahedron": lambda m: m.make_polyhedron_rig("dodecahedron", 0.25, (40, 52)),
    "icosahedron": lambda m: m.make_polyhedron_rig("icosahedron", 0.3, (40, 52),
                                                   distortion=m.PRODUCTION_FTHETA_DISTORTION),
}


def _assert_rig_equal(trig, jrig):
    assert trig.ids == jrig.ids and trig.groups == jrig.groups
    got = tcam.camera_to_numpy(trig.cameras)
    for field in jrig.cameras._fields:
        want = np.asarray(getattr(jrig.cameras, field))
        have = np.asarray(getattr(got, field))
        assert have.shape == want.shape, field
        np.testing.assert_allclose(have, want, rtol=0, atol=RIG_ATOL, err_msg=field)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_rig_builder_equals_jax(name):
    trig, jrig = BUILDERS[name](tsyn), BUILDERS[name](jsyn)
    _assert_rig_equal(trig, jrig)
    assert trig.cameras.position.dtype == torch.float64


def test_constants_equal_jax():
    assert tsyn.PRODUCTION_FTHETA_DISTORTION == jsyn.PRODUCTION_FTHETA_DISTORTION
    assert np.array_equal(tsyn.ICOSAHEDRON_VERTS, jsyn.ICOSAHEDRON_VERTS)
    assert np.array_equal(tsyn.DODECAHEDRON_VERTS, jsyn.DODECAHEDRON_VERTS)
    assert tsyn._ftheta_focal((300, 400), 124.5, 166.667) == jsyn._ftheta_focal((300, 400), 124.5, 166.667)


def test_render_box_scene_matches_jax():
    jrig = jsyn.make_outward_ring_rig(4, (48, 36))
    trig = tsyn.make_outward_ring_rig(4, (48, 36))
    cj, dj = jsyn.render_box_scene(jrig, (48, 36), (5.0, 4.0, 3.0), seed=3)
    ct, dt = tsyn.render_box_scene(trig, (48, 36), (5.0, 4.0, 3.0), seed=3)
    assert ct.shape == (4, 36, 48, 3) and torch.isfinite(dt).all()
    np.testing.assert_allclose(ct.numpy(), cj, rtol=0, atol=COLOR_ATOL)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=DISP_RTOL)


def test_render_sphere_scene_on_ftheta_rig_matches_jax():
    """The production FTHETA shape (distorted, with the top camera) renders
    as the JAX package renders it; outside the image circle both give NaN
    or the same values."""
    jrig = jsyn.make_ftheta_ring_rig(3, 0.33, (40, 26), distortion=jsyn.PRODUCTION_FTHETA_DISTORTION)
    trig = tsyn.make_ftheta_ring_rig(3, 0.33, (40, 26), distortion=tsyn.PRODUCTION_FTHETA_DISTORTION)
    cj, dj = jsyn.render_sphere_scene(jrig, (40, 26))
    ct, dt = tsyn.render_sphere_scene(trig, (40, 26))
    assert np.array_equal(np.isnan(dj), np.isnan(dt.numpy()))
    ok = ~np.isnan(dj)
    np.testing.assert_allclose(ct.numpy()[ok], cj[ok], rtol=0, atol=COLOR_ATOL)
    np.testing.assert_allclose(dt.numpy()[ok], dj[ok], rtol=DISP_RTOL)


@pytest.mark.parametrize("scene", ["sphere", "box"])
def test_ground_truth_equirect_matches_jax(scene):
    cj, dj = jsyn.ground_truth_equirect(None, 64, 32, scene, 5.0, (6.0, 6.0, 3.0), seed=9)
    ct, dt = tsyn.ground_truth_equirect(None, 64, 32, scene, 5.0, (6.0, 6.0, 3.0), seed=9)
    assert ct.shape == (32, 64, 3) and dt.shape == (32, 64)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=0, atol=COLOR_ATOL)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=DISP_RTOL)
    if scene == "sphere":
        np.testing.assert_allclose(dt.numpy(), 0.2, rtol=1e-6)


@pytest.mark.parametrize("scene", ["sphere", "box"])
def test_render_ods_equirect_matches_jax(scene):
    lj, rj = jsyn.render_ods_equirect(64, 32, 0.032, scene)
    lt, rt = tsyn.render_ods_equirect(64, 32, 0.032, scene)
    np.testing.assert_allclose(lt.numpy(), lj, rtol=0, atol=COLOR_ATOL)
    np.testing.assert_allclose(rt.numpy(), rj, rtol=0, atol=COLOR_ATOL)
    assert np.abs(lt.numpy() - rt.numpy()).max() > 1e-3  # the eyes differ


def test_ray_box_depth_matches_jax():
    import jax.numpy as jnp

    rng = np.random.RandomState(5)
    d = rng.randn(500, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:5, 0] = 0.0  # axis-parallel rays take the 1e-12 guard
    o = (0.5 * rng.randn(500, 3)).astype(np.float32)
    want = np.asarray(jsyn.ray_box_depth(jnp.asarray(o), jnp.asarray(d), (6.0, 5.0, 3.0), (0.1, 0.0, -0.2)))
    got = tsyn.ray_box_depth(torch.from_numpy(o), torch.from_numpy(d), (6.0, 5.0, 3.0), (0.1, 0.0, -0.2))
    np.testing.assert_allclose(got.numpy(), want, rtol=DISP_RTOL)
