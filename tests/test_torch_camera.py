"""The port's camera model (facebook360_dep_tpu_torch/core/camera.py) against
the JAX package's, all four camera types with nonzero distortion, float32."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facebook360_dep_tpu.core import camera as jcam
from facebook360_dep_tpu_torch.core import camera as tcam

from torch_parity import DISTORTION, TYPES, f32, jax_f32, ring_rig, tt

# float32 trig/sqrt differ by a few ulps between XLA and PyTorch; projected
# pixels are O(100) px and rays unit vectors, so 1e-4 px / 1e-5 are ~ulp scale
PIX_ATOL = 1e-3
RAY_ATOL = 2e-6


def _cams(type_name):
    jrig = ring_rig(jcam, type_name, n=3, resolution=(640, 480))
    return jax_f32(jrig.cameras), tcam.camera_from_numpy(jrig.cameras, dtype=torch.float32)


def _points(seed=0, n=200):
    rng = np.random.RandomState(seed)
    pts = rng.normal(size=(n, 3)) * np.asarray([2.0, 2.0, 1.0]) + np.asarray([0.0, 0.0, -2.5])
    return f32(pts)


@pytest.mark.parametrize("type_name", TYPES)
def test_make_camera_fields_match(type_name):
    """Host construction (orthonormalization, distortionMax root) is float64-identical."""
    kw = dict(type_code=getattr(jcam, type_name), position=[0.1, 0.2, 0.3],
              rotation=[[1, 0.01, 0], [-0.01, 1, 0], [0, 0, 1]], resolution=[640, 480],
              focal=[300, -300], distortion=DISTORTION[type_name])
    j = jcam.make_camera(**kw)
    t = tcam.make_camera(**kw)
    for name in jcam.Camera._fields:
        np.testing.assert_array_equal(np.asarray(getattr(t, name)), np.asarray(getattr(j, name)), err_msg=name)


@pytest.mark.parametrize("type_name", TYPES)
def test_pixel_sees_ray_dir(type_name):
    jc, tc = _cams(type_name)
    pts = _points()
    for i in range(3):
        jci = jax.tree.map(lambda a: a[i], jc)
        tci = tc.index(i)
        jpix, jvalid = jcam.sees(jci, jnp.asarray(pts))
        tpix, tvalid = tcam.sees(tci, tt(pts))
        np.testing.assert_allclose(tpix.numpy(), np.asarray(jpix), atol=PIX_ATOL, rtol=1e-5)
        assert np.array_equal(tvalid.numpy(), np.asarray(jvalid))
        pix = f32(np.asarray(jpix)[np.asarray(jvalid)])
        np.testing.assert_allclose(tcam.ray_dir(tci, tt(pix)).numpy(), np.asarray(jcam.ray_dir(jci, jnp.asarray(pix))),
                                   atol=RAY_ATOL)


def test_batched_cameras_broadcast_like_vmap():
    """A camera batch against a (1, ...) point batch equals per-camera calls
    (the port's stand-in for the JAX package's vmap)."""
    jrig = ring_rig(jcam, "", n=4, resolution=(320, 240), mixed=True)
    tc = tcam.camera_from_numpy(jrig.cameras, dtype=torch.float32)
    pts = tt(_points(1, 64)).reshape(8, 8, 3)
    pix, valid = tcam.sees(tc, pts[None])
    assert pix.shape == (4, 8, 8, 2) and valid.shape == (4, 8, 8)
    for i in range(4):
        p1, v1 = tcam.sees(tc.index(i), pts)
        assert torch.equal(pix[i], p1) and torch.equal(valid[i], v1)


@pytest.mark.parametrize("type_name", TYPES)
def test_distort_undistort_and_sensor_roundtrip(type_name):
    jc, tc = _cams(type_name)
    jc0 = jax.tree.map(lambda a: a[0], jc)
    r = f32(np.linspace(0.0, 1.2, 97))
    np.testing.assert_allclose(tcam.distort(tc.index(0), tt(r)).numpy(), np.asarray(jcam.distort(jc0, jnp.asarray(r))),
                               atol=1e-6)
    np.testing.assert_allclose(tcam.undistort(tc.index(0), tt(r)).numpy(),
                               np.asarray(jcam.undistort(jc0, jnp.asarray(r))), atol=2e-6)
    sensor = f32(np.random.RandomState(2).uniform(-0.6, 0.6, (50, 2)))
    sensor[0] = 0.0  # the degenerate center pixel
    np.testing.assert_allclose(tcam.sensor_to_camera(tc.index(0), tt(sensor)).numpy(),
                               np.asarray(jcam.sensor_to_camera(jc0, jnp.asarray(sensor))), atol=RAY_ATOL)
    v = _points(3, 50)
    np.testing.assert_allclose(tcam.camera_to_sensor(tc.index(0), tt(v)).numpy(),
                               np.asarray(jcam.camera_to_sensor(jc0, jnp.asarray(v))), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("type_name", TYPES)
def test_fov_and_image_circle(type_name):
    obj = dict(version=1, type=type_name, origin=[0, 0, 0], forward=[0, 0, -1], up=[0, 1, 0], right=[1, 0, 0],
               resolution=[400, 300], focal=[150, -150], id="c", fov=1.2, distortion=list(DISTORTION[type_name]))
    j, _, _ = jcam.camera_from_json(obj)
    t, _, _ = tcam.camera_from_json(obj)
    jc, tc = jax_f32(j), t.to(dtype=torch.float32)
    pts = _points(4, 300)
    assert np.array_equal(tcam.is_outside_fov(tc, tt(pts)).numpy(), np.asarray(jcam.is_outside_fov(jc, jnp.asarray(pts))))
    grid = f32(np.stack(np.meshgrid(np.arange(0, 400, 7) + 0.5, np.arange(0, 300, 7) + 0.5), -1))
    assert np.array_equal(tcam.is_outside_image_circle(tc, tt(grid)).numpy(),
                          np.asarray(jcam.is_outside_image_circle(jc, jnp.asarray(grid))))
    assert np.array_equal(tcam.is_outside_sensor(tc, tt(grid * 1.5 - 50)).numpy(),
                          np.asarray(jcam.is_outside_sensor(jc, jnp.asarray(grid * 1.5 - 50))))


def test_rescale_normalize():
    jrig = ring_rig(jcam, "", n=4, resolution=(640, 480), mixed=True)
    trig = tcam.Rig(tcam.camera_from_numpy(jrig.cameras), jrig.ids, jrig.groups)
    jn, tn = jcam.normalize_rig(jrig), tcam.normalize_rig(trig)
    for name in jcam.Camera._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tn.cameras, name)), np.asarray(getattr(jn.cameras, name)))
    assert torch.all(tn.cameras.resolution == 1)
    jr = jcam.rescale(jax.tree.map(lambda a: a[1], jrig.cameras), [320, 240])
    tr = tcam.rescale(trig.camera(1), [320, 240])
    for name in ("principal", "focal", "resolution"):
        np.testing.assert_array_equal(np.asarray(getattr(tr, name)), np.asarray(getattr(jr, name)))


def test_rig_json_roundtrip_both_ways(tmp_path):
    """The port's save_rig reads back through the JAX load_rig bit-identically,
    and the JAX save_rig through the port's."""
    jrig = ring_rig(jcam, "", n=4, resolution=(640, 480), mixed=True)
    trig = tcam.Rig(tcam.camera_from_numpy(jrig.cameras), jrig.ids, ("a", "", "b", ""))
    tcam.save_rig(tmp_path / "t.json", trig, comments=["port"])
    back = jcam.load_rig(tmp_path / "t.json")
    assert back.ids == trig.ids and back.groups == trig.groups
    for name in jcam.Camera._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back.cameras, name)), np.asarray(getattr(trig.cameras, name)))
    jcam.save_rig(tmp_path / "j.json", jrig._replace(groups=trig.groups))
    assert json.loads((tmp_path / "j.json").read_text())["cameras"] == json.loads((tmp_path / "t.json").read_text())["cameras"]
    t2 = tcam.load_rig(tmp_path / "j.json")
    for name in jcam.Camera._fields:
        np.testing.assert_array_equal(np.asarray(getattr(t2.cameras, name)), np.asarray(getattr(jrig.cameras, name)))


def test_destination_filtering_and_index_map():
    jrig = ring_rig(jcam, "", n=4, mixed=True)
    trig = tcam.Rig(tcam.camera_from_numpy(jrig.cameras), jrig.ids, jrig.groups)
    jd = jcam.filter_destinations(jrig, "cam2,nope,cam0")
    td = tcam.filter_destinations(trig, "cam2,nope,cam0")
    assert td.ids == jd.ids == ("cam2", "cam0")
    np.testing.assert_array_equal(td.cameras.position.numpy(), np.asarray(jd.cameras.position))
    np.testing.assert_array_equal(tcam.map_src_to_dst_indexes(trig, td), jcam.map_src_to_dst_indexes(jrig, jd))
    assert tcam.filter_destinations(trig, "") is trig
