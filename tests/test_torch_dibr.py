"""The port's DIBR renderer (facebook360_dep_tpu_torch/render/dibr.py)
against the JAX package's: view directions and cube/equirect mappings
(including ties on exact cube edges and corners), the ODS warp, the
z-buffer splat and hole fill, the accumulate/resolve chain, and render_view
in cube, equirect and ODS modes on tests/test_render.py's 4-camera 48x36
sphere scene. float32 inputs on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facebook360_dep_tpu.render import dibr as jd
from facebook360_dep_tpu.render import synthetic as jsyn
from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.render import dibr as td

from torch_parity import f32, port_rig, tt


def _edge_dirs():
    """Directions on exact cube edges and corners (ties in |v|), axis
    directions with zero components (sign 0), and random directions."""
    ties = [[1, 1, 0], [-1, 1, 0], [1, -1, 0], [0, 1, 1], [0, -1, -1], [1, 0, -1], [-1, 0, 1],
            [1, 1, 1], [-1, -1, -1], [1, -1, 1], [-1, 1, -1], [0.5, 0.5, 0.5],
            [1, 0, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1], [0, 0, 0]]
    rnd = np.random.RandomState(0).normal(size=(200, 3))
    return f32(np.concatenate([ties, rnd]))


def test_dir_to_cube_ties_signs_and_truncation():
    """First maximum on ties (torch.argmax = jnp.argmax), sign(0) = 0, and
    the renderer's int conversion truncating toward zero at face edges."""
    v = _edge_dirs()
    s = 16
    jf, jx, jy = (np.asarray(a) for a in jd.dir_to_cube(jnp.asarray(v), s))
    tf, tx, ty = (a.numpy() for a in td.dir_to_cube(tt(v), s))
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tx, jx, atol=1e-6 * s)
    np.testing.assert_allclose(ty, jy, atol=1e-6 * s)
    # the flat target index of each direction, as the splat computes it
    jidx = (jf * s + np.clip(jy.astype(np.int32), 0, s - 1)) * s + np.clip(jx.astype(np.int32), 0, s - 1)
    tidx, ok = td.Target("cube", face_size=s).project(tt(v))
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    assert ok.all()
    # truncation toward zero for negative coordinates
    assert torch.equal(torch.tensor([-0.7, -1.5, 2.9]).to(torch.int32), torch.tensor([0, -1, 2], dtype=torch.int32))


@pytest.mark.parametrize("face_size", [5, 16])
def test_cube_and_equirect_dirs(face_size):
    np.testing.assert_allclose(td.cube_dirs(face_size).numpy(), np.asarray(jd.cube_dirs(face_size)), atol=1e-6)
    w, h = 4 * face_size, 2 * face_size
    got = td.equirect_dirs(w, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(jd.equirect_dirs(w, h)), atol=1e-6)
    pts = f32(got.numpy() * np.random.RandomState(face_size).uniform(0.5, 9.0, (h, w, 1)))
    jx, jy = jd.world_to_equirect(jnp.asarray(pts), w, h)
    tx, ty = td.world_to_equirect(tt(pts), w, h)
    # coordinates are O(w) px: 1e-6 relative
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6 * w)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6 * h)


@pytest.mark.parametrize("ipd", [0.032, -0.032, 0.0])
def test_ods_functions(ipd):
    """Eye offsets are O(1e-2) m, points O(1) m: 1e-6 absolute."""
    rng = np.random.RandomState(3)
    p = f32(rng.uniform(-5, 5, (256, 3)))
    p[:4] = [[1e-3, 0, 5.0], [0, 1e-3, -5.0], [0.3, 0.1, 0.0], [2.0, -1.0, 0.5]]
    lat = f32(rng.uniform(-np.pi / 2, np.pi / 2, 64))
    np.testing.assert_allclose(td.ods_ipd(tt(lat), ipd).numpy(), np.asarray(jd.ods_ipd(jnp.asarray(lat), ipd)),
                               atol=1e-7)
    np.testing.assert_allclose(td.ods_eye_offset(tt(p), ipd).numpy(), np.asarray(jd.ods_eye_offset(p, ipd)),
                               atol=1e-6)
    warped = td.ods_warp(tt(p), ipd)
    np.testing.assert_allclose(warped.numpy(), np.asarray(jd.ods_warp(jnp.asarray(p), ipd)), atol=1e-6)
    back = f32(warped.numpy())
    np.testing.assert_allclose(td.ods_unwarp(tt(back), ipd).numpy(), np.asarray(jd.ods_unwarp(jnp.asarray(back), ipd)),
                               atol=1e-6)


def test_splat_and_fill_holes():
    """Scatter-min is order-free (exact); the fill crosses the stacked
    cubemap's face seams along rows, as the JAX package's does."""
    rng = np.random.RandomState(4)
    n = 12 * 6
    idx = rng.randint(0, n, 300).astype(np.int64)
    dist = f32(rng.uniform(1, 9, 300))
    valid = rng.rand(300) > 0.3
    dist[:5] = np.nan
    valid[:5] = False
    want = np.asarray(jd._splat_depth(jnp.asarray(idx), jnp.asarray(dist), jnp.asarray(valid), n))
    got = td._splat_depth(torch.from_numpy(idx), tt(dist), torch.from_numpy(valid), n).numpy()
    np.testing.assert_array_equal(got, want)
    z = f32(rng.uniform(1, 9, (24, 4)))
    z[rng.rand(24, 4) > 0.4] = np.inf
    z[3:6] = np.inf  # a seam between faces 0 and 1 of a face-4 cubemap
    np.testing.assert_array_equal(td._fill_holes(tt(z)).numpy(), np.asarray(jd._fill_holes(jnp.asarray(z))))


def test_accumulate_resolve_chain():
    rng = np.random.RandomState(5)
    colors = f32(rng.rand(3, 6, 7, 3))
    cones = f32(rng.rand(3, 6, 7))
    cones[0, :2] = 0.0
    cones[:, 0, 0] = 0.0
    disp = f32(rng.uniform(0, 1.2, 9))
    np.testing.assert_allclose(td.exp_alpha(tt(cones)).numpy(), np.asarray(jd.exp_alpha(jnp.asarray(cones))),
                               rtol=1e-6)
    np.testing.assert_allclose(td.resolve_fade(disp).numpy(), np.asarray(jd.resolve_fade(jnp.asarray(disp))),
                               rtol=1e-6)
    for fade in (1.0, 0.4):
        jrgb, ja = jd.accumulate_resolve(colors, cones, fade)
        trgb, ta = td.accumulate_resolve(tt(colors), tt(cones), fade)
        np.testing.assert_allclose(trgb.numpy(), np.asarray(jrgb), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5)


@pytest.fixture(scope="module")
def scene():
    """tests/test_render.py:52-56's scene; one camera's disparity also gets a
    NaN patch, which must fail that camera's occlusion test."""
    rig = jsyn.make_test_rig(num_cameras=4, resolution=(48, 36), ring_radius=0.2)
    colors, gt = jsyn.render_sphere_scene(rig, (48, 36), radius=5.0)
    holed = f32(gt).copy()
    holed[1, 10:20, 5:30] = np.nan
    return rig, port_rig(tcam, rig), f32(colors), f32(gt), holed


def _render_both(scene, disparity, mode, ipd=0.0):
    jrig, trig, colors, _, _ = scene
    if mode == "cube":
        want = jd.render_cubemap(jrig, colors, disparity, [0.0, 0.0, 0.0], 24)
        got = td.render_cubemap(trig, tt(colors), tt(disparity), [0.0, 0.0, 0.0], 24)
    else:
        want = jd.render_equirect(jrig, colors, disparity, [0.0, 0.0, 0.0], 64, 32, ipd=ipd)
        got = td.render_equirect(trig, tt(colors), tt(disparity), [0.0, 0.0, 0.0], 64, 32, ipd=ipd)
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


@pytest.mark.parametrize("mode,ipd,holes", [("cube", 0.0, False), ("cube", 0.0, True), ("equirect", 0.0, False),
                                            ("equirect", 0.016, False), ("equirect", -0.016, True)])
def test_render_view_matches_jax(scene, mode, ipd, holes):
    """Alpha agrees on >= 99.5% of pixels (a splat index may flip where a
    projected coordinate lands within an ulp of a pixel edge), color to
    1e-4 and disparity to rtol 1e-5 where both have alpha."""
    disparity = scene[4] if holes else scene[3]
    (jc, jdisp, ja), (tc, tdisp, ta) = _render_both(scene, disparity, mode, ipd)
    assert tc.shape == jc.shape and tdisp.shape == jdisp.shape and ta.shape == ja.shape
    assert ja.mean() > 0.1
    assert (ta == ja).mean() >= 0.995
    both = ta & ja
    np.testing.assert_allclose(tc[both], jc[both], atol=1e-4)
    np.testing.assert_allclose(tdisp[both], jdisp[both], rtol=1e-5)
    assert np.isnan(tdisp[~ta]).all() and (tc[~ta] == 0).all()
