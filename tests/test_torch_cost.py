"""The port's matching cost (facebook360_dep_tpu_torch/ops/cost.py) against
the JAX package's XLA path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facebook360_dep_tpu.core import camera as jcam
from facebook360_dep_tpu.depth import pipeline as jpipe
from facebook360_dep_tpu.depth import solver as jsolver
from facebook360_dep_tpu.ops import cost as jcost
from facebook360_dep_tpu.render import synthetic as jsyn
from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.depth import pipeline as tpipe
from facebook360_dep_tpu_torch.depth import solver as tsolver
from facebook360_dep_tpu_torch.ops import cost as tcost

from torch_parity import f32, jax_f32, port_rig, rel_err, ring_rig, tt


@pytest.fixture(scope="module")
def contexts():
    """Level contexts of both packages on one mixed-type distorted rig."""
    rig = jcam.normalize_rig(ring_rig(jcam, "", n=4, resolution=(48, 36), mixed=True))
    colors, gt = jsyn.render_sphere_scene(rig, (48, 36), radius=5.0)
    colors = f32(colors)
    jfov = jpipe.generate_fov_masks(rig, (36, 48))
    trig = port_rig(tcam, rig)
    jctx = jsolver.make_level_context(rig, rig, colors, jfov, full_height=36)
    tctx = tsolver.make_level_context(trig, trig, tt(colors), tpipe.generate_fov_masks(trig, (36, 48)), full_height=36)
    return jctx, tctx, f32(np.nan_to_num(gt, nan=1e-4))


def test_probe_disparities_identical():
    np.testing.assert_array_equal(tcost.probe_disparities(150, 0.01, 1.0),
                                  np.asarray(jcost.probe_disparities(150, 0.01, 1.0)))


def test_dst_ray_dirs():
    cams = jax_f32(jcam.normalize_rig(ring_rig(jcam, "", n=4, mixed=True)).cameras)
    tc = tcam.camera_from_numpy(cams)
    for i in range(4):
        want = np.asarray(jcost.dst_ray_dirs(jax.tree.map(lambda a: a[i], cams), 36, 48))
        np.testing.assert_allclose(tcost.dst_ray_dirs(tc.index(i), 36, 48).numpy(), want, atol=2e-6)
    batched = tcost.dst_ray_dirs(tc, 36, 48)
    assert torch.equal(batched[2], tcost.dst_ray_dirs(tc.index(2), 36, 48))


@pytest.mark.parametrize("disparity", ["map", 0.25])
def test_reproject_rays(disparity):
    """Scalar and map hypotheses; coords agree to float32 ulps of O(50) px."""
    cams = jax_f32(jcam.normalize_rig(ring_rig(jcam, "", n=4, mixed=True)).cameras)
    tc = tcam.camera_from_numpy(cams)
    cam0 = jax.tree.map(lambda a: a[0], cams)
    rays = np.asarray(jcost.dst_ray_dirs(cam0, 36, 48))
    d = disparity
    if disparity == "map":
        d = f32(np.random.RandomState(0).rand(36, 48) * 0.5)
        d[0, :3] = [0.0, -0.1, np.nan]  # invalid hypotheses
    for i in (1, 3):
        jc, jv = jcost.reproject_rays(cam0.position, jnp.asarray(rays), jax.tree.map(lambda a: a[i], cams),
                                      jnp.asarray(d), (36, 48))
        t_c, t_v = tcost.reproject_rays(tt(np.asarray(cam0.position)), tt(np.moveaxis(rays, -1, 0).copy()),
                                        tc.index(i), tt(d) if disparity == "map" else d, (36, 48))
        assert np.array_equal(t_v.numpy(), np.asarray(jv))
        ok = np.asarray(jv)
        np.testing.assert_allclose(t_c.numpy()[ok], np.asarray(jc)[ok], atol=1e-4, rtol=1e-5)


def test_per_src_ssd(contexts):
    """One source's biased/unbiased maps; the bias compensation's
    cancellation turns sampling ulps into up to 1e-4 relative."""
    jctx, tctx, gt = contexts
    cam_dst = jax.tree.map(lambda a: a[0], jctx.dst_cams)
    jb, ju, jv = jcost.per_src_ssd((cam_dst.position, jctx.dst_rays[0]), jax.tree.map(lambda a: a[2], jctx.src_cams),
                                   jctx.src_imgs[0], jctx.src_imgs[2], jnp.asarray(gt[0]))
    tb, tu, tv = tcost.per_src_ssd((tctx.dst_cams.position[0], tctx.dst_rays[0]), tctx.src_cams.index(2),
                                   tctx.src_imgs[0], tctx.src_imgs[2], tt(gt[0]))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    ok = np.asarray(jv)
    assert rel_err(tb.numpy()[ok], np.asarray(jb)[ok]).max() < 1e-5
    assert np.abs(tu.numpy()[ok] - np.asarray(ju)[ok]).max() < 1e-4 * max(1.0, np.abs(np.asarray(ju)).max())


def test_cost_for_disparity_split_gives_same_costs(contexts, monkeypatch):
    """On CPU both size branches (fused K3 twin / K1 then K2 twins) are one
    computation; the JAX XLA path agrees to the cancellation-amplified ulps."""
    jctx, tctx, gt = contexts
    cctx = tsolver._cost_ctx(tctx, 1)
    split = tcost.cost_for_disparity(cctx, tt(gt[1]))
    monkeypatch.setattr(tcost, "FUSED_MIN_PIXELS", 0)
    fused = tcost.cost_for_disparity(cctx, tt(gt[1]))
    assert torch.equal(split[0], fused[0]) and torch.equal(split[1], fused[1])
    j_cost, j_conf = jcost.cost_for_disparity(jsolver._cost_ctx(jctx, 1), jnp.asarray(gt[1]))
    j_cost = np.asarray(j_cost)
    assert np.array_equal(split[0].numpy() >= 1e30, j_cost >= 1e30)
    ok = j_cost < 1e30
    assert rel_err(split[0].numpy()[ok], j_cost[ok]).max() < 1e-4
    np.testing.assert_array_equal(split[1].numpy(), np.asarray(j_conf))


def test_brute_force_disparity(contexts):
    """150-hypothesis sweep with the strict < (first hypothesis wins ties).
    Near-tie costs may pick a neighbouring hypothesis on a few pixels."""
    jctx, tctx, _ = contexts
    j_d, j_c, j_f = map(np.asarray, jcost.brute_force_disparity(
        jsolver._cost_ctx(jctx, 0), 1.0, 100.0, jctx.dst_fov_masks[0], jctx.dst_fg_masks[0], jctx.dst_bg_disp[0], False))
    t_d, t_c, t_f = (x.numpy() for x in tcost.brute_force_disparity(
        tsolver._cost_ctx(tctx, 0), 1.0, 100.0, tctx.dst_fov_masks[0], tctx.dst_fg_masks[0], tctx.dst_bg_disp[0], False))
    assert np.array_equal(np.isnan(t_d), np.isnan(j_d))
    assert np.array_equal(np.isnan(t_c), np.isnan(j_c))
    same = (t_d == j_d) | np.isnan(j_d)
    assert same.mean() > 0.98, same.mean()
    fin = same & np.isfinite(j_c)
    assert rel_err(t_c[fin], j_c[fin]).max() < 1e-4
