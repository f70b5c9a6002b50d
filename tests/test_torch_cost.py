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
from facebook360_dep_tpu_torch.ops import warp_cuda as wc

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
    computation; the JAX XLA path agrees to the cancellation-amplified ulps.
    The level context holds the interleaved stack the fused branch reads at
    every level."""
    jctx, tctx, gt = contexts
    cctx = tsolver.cost_context(tsolver.select_destinations(tctx, [1]))
    split = tcost.cost_for_disparity(cctx, tt(gt[1:2]))
    monkeypatch.setattr(tcost, "FUSED_MIN_PIXELS", 0)
    fused = tcost.cost_for_disparity(cctx, tt(gt[1:2]))
    assert torch.equal(split[0], fused[0]) and torch.equal(split[1], fused[1])
    j_cost, j_conf = jcost.cost_for_disparity(jsolver._cost_ctx(jctx, 1), jnp.asarray(gt[1]))
    j_cost = np.asarray(j_cost)
    assert np.array_equal(split[0][0].numpy() >= 1e30, j_cost >= 1e30)
    ok = j_cost < 1e30
    assert rel_err(split[0][0].numpy()[ok], j_cost[ok]).max() < 1e-4
    np.testing.assert_array_equal(split[1][0].numpy(), np.asarray(j_conf))


def test_brute_force_disparity(contexts):
    """150-hypothesis sweep with the strict < (first hypothesis wins ties).
    Near-tie costs may pick a neighbouring hypothesis on a few pixels."""
    jctx, tctx, _ = contexts
    j_d, j_c, j_f = map(np.asarray, jcost.brute_force_disparity(
        jsolver._cost_ctx(jctx, 0), 1.0, 100.0, jctx.dst_fov_masks[0], jctx.dst_fg_masks[0], jctx.dst_bg_disp[0], False))
    one = tsolver.select_destinations(tctx, [0])
    t_d, t_c, t_f = (x[0].numpy() for x in tcost.brute_force_disparity(
        tsolver.cost_context(one), 1.0, 100.0, one.dst_fov_masks, one.dst_fg_masks, one.dst_bg_disp, False))
    assert np.array_equal(np.isnan(t_d), np.isnan(j_d))
    assert np.array_equal(np.isnan(t_c), np.isnan(j_c))
    same = (t_d == j_d) | np.isnan(j_d)
    assert same.mean() > 0.98, same.mean()
    fin = same & np.isfinite(j_c)
    assert rel_err(t_c[fin], j_c[fin]).max() < 1e-4


@pytest.mark.parametrize("disparity", ["map", 0.25])
def test_reproject_to_src(disparity):
    """The dst unprojection plus reproject_rays: validity identical, coords
    to float32 ulps of O(50) px (as test_reproject_rays)."""
    cams = jax_f32(jcam.normalize_rig(ring_rig(jcam, "", n=4, mixed=True)).cameras)
    tc = tcam.camera_from_numpy(cams)
    d = disparity
    if disparity == "map":
        d = f32(np.random.RandomState(1).rand(36, 48) * 0.5)
        d[1, :3] = [0.0, -0.1, np.nan]
    for i, j in ((0, 1), (2, 3), (3, 0)):
        jc, jv = jcost.reproject_to_src(jax.tree.map(lambda a: a[i], cams), jax.tree.map(lambda a: a[j], cams),
                                        jnp.asarray(d), (36, 48), (30, 40))
        t_c, t_v = tcost.reproject_to_src(tc.index(i), tc.index(j), tt(d) if disparity == "map" else d,
                                          (36, 48), (30, 40))
        assert t_c.shape == (36, 48, 2) and np.array_equal(t_v.numpy(), np.asarray(jv))
        ok = np.asarray(jv)
        assert ok.mean() > 0.3
        np.testing.assert_allclose(t_c.numpy()[ok], np.asarray(jc)[ok], atol=1e-4, rtol=1e-5)


def _ssd_stacks(n, seed, ties=False):
    """Random (N, H, W) biased >= unbiased SSD stacks with every valid
    count from 0 to N; ``ties`` rounds the biased SSDs to a few levels."""
    rng = np.random.RandomState(seed)
    biased = f32(rng.rand(n, 24, 32) * 2.0)
    if ties:
        biased = f32(np.round(biased * 2.0) / 2.0)
    unbiased = f32(biased * rng.rand(n, 24, 32))
    valid = rng.rand(n, 24, 32) < np.linspace(0.0, 1.0, 32)[None, None, :]
    variance = f32(rng.rand(24, 32) * 1e-3)
    return biased, unbiased, valid, variance


@pytest.mark.parametrize("n,ties", [(2, False), (4, False), (6, False), (6, True)])
def test_combine_ssds_matches_jax(n, ties):
    """The sort-based combine against the JAX one: same FLT_MAX pixels and
    confidence, costs to float32 rounding (1e-6 relative: the prefix sums
    add in one order, XLA's cumsum may add in another)."""
    b, u, v, var = _ssd_stacks(n, seed=n + 10 * ties, ties=ties)
    j_cost, j_conf = map(np.asarray, jcost.combine_ssds(jnp.asarray(b), jnp.asarray(u), jnp.asarray(v),
                                                        jnp.asarray(var)))
    t_cost, t_conf = (x.numpy() for x in tcost.combine_ssds(tt(b), tt(u), tt(v), tt(var)))
    assert np.array_equal(t_cost >= 1e30, j_cost >= 1e30) and (t_cost >= 1e30).any() and (t_cost < 1e30).any()
    np.testing.assert_array_equal(t_conf, j_conf)
    ok = j_cost < 1e30
    assert rel_err(t_cost[ok], j_cost[ok]).max() < 1e-6


@pytest.mark.parametrize("n", [2, 4, 6, 9])
def test_combine_top2_equals_combine_ssds(n):
    """Without ties among the biased SSDs the two combines agree to float32
    rounding: combine_top2 takes the total of the unbiased SSDs less the
    dropped ones, whose cancellation costs a few ulps of the total, so the
    bound is 4 float32 ulps of the total, scaled as the cost is."""
    b, u, v, var = (tt(x) for x in _ssd_stacks(n, seed=30 + n))
    top2 = tcost.combine_top2(b, u, v, var)
    ssds = tcost.combine_ssds(b, u, v, var)
    assert torch.equal(top2[1], ssds[1]) and torch.equal(top2[0] >= 1e30, ssds[0] >= 1e30)
    ok = ssds[0] < 1e30
    keep = torch.clamp(v.sum(0) - 2, min=1).to(torch.float32)
    total = torch.where(v, u, 0.0).sum(0) / (keep * keep) / ssds[1].clamp(min=tcost.MIN_VAR)
    bound = 4 * float(np.finfo(np.float32).eps) * total
    assert ((top2[0] - ssds[0]).abs() <= bound)[ok].all()


def test_combine_tie_rule():
    """The tie rule: where the second-worst biased SSD ties with a kept one,
    combine_top2 (and K2) drop the first index of the tie, combine_ssds (a
    stable ascending sort, as the JAX package's) the last."""
    biased = tt(np.array([3.0, 1.0, 1.0, 5.0], np.float32).reshape(4, 1, 1))  # 0 and 3 dropped by both
    unbiased = tt(np.array([0.3, 0.1, 0.7, 0.5], np.float32).reshape(4, 1, 1))
    valid = torch.ones(4, 1, 1, dtype=torch.bool)
    var = torch.ones(1, 1)
    # keep = 2: the sort keeps the two smallest (1 and 2, tied at 1.0) in either rule
    assert torch.allclose(tcost.combine_ssds(biased, unbiased, valid, var)[0], torch.tensor([[0.8 / 4]]))
    assert torch.allclose(tcost.combine_top2(biased, unbiased, valid, var)[0], torch.tensor([[0.8 / 4]]))
    biased = tt(np.array([1.0, 3.0, 3.0, 5.0], np.float32).reshape(4, 1, 1))  # worst 3; 1 and 2 tie for second
    ssds = tcost.combine_ssds(biased, unbiased, valid, var)[0]
    top2 = tcost.combine_top2(biased, unbiased, valid, var)[0]
    jc = np.asarray(jcost.combine_ssds(*(jnp.asarray(x.numpy()) for x in (biased, unbiased, valid, var)))[0])
    assert torch.allclose(ssds, torch.tensor([[(0.3 + 0.1) / 4]])) and np.allclose(jc, (0.3 + 0.1) / 4)  # keeps 1
    assert torch.allclose(top2, torch.tensor([[(0.3 + 0.7) / 4]]))  # keeps 2
