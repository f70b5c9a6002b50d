"""The port's per-level solver stages (facebook360_dep_tpu_torch/depth/solver.py)
against the JAX package's, on one mixed-type distorted rig.

Costs agree to ~1e-5 relative (float32 ulps amplified by the bias
compensation), so a running argmin over near-equal candidates can pick a
different one: decisions are compared by the share of identical pixels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facebook360_dep_tpu.core import camera as jcam
from facebook360_dep_tpu.depth import pipeline as jpipe
from facebook360_dep_tpu.depth import solver as js
from facebook360_dep_tpu.render import synthetic as jsyn
from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.depth import pipeline as tpipe
from facebook360_dep_tpu_torch.depth import solver as ts

from torch_parity import f32, port_rig, rel_err, ring_rig, tt

H, W = 36, 48


@pytest.fixture(scope="module")
def contexts():
    rig = jcam.normalize_rig(ring_rig(jcam, "", n=4, resolution=(W, H), ring_radius=0.3, mixed=True))
    colors, gt = jsyn.render_sphere_scene(rig, (W, H), radius=5.0)
    colors = f32(colors)
    trig = port_rig(tcam, rig)
    jctx = js.make_level_context(rig, rig, colors, jpipe.generate_fov_masks(rig, (H, W)), full_height=60)
    tctx = ts.make_level_context(trig, trig, tt(colors), tpipe.generate_fov_masks(trig, (H, W)), full_height=60)
    init = f32(np.nan_to_num(gt, nan=1e-4) * (1.0 + 0.04 * np.random.RandomState(0).randn(4, H, W)))
    return jctx, tctx, init


def _cfgs(**kw):
    kw = dict(dict(min_depth=1.0, max_depth=100.0, level=1, num_levels=3), **kw)
    return js.SolverConfig(**kw), ts.SolverConfig(**kw)


def _threefry_uniforms(key, d, p):
    """The JAX random_proposals draws (solver.py:232, 243, 252) as a (D, P, H, W) array."""
    out = []
    for k in jax.random.split(key, d):
        out.append([np.asarray(jax.random.uniform(kk, (H, W), jnp.float32)) for kk in jax.random.split(k, p)])
    return f32(out)


def test_make_level_context(contexts):
    jctx, tctx, _ = contexts
    assert tctx.dst2src == tuple(np.asarray(jctx.dst2src))
    assert np.array_equal(tctx.dst_fov_masks.numpy(), np.asarray(jctx.dst_fov_masks))
    np.testing.assert_allclose(tctx.src_variance.numpy(), np.asarray(jctx.src_variance), atol=1e-7)
    assert tctx.var_noise_floor == float(jctx.var_noise_floor)
    assert tctx.var_high_thresh == float(jctx.var_high_thresh)
    j_rays = np.moveaxis(np.asarray(jctx.dst_rays), -1, 1)
    t_rays = tctx.dst_rays.numpy()
    assert np.array_equal(np.isnan(t_rays), np.isnan(j_rays))
    np.testing.assert_allclose(t_rays, j_rays, atol=2e-6)


def test_brute_force_all(contexts):
    jctx, tctx, _ = contexts
    jc, tc = _cfgs(level=2)
    j_d = np.asarray(js.brute_force_all(jctx, jc)[0])
    t_d = ts.brute_force_all(tctx, tc)[0].numpy()
    assert np.array_equal(np.isnan(t_d), np.isnan(j_d))
    assert ((t_d == j_d) | np.isnan(j_d)).mean() > 0.98


def test_random_proposals_with_injected_threefry_draws(contexts):
    jctx, tctx, init = contexts
    # a narrow depth range around the sphere (disparity 0.2), a start far
    # from it, and every pixel active: many proposals are accepted
    jc, tc = _cfgs(num_random_proposals=2, min_depth=4.0)
    init = f32(init * 1.5)
    jctx = jctx._replace(var_noise_floor=jnp.float32(1e-9), var_high_thresh=jnp.float32(1e-9))
    tctx = tctx._replace(var_noise_floor=float(np.float32(1e-9)), var_high_thresh=float(np.float32(1e-9)))
    d = init.shape[0]
    inf, zero = np.full_like(init, np.inf), np.zeros_like(init)
    key = jax.random.PRNGKey(1)
    j_d, j_c, j_f = map(np.asarray, js.random_proposals(jctx, jc, jnp.asarray(init), jnp.asarray(inf),
                                                        jnp.asarray(zero), key))
    t_d, t_c, t_f = (x.numpy() for x in ts.random_proposals(
        tctx, tc, tt(init), tt(inf), tt(zero), uniforms=tt(_threefry_uniforms(key, d, 2))))
    # a proposal is lo + u * (hi - lo): XLA may fuse that into one FMA
    r = rel_err(t_d, j_d)
    same = r < 1e-6
    assert same.mean() > 0.97, same.mean()
    assert (t_d != init).mean() > 0.05
    ok = same & (j_c < 1e30)
    assert rel_err(t_c[ok], j_c[ok]).max() < 1e-4


def test_random_proposals_generator_is_seeded(contexts):
    _, tctx, init = contexts
    _, tc = _cfgs(num_random_proposals=1)
    inf, zero = tt(np.full_like(init, np.inf)), tt(np.zeros_like(init))
    a = ts.random_proposals(tctx, tc, tt(init), inf, zero, generator=torch.Generator().manual_seed(5))
    b = ts.random_proposals(tctx, tc, tt(init), inf, zero, generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        ts.random_proposals(tctx, tc, tt(init), inf, zero)


@pytest.mark.parametrize("proposals,axis_only", [(0, False), (2, False), (2, True)])
def test_ping_pong(contexts, proposals, axis_only):
    """Unseeded (9 candidates), seeded center (8) and the axis-only star."""
    jctx, tctx, init = contexts
    jc, tc = _cfgs(num_random_proposals=proposals, star_axis_only=axis_only)
    rng = np.random.RandomState(proposals)
    costs = f32(rng.rand(*init.shape) * 5.0) if proposals else np.full_like(init, np.inf)
    conf = f32(rng.rand(*init.shape))
    j_d, j_c, j_f = map(np.asarray, js.ping_pong(jctx, jc, *(jnp.asarray(a) for a in (init, costs, conf))))
    t_d, t_c, t_f = (x.numpy() for x in ts.ping_pong(tctx, tc, tt(init), tt(costs), tt(conf)))
    same = t_d == j_d
    assert same.mean() > 0.97, same.mean()
    assert (t_d != init).mean() > 0.05
    ok = same & np.isfinite(j_c) & (j_c < 1e30)
    assert rel_err(t_c[ok], j_c[ok]).max() < 1e-4


def test_handle_mismatches(contexts):
    """The XLA branch (solver.py:388-396): one-channel sampling of the
    disparity stack, far-end median of the mismatches."""
    jctx, tctx, init = contexts
    # no high-variance exemption: textured pixels may be replaced too
    jctx = jctx._replace(var_high_thresh=jnp.float32(1.0))
    tctx = tctx._replace(var_high_thresh=1.0)
    jc, tc = _cfgs(mismatches_start_level=1)
    disp = init.copy()
    disp[1, 10:20, 10:30] *= 1.8  # a block that disagrees with the other cameras
    disp[2, :4, :4] = np.nan
    j_d, j_m = map(np.asarray, js.handle_mismatches(jctx, jc, jnp.asarray(disp)))
    t_d, t_m = (x.numpy() for x in ts.handle_mismatches(tctx, tc, tt(disp)))
    assert j_m.sum() > 20  # the block was detected
    assert (t_m != j_m).mean() < 2e-3
    agree = (t_m == j_m)
    np.testing.assert_allclose(t_d[agree], j_d[agree], rtol=1e-6, equal_nan=True)


def test_filters_and_mask_fov(contexts):
    jctx, tctx, init = contexts
    for level in (0, 5):
        jc, tc = _cfgs(level=level)
        np.testing.assert_allclose(ts.spatial_bilateral(tctx, tc, tt(init)).numpy(),
                                   np.asarray(js.spatial_bilateral(jctx, jc, jnp.asarray(init))), rtol=2e-6)
    np.testing.assert_array_equal(ts.median_filter(tctx, tc, tt(init)).numpy(),
                                  np.asarray(js.median_filter(jctx, jc, jnp.asarray(init))))
    np.testing.assert_array_equal(ts.mask_fov(tctx, tt(init)).numpy(), np.asarray(js.mask_fov(jctx, jnp.asarray(init))))


def test_process_level_with_injected_draws(contexts):
    jctx, tctx, init = contexts
    jc, tc = _cfgs(num_random_proposals=2)
    key = jax.random.PRNGKey(3)
    j = jax.tree.map(np.asarray, js.process_level(jctx, jc, init_disparity=jnp.asarray(init), key=key))
    t = {k: v.numpy() for k, v in ts.process_level(
        tctx, tc, init_disparity=tt(init), uniforms=tt(_threefry_uniforms(key, 4, 2))).items()}
    assert set(t) == set(j)
    assert np.array_equal(np.isnan(t["disparity"]), np.isnan(j["disparity"]))
    fin = np.isfinite(j["disparity"])
    r = rel_err(t["disparity"][fin], j["disparity"][fin])
    assert np.median(r) < 1e-6 and (r < 1e-3).mean() > 0.95, (np.median(r), (r < 1e-3).mean())
    assert not t["mismatches"].any()
