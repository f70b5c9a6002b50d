"""The CUDA kernels' plain twins (facebook360_dep_tpu_torch/ops/warp_cuda.py)
against the Pallas kernels they replace, run in interpret mode as
tests/test_warp_pallas.py runs them, and against the JAX package's exact XLA
path. The kernels themselves run only on a GPU: tests/test_torch_cuda.py
and chip_smoke.py hold them against these twins there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facebook360_dep_tpu.core import camera as jcam
from facebook360_dep_tpu.ops import cost as jcost
from facebook360_dep_tpu.ops import sampling as jsamp
from facebook360_dep_tpu.ops import warp_pallas
from facebook360_dep_tpu.render import synthetic as jsyn
from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.ops import cost as tcost
from facebook360_dep_tpu_torch.ops import warp_cuda as wc

from torch_parity import f32, jax_f32, rel_err, ring_rig, tt

FLT_MAX = float(np.finfo(np.float32).max)


def _scene(w=64, h=48, n=4, seed=0):
    """A ring of all four camera types with distortion, rendered by the JAX
    package; destination 0's rays and a noisy candidate disparity map."""
    rig = ring_rig(jcam, "", n=n, resolution=(w, h), mixed=True)
    colors, gt = jsyn.render_sphere_scene(rig, (w, h), radius=5.0)
    cams = jax_f32(jcam.normalize_rig(rig).cameras)
    cam0 = jax.tree.map(lambda a: a[0], cams)
    rays = np.asarray(jcost.dst_ray_dirs(cam0, h, w))  # (H, W, 3)
    noise = 1.0 + 0.05 * (2.0 * np.random.RandomState(seed).rand(h, w) - 1.0)
    disp = f32(np.nan_to_num(gt[0], nan=1e-4) * noise)
    planar = f32(np.moveaxis(colors, -1, 1))  # (N, 3, H, W)
    return dict(cams=cams, cam0=cam0, rays=f32(rays), disp=disp, planar=planar, colors=f32(colors),
                params=np.asarray(warp_pallas.pack_camera_params_traced(cams)))


def _k1_args(s, src=None):
    return (tt(s["planar"] if src is None else src), tt(s["params"]), tt(np.asarray(s["cam0"].position)),
            tt(s["disp"]), tt(np.moveaxis(s["rays"], -1, 0).copy()))


def test_pack_camera_params_matches_jax_layout():
    s = _scene()
    tc = tcam.camera_from_numpy(s["cams"])
    np.testing.assert_array_equal(wc.pack_camera_params(tc).numpy(), s["params"])
    back = wc.unpack_camera_params(tt(s["params"]))
    for name in tcam.Camera._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, name), np.float32),
                                      np.asarray(getattr(tc, name), np.float32), err_msg=name)


def test_k1_twin_vs_pallas_v4_interpret():
    """B1 quantizes coordinates to 1/256 px (warp_pallas.py:551-558), so its
    samples sit up to 1/512 px from the twin's in x and in y: the bound is
    2/512 px times the image's largest step between neighbours. Validity
    must agree (B1's clipped flag is never set: the window covers the whole
    source), up to the Cephes-vs-libm atan at razor edges."""
    s = _scene()
    sampled, valid = wc.project_sample(*_k1_args(s))
    p_s, p_v, p_c = warp_pallas.project_sample_planar_v4(
        jnp.asarray(s["planar"]), jnp.asarray(s["params"]), s["cam0"].position, jnp.asarray(s["disp"]),
        jnp.asarray(np.moveaxis(s["rays"], -1, 0)), interpret=True, ww_max=1024, wh_max=1024)
    p_s, p_v, p_c = map(np.asarray, (p_s, p_v, p_c))
    assert p_c.sum() == 0
    v = valid.numpy()
    assert (v != (p_v > 0.5)).mean() < 1e-3
    assert v[1:].mean() > 0.3  # the other sources see much of dst 0
    step = max(np.abs(np.diff(s["planar"], axis=a)).max() for a in (2, 3))
    both = v & (p_v > 0.5)
    err = np.abs(sampled.numpy() - p_s).transpose(1, 0, 2, 3)[:, both]
    assert err.max() <= 2.0 / 512.0 * step + 1e-6, (err.max(), step)
    assert np.all(sampled.numpy()[:, :, ~v.any(0)] == 0.0)


def test_k1_twin_vs_xla_path():
    """Twin == cost.reproject_rays + sampling.bilinear_sample of the JAX
    package per source. The coordinates (O(60) px) agree to float32 ulps,
    which moves a sample by up to ~1e-6 on colors in [0,1]: 5e-6."""
    s = _scene(seed=1)
    sampled, valid = wc.project_sample(*_k1_args(s))
    for i in range(len(s["planar"])):
        csrc = jax.tree.map(lambda a: a[i], s["cams"])
        coords, jv = jcost.reproject_rays(s["cam0"].position, jnp.asarray(s["rays"]), csrc, jnp.asarray(s["disp"]), (48, 64))
        ref = np.asarray(jsamp.bilinear_sample(jnp.asarray(s["colors"][i]), coords))
        jv = np.asarray(jv)
        assert (valid[i].numpy() != jv).mean() < 1e-3
        both = valid[i].numpy() & jv
        np.testing.assert_allclose(np.moveaxis(sampled[i].numpy(), 0, -1)[both], ref[both], atol=5e-6)


def test_k1_twin_one_channel_nan_taps():
    """C=1 over a NaN-holding disparity stack (handle_mismatches): a NaN tap
    propagates; invalid pixels are 0. Coordinates that differ by an ulp can
    put a tap on either side of the NaN block's edge, so the NaN patterns
    agree but for a sliver (<1%)."""
    s = _scene(seed=2)
    stack = f32(np.random.RandomState(3).rand(4, 1, 48, 64) * 0.2 + 0.1)
    stack[:, :, 10:20, 20:30] = np.nan
    sampled, valid = wc.project_sample(*_k1_args(s, stack))
    for i in range(4):
        csrc = jax.tree.map(lambda a: a[i], s["cams"])
        coords, jv = jcost.reproject_rays(s["cam0"].position, jnp.asarray(s["rays"]), csrc, jnp.asarray(s["disp"]), (48, 64))
        ref = np.asarray(jsamp.bilinear_sample(jnp.asarray(stack[i, 0]), coords))
        both = valid[i].numpy() & np.asarray(jv)
        got, want = sampled[i, 0].numpy()[both], ref[both]
        assert np.isnan(got).any()
        assert (np.isnan(got) != np.isnan(want)).mean() < 0.01
        fin = np.isfinite(got) & np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], atol=5e-6)


def _k2_inputs(seed=11, n=5, c=3, h=40, w=300):
    rng = np.random.RandomState(seed)
    return (f32(rng.rand(n, c, h, w)), rng.rand(n, h, w) > 0.2, f32(rng.rand(c, h, w)),
            f32(rng.rand(h, w) * 1e-3), 2)


def test_k2_twin_vs_pallas_ssd_combine_interpret():
    """B2 multiplies by validity and takes 1/cnt once; 1e-4 relative as
    tests/test_warp_pallas.py holds B2 to the XLA chain."""
    sampled, valid, dst, var, exclude = _k2_inputs()
    cost, conf = wc.ssd_combine(tt(sampled), tt(valid), tt(dst), tt(var), exclude)
    p_cost, p_conf = warp_pallas.ssd_combine(jnp.asarray(sampled), jnp.asarray(valid, np.float32), jnp.asarray(dst),
                                             jnp.asarray(var), exclude, min_keep=1, interpret=True)
    cost, p_cost = cost.numpy(), np.asarray(p_cost)
    assert np.array_equal(cost >= 1e30, p_cost >= 1e30)
    ok = cost < 1e30
    assert rel_err(cost[ok], p_cost[ok]).max() < 1e-4
    np.testing.assert_allclose(conf.numpy(), np.asarray(p_conf), rtol=1e-6)


@pytest.mark.parametrize("c", [1, 3])
def test_k2_twin_vs_xla_chain(c):
    """Twin == cost.ssd_planar + combine_top2 of the JAX package: same sums
    up to XLA's reduction order over sources and channels (1e-5 relative)."""
    sampled, valid, dst, var, exclude = _k2_inputs(seed=12 + c, c=c)
    cost, conf = wc.ssd_combine(tt(sampled), tt(valid), tt(dst), tt(var), exclude)
    b, u, v = jcost.ssd_planar(jnp.asarray(np.moveaxis(dst, 0, -1)), jnp.asarray(sampled), jnp.asarray(valid))
    v = v & (jnp.arange(sampled.shape[0]) != exclude)[:, None, None]
    j_cost, j_conf = jcost.combine_top2(b, u, v, jnp.asarray(var))
    j_cost = np.asarray(j_cost)
    assert np.array_equal(cost.numpy() >= 1e30, j_cost >= 1e30)
    ok = j_cost < 1e30
    assert rel_err(cost.numpy()[ok], j_cost[ok]).max() < 1e-5
    np.testing.assert_array_equal(conf.numpy(), np.asarray(j_conf))


def test_combine_top2_ties_keep_first_index():
    """Equal biased SSDs: the first source is the one dropped (argmax order),
    as in the JAX combine_top2."""
    biased = f32([[[1.0]], [[3.0]], [[3.0]], [[3.0]], [[2.0]]])
    unbiased = f32([[[0.1]], [[0.2]], [[0.4]], [[0.8]], [[1.6]]])
    valid = np.ones((5, 1, 1), bool)
    var = f32([[0.5]])
    j = np.asarray(jcost.combine_top2(*(jnp.asarray(a) for a in (biased, unbiased, valid, var)))[0])
    t = tcost.combine_top2(tt(biased), tt(unbiased), tt(valid), tt(var))[0].numpy()
    np.testing.assert_array_equal(t, j)
    np.testing.assert_allclose(t, (0.1 + 0.8 + 1.6) / 9 / 0.5, rtol=1e-6)


def test_k3_twin_vs_pallas_packed_interpret():
    """B3 -> B2 consumes 1/256-px-quantized coordinates and a stack packed
    at 2^-16 (G, B) / 2^-24 (R). The bias-compensated SSD is a small
    difference of patch sums, so those perturbations reach the cost
    amplified: median 5e-3, 99th percentile 5e-2 relative (the 99th
    percentile bound of tests/test_warp_pallas.py's packed test); finite
    sets agree but for edge pixels."""
    s = _scene(w=96, h=48, seed=4)
    variance = np.asarray(jsamp.rgb_variance(jnp.asarray(s["colors"][0])))
    dst = s["planar"][0]
    cost, conf = wc.cost_fused(*_k1_args(s), tt(dst), tt(variance), 0)
    packed = warp_pallas.project_sample_packed(
        jnp.asarray(s["planar"]), jnp.asarray(s["params"]), s["cam0"].position, jnp.asarray(s["disp"]),
        jnp.asarray(np.moveaxis(s["rays"], -1, 0)), interpret=True, ww_max=1024, wh_max=1024)
    p_cost, p_conf = warp_pallas.ssd_combine(packed, None, jnp.asarray(dst), jnp.asarray(variance), 0, min_keep=1,
                                             true_shape=(48, 96), interpret=True)
    cost, p_cost = cost.numpy(), np.asarray(p_cost)
    fin, p_fin = cost < 1e30, p_cost < 1e30
    assert (fin != p_fin).mean() < 2e-3
    both = fin & p_fin
    assert both.mean() > 0.9
    rel = np.abs(cost[both] - p_cost[both]) / (np.abs(p_cost[both]) + 1e-6)
    assert np.median(rel) < 5e-3 and np.percentile(rel, 99) < 0.05, (np.median(rel), np.percentile(rel, 99))


def test_k3_twin_vs_xla_cost_for_disparity():
    """Twin (K1 twin -> K2 twin) == the JAX cost_for_disparity XLA path
    (src_imgs_t=None). Costs divide by variances down to MIN_VAR and the
    bias compensation cancels, which turns float32 ulps of the projection
    into up to ~3e-5 relative; finite sets agree."""
    s = _scene(seed=5)
    variance = np.asarray(jsamp.rgb_variance(jnp.asarray(s["colors"][0])))
    ctx = jcost.CostContext(cam_dst=s["cam0"], src_cams=s["cams"], dst_img=jnp.asarray(s["colors"][0]),
                            src_imgs=jnp.asarray(s["colors"]), variance=jnp.asarray(variance), exclude_idx=0,
                            dst_rays=jnp.asarray(s["rays"]), src_imgs_t=None)
    j_cost, j_conf = map(np.asarray, jcost.cost_for_disparity(ctx, jnp.asarray(s["disp"])))
    cost, conf = wc.cost_fused(*_k1_args(s), tt(s["planar"][0]), tt(variance), 0)
    cost = cost.numpy()
    assert (np.isfinite(cost) & (cost < 1e30)).mean() > 0.9
    assert np.array_equal(cost >= 1e30, j_cost >= 1e30)
    ok = j_cost < 1e30
    assert rel_err(cost[ok], j_cost[ok]).max() < 1e-4
    np.testing.assert_array_equal(conf.numpy(), j_conf)


def test_wrappers_on_cpu_run_twins_and_count_nothing():
    s = _scene(seed=6)
    wc.reset_launch_counts()
    a = wc.project_sample(*_k1_args(s))
    b = wc.project_sample_plain(*_k1_args(s))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert all(v == 0 for v in wc.LAUNCHES.values())
