"""The port's solver stages batched over destination cameras
(facebook360_dep_tpu_torch/depth/solver.py, ops/cost.py, ops/warp_cuda.py)
against the same stages run on one destination at a time, bit for bit, and
the batched K1 twin against the Pallas kernel it replaces, on the 4-camera
mixed-type distorted rig of tests/test_torch_solver.py. The kernels run
only on a GPU: tests/test_torch_cuda.py holds them to the same there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facebook360_dep_tpu.core import camera as jcam
from facebook360_dep_tpu.ops import cost as jcost
from facebook360_dep_tpu.ops import warp_pallas
from facebook360_dep_tpu.render import synthetic as jsyn
from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.depth import pipeline as tpipe
from facebook360_dep_tpu_torch.depth import solver as ts
from facebook360_dep_tpu_torch.ops import cost as tcost
from facebook360_dep_tpu_torch.ops import warp_cuda as wc

from torch_parity import f32, jax_f32, port_rig, ring_rig, tt

H, W, N = 36, 48, 4


@pytest.fixture(scope="module")
def scene():
    """The rig, its colors, a level context of all four cameras as
    destinations (and one with foreground masks and a background), and a
    noisy start map near the truth, made with numpy from a seed."""
    rig = jcam.normalize_rig(ring_rig(jcam, "", n=N, resolution=(W, H), ring_radius=0.3, mixed=True))
    colors, gt = jsyn.render_sphere_scene(rig, (W, H), radius=5.0)
    gt = f32(np.nan_to_num(gt, nan=1e-4))
    trig = port_rig(tcam, rig)
    ctx = ts.make_level_context(trig, trig, tt(f32(colors)), tpipe.generate_fov_masks(trig, (H, W)), full_height=60)
    rng = np.random.RandomState(0)
    init = f32(gt * (1.0 + 0.04 * rng.randn(N, H, W)))
    ctx_fg = ctx._replace(dst_fg_masks=tt(rng.rand(N, H, W) > 0.3), dst_bg_disp=tt(f32(gt * 0.8)))
    return rig, ctx, ctx_fg, init


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-for-bit equality (NaN payloads and signed zeros included)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _per_destination(fn, ctx, *maps):
    """``fn(one-destination context, *its slices of maps)`` for each dst
    camera, its results stacked over the destinations."""
    outs = [fn(ts.select_destinations(ctx, [i]), *(m[i:i + 1] for m in maps)) for i in range(len(ctx.dst2src))]
    return tuple(torch.cat(o) for o in zip(*outs))


def _cfg(**kw):
    return ts.SolverConfig(**dict(dict(min_depth=1.0, max_depth=100.0, level=1, num_levels=3), **kw))


@pytest.mark.parametrize("channels", [1, 3])
def test_k1_twin_batched_equals_single_calls(scene, channels):
    """All four destinations in one call == each destination's own call:
    the colors (C = 3, from the interleaved stack) and a NaN-holding
    disparity stack (C = 1, as handle_mismatches samples it)."""
    _, ctx, _, init = scene
    if channels == 3:
        k1, src = wc.project_sample, ctx.src_rgba
    else:
        stack = init[:, None].copy()
        stack[:, :, 10:20, 20:30] = np.nan
        k1, src = wc.project_sample_planes, tt(stack)
    disp = tt(init)
    sampled, valid = k1(src, ctx.src_params, ctx.dst_cams.position, disp, ctx.dst_rays)
    assert sampled.shape == (N, N, channels, H, W) and valid.shape == (N, N, H, W)
    assert 0.2 < valid.double().mean().item() < 1.0
    for d in range(N):
        s1, v1 = k1(src, ctx.src_params, ctx.dst_cams.position[d], disp[d], ctx.dst_rays[d])
        assert _same(sampled[d], s1) and _same(valid[d], v1), d
    if channels == 1:
        assert torch.isnan(sampled).any()


def test_k1_batched_vs_pallas_v4_interpret(scene):
    """Each destination of one batched call against B1 run on it alone in
    interpret mode, with test_torch_kernels.py's bound: B1 quantizes
    coordinates to 1/256 px, so samples differ by up to 2/512 px times the
    image's largest step; validity agrees up to razor-edge atan ulps."""
    rig, ctx, _, init = scene
    cams = jax_f32(rig.cameras)
    params = np.asarray(warp_pallas.pack_camera_params_traced(cams))
    rays = f32([np.moveaxis(np.asarray(jcost.dst_ray_dirs(jax.tree.map(lambda a: a[i], cams), H, W)), -1, 0)
                for i in range(N)])
    position = f32(cams.position)
    planar = wc.planar_view(ctx.src_rgba).numpy()
    sampled, valid = wc.project_sample(ctx.src_rgba, tt(params), tt(position), tt(init), tt(rays))
    step = max(np.abs(np.diff(planar, axis=a)).max() for a in (2, 3))
    for d in range(N):
        p_s, p_v, p_c = map(np.asarray, warp_pallas.project_sample_planar_v4(
            jnp.asarray(planar), jnp.asarray(params), jnp.asarray(position[d]), jnp.asarray(init[d]),
            jnp.asarray(rays[d]), interpret=True, ww_max=1024, wh_max=1024))
        assert p_c.sum() == 0
        v, s = valid[d].numpy(), sampled[d].numpy()
        assert (v != (p_v > 0.5)).mean() < 1e-3
        assert np.delete(v, d, axis=0).mean() > 0.2  # the other sources see much of each map
        both = v & (p_v > 0.5)
        err = np.abs(s - p_s).transpose(1, 0, 2, 3)[:, both]
        assert err.max() <= 2.0 / 512.0 * step + 1e-6, (d, err.max(), step)
        assert np.all(s[:, :, ~v.any(0)] == 0.0)


@pytest.mark.parametrize("fused", [False, True])
def test_cost_for_disparity_batched_equals_single_destinations(scene, monkeypatch, fused):
    """All destinations in one call == each one's own call, for a map and a
    scalar hypothesis: K1 then K2 below FUSED_MIN_PIXELS, K3 from there up
    (lowered here to this level)."""
    if fused:
        monkeypatch.setattr(tcost, "FUSED_MIN_PIXELS", H * W)
    _, ctx, _, init = scene
    for disparity in (tt(init), 0.25):
        cost, conf = tcost.cost_for_disparity(ts.cost_context(ctx), disparity)
        assert cost.shape == conf.shape == (N, H, W)
        assert (cost < tcost.FLT_MAX).double().mean().item() > 0.5
        for d in range(N):
            one = ts.cost_context(ts.select_destinations(ctx, [d]))
            c1, f1 = tcost.cost_for_disparity(one, disparity[d:d + 1] if isinstance(disparity, torch.Tensor)
                                              else disparity)
            assert _same(cost[d:d + 1], c1) and _same(conf[d:d + 1], f1), d


@pytest.mark.parametrize("fg", [False, True])
def test_brute_force_all_equals_one_destination_contexts(scene, fg):
    _, ctx, ctx_fg, _ = scene
    ctx = ctx_fg if fg else ctx
    cfg = _cfg(level=2, has_fg_masks=fg)
    got = ts.brute_force_all(ctx, cfg)
    want = _per_destination(lambda c: ts.brute_force_all(c, cfg), ctx)
    assert all(_same(a, b) for a, b in zip(got, want))
    assert torch.isfinite(got[0]).double().mean().item() > 0.5


def _proposal_inputs(ctx, init):
    """Every pixel active and a start far from the sphere in a narrow depth
    range, so that many proposals are accepted (test_torch_solver.py)."""
    ctx = ctx._replace(var_noise_floor=float(np.float32(1e-9)), var_high_thresh=float(np.float32(1e-9)))
    return ctx, tt(init * 1.5), tt(np.full_like(init, np.inf)), tt(np.zeros_like(init))


@pytest.mark.parametrize("fg", [False, True])
def test_random_proposals_injected_uniforms_equal_one_destination_contexts(scene, fg):
    _, ctx, ctx_fg, init = scene
    ctx, disp, cost, conf = _proposal_inputs(ctx_fg if fg else ctx, init)
    cfg = _cfg(num_random_proposals=2, min_depth=4.0, has_fg_masks=fg)
    uniforms = tt(np.random.RandomState(7).rand(N, 2, H, W))
    got = ts.random_proposals(ctx, cfg, disp, cost, conf, uniforms=uniforms)
    want = _per_destination(lambda c, d, k, f, u: ts.random_proposals(c, cfg, d, k, f, uniforms=u),
                            ctx, disp, cost, conf, uniforms)
    assert all(_same(a, b) for a, b in zip(got, want))
    assert (got[0] != disp).double().mean().item() > 0.05


def test_random_proposals_seeded_generator_draws_one_destination_at_a_time(scene):
    """A seeded generator gives the batched stage the draws of the
    one-destination runs taken in destination order, as before batching."""
    _, ctx, _, init = scene
    ctx, disp, cost, conf = _proposal_inputs(ctx, init)
    cfg = _cfg(num_random_proposals=2, min_depth=4.0)
    got = ts.random_proposals(ctx, cfg, disp, cost, conf, generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    draws = torch.stack([torch.rand((2, H, W), generator=gen) for _ in range(N)])
    want = _per_destination(lambda c, d, k, f, u: ts.random_proposals(c, cfg, d, k, f, uniforms=u),
                            ctx, disp, cost, conf, draws)
    assert all(_same(a, b) for a, b in zip(got, want))
    assert (got[0] != disp).double().mean().item() > 0.05


@pytest.mark.parametrize("proposals,axis_only,fg", [(0, False, False), (2, False, False), (2, True, False),
                                                     (2, False, True)])
def test_ping_pong_equals_one_destination_contexts(scene, proposals, axis_only, fg):
    """Unseeded (9 candidates), seeded center (8), the axis-only star, and
    the foreground branch."""
    _, ctx, ctx_fg, init = scene
    ctx = ctx_fg if fg else ctx
    cfg = _cfg(num_random_proposals=proposals, star_axis_only=axis_only, has_fg_masks=fg)
    rng = np.random.RandomState(proposals)
    costs = tt(f32(rng.rand(N, H, W) * 5.0) if proposals else np.full_like(init, np.inf))
    conf = tt(f32(rng.rand(N, H, W)))
    got = ts.ping_pong(ctx, cfg, tt(init), costs, conf)
    want = _per_destination(lambda c, d, k, f: ts.ping_pong(c, cfg, d, k, f), ctx, tt(init), costs, conf)
    assert all(_same(a, b) for a, b in zip(got, want))
    assert (got[0] != tt(init)).double().mean().item() > 0.05


@pytest.mark.parametrize("fg,chunk", [(False, None), (True, None), (False, 3), (True, 1)])
def test_handle_mismatches_equals_one_destination_contexts(scene, monkeypatch, fg, chunk):
    """One C = 1 sampling of every map; a one-destination context takes the
    other cameras' maps as ``full_disparity``. The reduction takes all four
    maps at once here, or ``chunk`` maps at a time (the last chunk short),
    as it does at the large levels."""
    if chunk:
        monkeypatch.setattr(ts, "MISMATCH_CHUNK_ELEMENTS", chunk * N * H * W)
    _, ctx, ctx_fg, init = scene
    ctx = (ctx_fg if fg else ctx)._replace(var_high_thresh=1.0)
    cfg = _cfg(mismatches_start_level=1, has_fg_masks=fg)
    disp = init.copy()
    disp[1, 10:20, 10:30] *= 1.8  # a block that disagrees with the other cameras
    disp[2, :4, :4] = np.nan
    disp = tt(disp)
    got = ts.handle_mismatches(ctx, cfg, disp)
    want = _per_destination(lambda c, d: ts.handle_mismatches(c, cfg, d, full_disparity=disp), ctx, disp)
    assert all(_same(a, b) for a, b in zip(got, want))
    assert got[1].sum().item() > 20  # the block was detected
