"""The CUDA kernels on the card, against their plain twins.

These tests need an NVIDIA GPU with nvcc and skip elsewhere. The GPU machine
has no JAX, which tests/conftest.py imports, so run them there with:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.depth import pipeline, solver
from facebook360_dep_tpu_torch.ops import cost as cost_ops
from facebook360_dep_tpu_torch.ops import warp_cuda as wc
from facebook360_dep_tpu_torch.render import dibr, synthetic

from torch_parity import ring_rig

pytestmark = pytest.mark.cuda
FLT_MAX = float(np.finfo(np.float32).max)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def inputs(dev):
    """Destination 0's cost context on a mixed-type distorted ring, with a
    noisy candidate map, as the solver builds them."""
    w, h = 96, 72
    rig = tcam.normalize_rig(ring_rig(tcam, "", n=8, resolution=(w, h), mixed=True))
    colors, gt = synthetic.render_sphere_scene(rig, (w, h), device=dev)
    ctx = solver.make_level_context(rig, rig, colors, pipeline.generate_fov_masks(rig, (h, w), dev))
    cctx = solver.cost_context(solver.select_destinations(ctx, [0]))
    gen = torch.Generator(device=dev).manual_seed(0)
    disp = (gt[0] * (1.0 + 0.05 * (2 * torch.rand((h, w), generator=gen, device=dev) - 1))).contiguous()
    return cctx, disp, gt


def _k1(cctx, disp, src):
    """K1's (or its twin's) arguments for the context's first destination
    alone, on the source stack ``src``."""
    return (src, cctx.src_params, cctx.cam_dst.position[0], disp, cctx.dst_rays[0])


def _planar(cctx):
    """The planar view of the context's interleaved stack, what the twins read."""
    return wc.planar_view(cctx.src_rgba)


def _k2_rest(cctx):
    """K2's (and K3's) destination arguments for the context's first destination."""
    return cctx.dst_planar[0], cctx.variance[0], cctx.exclude_idx[0]


@pytest.mark.parametrize("channels", [1, 3])
def test_project_sample_matches_twin(inputs, channels):
    """Built with -fmad=false, the kernel rounds as the twin does: validity
    identical but for atan2f-ulp edge flips, samples to 1e-6."""
    cctx, disp, gt = inputs
    if channels == 3:
        s_k, v_k = wc.project_sample(*_k1(cctx, disp, cctx.src_rgba))
        s_p, v_p = wc.project_sample_plain(*_k1(cctx, disp, _planar(cctx)))
    else:
        src = gt[:, None].contiguous()
        s_k, v_k = wc.project_sample_planes(*_k1(cctx, disp, src))
        s_p, v_p = wc.project_sample_plain(*_k1(cctx, disp, src))
    assert (v_k != v_p).double().mean().item() < 1e-3
    both = (v_k & v_p)[:, None].expand_as(s_k)
    assert (s_k[both] - s_p[both]).abs().max().item() < 1e-6
    assert (s_k[~v_k[:, None].expand_as(s_k)] == 0).all()


def test_ssd_combine_matches_twin(inputs):
    cctx, disp, _ = inputs
    s, v = wc.project_sample_plain(*_k1(cctx, disp, _planar(cctx)))
    c_k, f_k = wc.ssd_combine(s, v, *_k2_rest(cctx))
    c_p, f_p = wc.ssd_combine_plain(s, v, *_k2_rest(cctx))
    assert torch.equal(c_k >= FLT_MAX, c_p >= FLT_MAX)
    ok = c_p < FLT_MAX
    assert ((c_k[ok] - c_p[ok]).abs() / (1 + c_p[ok].abs())).max().item() < 1e-5
    assert torch.equal(f_k, f_p)


def test_cost_fused_equals_k1_then_k2_and_twin(inputs):
    cctx, disp, _ = inputs
    rest = _k2_rest(cctx)
    c3, f3 = wc.cost_fused(*_k1(cctx, disp, cctx.src_rgba), *rest)
    s, v = wc.project_sample(*_k1(cctx, disp, cctx.src_rgba))
    c12, f12 = wc.ssd_combine(s, v, *rest)
    assert torch.equal(c3, c12) and torch.equal(f3, f12)
    c_p, _ = wc.cost_fused_plain(*_k1(cctx, disp, _planar(cctx)), *rest)
    both = (c3 < FLT_MAX) & (c_p < FLT_MAX)
    assert ((c3 >= FLT_MAX) != (c_p >= FLT_MAX)).double().mean().item() < 1e-3
    assert ((c3[both] - c_p[both]).abs() / (1 + c_p[both].abs())).max().item() < 1e-4
    with pytest.raises(ValueError, match="src_rgba"):  # the planar stack is not K3's layout
        wc.cost_fused(*_k1(cctx, disp, _planar(cctx)), *rest)


def _level(dev, w, h, n=16):
    """Destination 3's cost context (not the first source, so the skipped
    self source sits inside K2's source loop) on a mixed-type distorted
    ring of ``n`` cameras at (w, h), with a noisy candidate map."""
    ctx, disp = _level_all(dev, w, h, n)
    return solver.cost_context(solver.select_destinations(ctx, [3])), disp[3]


def _level_all(dev, w, h, n=16):
    """The level context of every camera of a mixed-type distorted ring of
    ``n`` cameras at (w, h) as destinations, and noisy candidate maps."""
    rig = tcam.normalize_rig(ring_rig(tcam, "", n=n, resolution=(w, h), mixed=True))
    colors, gt = synthetic.render_sphere_scene(rig, (w, h), device=dev)
    ctx = solver.make_level_context(rig, rig, colors, pipeline.generate_fov_masks(rig, (h, w), dev))
    gen = torch.Generator(device=dev).manual_seed(w + h)
    noise = 1.0 + 0.05 * (2 * torch.rand((n, h, w), generator=gen, device=dev) - 1)
    return ctx, (torch.nan_to_num(gt, nan=1e-4) * noise).contiguous()


# a ragged shape below K3's 30x14 output tile and K2's 30-pixel row, the
# solve's coarsest level and one more coarse shape (both ragged for either
# tile), and the finest level the solve runs K3 at
LEVEL_SHAPES = [(29, 13), (50, 38), (61, 45), (512, 384)]


@pytest.mark.parametrize("w,h", LEVEL_SHAPES)
def test_ssd_combine_matches_twin_at_level_shapes(dev, w, h):
    """K2 spreads (pixel, source) over threads and folds in source order:
    the tolerances of chip_smoke.py (cost 1e-6 abs + 1e-4 rel on all but
    1e-4 of the values, confidence exact), 20 sources (two chunks of 16)
    and one channel included."""
    for n, channels in ((16, 3), (20, 3), (16, 1)):
        cctx, disp = _level(dev, w, h, n)
        s, v = wc.project_sample_plain(*_k1(cctx, disp, _planar(cctx)))
        s, dst = s[:, :channels].contiguous(), cctx.dst_planar[0, :channels].contiguous()
        c_k, f_k = wc.ssd_combine(s, v, dst, cctx.variance[0], cctx.exclude_idx[0])
        c_p, f_p = wc.ssd_combine_plain(s, v, dst, cctx.variance[0], cctx.exclude_idx[0])
        assert torch.equal(c_k >= FLT_MAX, c_p >= FLT_MAX)
        ok = c_p < FLT_MAX
        assert ok.double().mean().item() > 0.5
        bad = (c_k[ok] - c_p[ok]).abs() > 1e-6 + 1e-4 * c_p[ok].abs()
        assert bad.double().mean().item() <= 1e-4, (n, channels)
        assert torch.equal(f_k, f_p)


@pytest.mark.parametrize("w,h", LEVEL_SHAPES)
def test_cost_fused_bit_identical_to_k1_then_k2_at_level_shapes(dev, w, h):
    """K3 == K1 then K2, bit for bit, and its twin; both read the
    interleaved stack the level context builds at every level."""
    cctx, disp = _level(dev, w, h)
    rest = _k2_rest(cctx)
    c3, f3 = wc.cost_fused(*_k1(cctx, disp, cctx.src_rgba), *rest)
    s, v = wc.project_sample(*_k1(cctx, disp, cctx.src_rgba))
    c12, f12 = wc.ssd_combine(s, v, *rest)
    assert torch.equal(c3, c12) and torch.equal(f3, f12)
    assert (c3 < FLT_MAX).double().mean().item() > 0.5
    c_p, f_p = wc.cost_fused_plain(*_k1(cctx, disp, _planar(cctx)), *rest)
    assert ((c3 >= FLT_MAX) != (c_p >= FLT_MAX)).double().mean().item() < 1e-3
    both = (c3 < FLT_MAX) & (c_p < FLT_MAX)
    assert ((c3[both] - c_p[both]).abs() > 1e-6 + 1e-4 * c_p[both].abs()).double().mean().item() <= 1e-4


def test_wrappers_validate_and_count(inputs):
    cctx, disp, _ = inputs
    rgba, planes = cctx.src_rgba, _planar(cctx).contiguous()
    wc.reset_launch_counts()
    wc.project_sample(*_k1(cctx, disp, rgba))
    wc.project_sample_plain(*_k1(cctx, disp, planes))
    assert wc.LAUNCHES == {"project_sample": 1, "ssd_combine": 0, "cost_fused": 0, "warp_sample": 0}
    assert wc.LAUNCHES_BY_SHAPE == {("project_sample", *disp.shape): 1}
    with pytest.raises(ValueError, match="contiguous"):
        wc.project_sample(*_k1(cctx, disp.t().contiguous().t(), rgba))
    with pytest.raises(ValueError, match="dtype"):
        wc.project_sample(*_k1(cctx, disp.double(), rgba))
    with pytest.raises(ValueError, match="on cpu"):
        wc.project_sample(*_k1(cctx, disp.cpu(), rgba))
    with pytest.raises(ValueError, match="C=4"):
        wc.project_sample_planes(*_k1(cctx, disp, planes[:, :1].expand(-1, 4, -1, -1).contiguous()))
    with pytest.raises(ValueError, match="C=3"):  # the colors come from the interleaved stack
        wc.project_sample_planes(*_k1(cctx, disp, planes))
    with pytest.raises(ValueError, match="src_rgba"):  # and only from there
        wc.project_sample(*_k1(cctx, disp, planes))
    assert wc.LAUNCHES["project_sample"] == 1


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_warp_sample_matches_twin(inputs, dev, channels):
    """K4 at a cubemap render gather's coords: built with -fmad=false and
    the twin's lerp order, bit-identical, NaN taps included; one launch."""
    cctx, _, gt = inputs
    rig = tcam.normalize_rig(ring_rig(tcam, "", n=8, resolution=(96, 72), mixed=True))
    cams = rig.cameras.to(dev, torch.float32)
    disp = torch.where(torch.isfinite(gt), gt, float("nan"))
    disp[:, 10:14, 20:30] = float("nan")
    target = dibr.Target("cube", face_size=48)
    center = cams.position[0]
    world = dibr.target_points(dibr.splat_zbuffer(cams, disp, center, target), center, target)
    coords, _ = dibr.gather_coords(cams, world, (72, 96))
    src = torch.cat([_planar(cctx)[:1].expand(8, -1, -1, -1), disp[:, None]], 1)[:, -channels:].contiguous()
    wc.reset_launch_counts()
    s_k, v_k = wc.warp_sample_planar(src, coords)
    assert wc.LAUNCHES["warp_sample"] == 1
    s_p, v_p = wc.warp_sample_planar_plain(src, coords)
    torch.cuda.synchronize()
    assert torch.equal(v_k, v_p) and v_k.any() and not v_k.all()
    assert torch.equal(torch.isnan(s_k), torch.isnan(s_p)) and torch.isnan(s_k).any()
    assert torch.equal(s_k.nan_to_num(-1.0), s_p.nan_to_num(-1.0))
    out, valid = wc.warp_sample(src[0].permute(1, 2, 0), coords[0].contiguous())
    assert torch.equal(out.permute(2, 0, 1).nan_to_num(-1.0), s_k[0].nan_to_num(-1.0))
    with pytest.raises(ValueError, match="C=5"):
        wc.warp_sample_planar(src[:, :1].expand(-1, 5, -1, -1).contiguous(), coords)
    with pytest.raises(ValueError, match="contiguous"):
        wc.warp_sample_planar(src, coords.transpose(1, 2))


# the coarsest level of the sphere solve, a ragged shape, and the finest
# level K1 runs at there
BATCH_SHAPES = [(50, 38), (61, 45), (256, 192)]


@pytest.mark.parametrize("w,h", BATCH_SHAPES)
def test_project_sample_batched_matches_twin(dev, w, h):
    """All 16 destination maps of a 16-camera level in one launch against
    the twin, within chip_smoke.py's K1 tolerances: the colors (C = 3) and a
    NaN-holding disparity stack (C = 1, as handle_mismatches samples it);
    each map also equals its own single-destination launch bit for bit."""
    ctx, disp = _level_all(dev, w, h)
    stack = torch.where(ctx.dst_fov_masks, disp, float("nan"))[:, None].clone()
    stack[:, :, :8, :8] = float("nan")
    rest = (ctx.src_params, ctx.dst_cams.position, disp, ctx.dst_rays)
    for k1, src, plain_src, atol, rtol in ((wc.project_sample, ctx.src_rgba, wc.planar_view(ctx.src_rgba), 1e-5, 0.0),
                                           (wc.project_sample_planes, stack, stack, 1e-7, 1e-5)):
        wc.reset_launch_counts()
        s_k, v_k = k1(src, *rest)
        assert wc.LAUNCHES["project_sample"] == 1 and wc.LAUNCHES_BY_SHAPE == {("project_sample", h, w): 1}
        s_p, v_p = wc.project_sample_plain(plain_src, *rest)
        torch.cuda.synchronize()
        assert s_k.shape == (16, 16, plain_src.shape[1], h, w) and v_k.shape == (16, 16, h, w)
        assert (v_k != v_p).double().mean().item() < 1e-4
        both = (v_k & v_p)[:, :, None].expand_as(s_k)
        a, b = s_k[both], s_p[both]
        fin = torch.isfinite(a) & torch.isfinite(b)
        assert (torch.isnan(a) != torch.isnan(b)).double().mean().item() < 1e-4
        assert ((a[fin] - b[fin]).abs() > atol + rtol * b[fin].abs()).double().mean().item() <= 1e-4
        assert (s_k[~v_k[:, :, None].expand_as(s_k)] == 0).all()
        for d in (0, 7, 15):
            s1, v1 = k1(src, ctx.src_params, ctx.dst_cams.position[d], disp[d], ctx.dst_rays[d])
            assert torch.equal(s1.nan_to_num(-1.0), s_k[d].nan_to_num(-1.0)) and torch.equal(v1, v_k[d])


@pytest.mark.parametrize("w,h", BATCH_SHAPES + [(512, 384)])
def test_cost_for_disparity_batched_equals_single_destinations(dev, w, h):
    """The solver's batched cost (one K1 launch, then K2 a map; K3 a map
    from FUSED_MIN_PIXELS up) == the 16 single-destination calls, bit for
    bit, for a map and a scalar hypothesis; the launches as counted."""
    ctx, disp = _level_all(dev, w, h)
    fused = w * h >= cost_ops.FUSED_MIN_PIXELS
    for hyp in (disp, 0.2):
        wc.reset_launch_counts()
        cost, conf = cost_ops.cost_for_disparity(solver.cost_context(ctx), hyp)
        assert wc.LAUNCHES == {"project_sample": 0 if fused else 1, "ssd_combine": 0 if fused else 16,
                               "cost_fused": 16 if fused else 0, "warp_sample": 0}
        assert (cost < FLT_MAX).double().mean().item() > 0.5
        for d in range(16):
            one = solver.cost_context(solver.select_destinations(ctx, [d]))
            c1, f1 = cost_ops.cost_for_disparity(one, hyp[d:d + 1] if isinstance(hyp, torch.Tensor) else hyp)
            assert torch.equal(cost[d:d + 1], c1) and torch.equal(conf[d:d + 1], f1), d


def test_project_sample_raises_on_mismatched_destinations(dev):
    ctx, disp = _level_all(dev, 50, 38)
    args = (ctx.src_rgba, ctx.src_params, ctx.dst_cams.position, disp, ctx.dst_rays)
    wc.reset_launch_counts()
    position = ctx.dst_cams.position
    for i, bad in ((2, position[:15]), (3, disp[:15]), (4, ctx.dst_rays[:15]), (3, disp[0]), (2, position[0])):
        with pytest.raises(ValueError, match="shape"):
            wc.project_sample(*args[:i], bad, *args[i + 1:])
    assert wc.LAUNCHES["project_sample"] == 0


@pytest.mark.parametrize("chunk", [None, 5])
def test_handle_mismatches_batched_equals_one_destination_contexts(dev, monkeypatch, chunk):
    """The mismatch stage on the card: one C = 1 K1 launch for all 16 maps,
    the reduction over all of them at once or 5 maps at a time, equals its
    16 one-destination runs bit for bit."""
    if chunk:
        monkeypatch.setattr(solver, "MISMATCH_CHUNK_ELEMENTS", chunk * 16 * 45 * 61)
    ctx, disp = _level_all(dev, 61, 45)
    ctx = ctx._replace(var_high_thresh=1.0)
    disp[1, 10:20, 10:30] *= 1.8  # a block that disagrees with the other cameras
    cfg = solver.SolverConfig(level=0, num_levels=2, mismatches_start_level=0)
    wc.reset_launch_counts()
    new, replace = solver.handle_mismatches(ctx, cfg, disp)
    assert wc.LAUNCHES["project_sample"] == 1
    assert replace.sum().item() > 20
    for d in range(16):
        one, r1 = solver.handle_mismatches(solver.select_destinations(ctx, [d]), cfg, disp[d:d + 1],
                                           full_disparity=disp)
        assert torch.equal(new[d:d + 1].nan_to_num(-1.0), one.nan_to_num(-1.0)) and torch.equal(replace[d:d + 1], r1), d



@pytest.mark.parametrize("depth_scale", [1.0, 0.5])
def test_convert_depth_on_the_card_equals_cpu(dev, tmp_path, depth_scale):
    """The publish path's device stages (depth, its nearest resizes, the
    equi-error grid) give the CPU's bytes, so the meshes are the same."""
    from facebook360_dep_tpu_torch.cli import convert_to_binary as ctb

    w, h = 96, 72
    rig = synthetic.make_test_rig(2, (w, h), ring_radius=0.2)
    _, gt = synthetic.render_sphere_scene(rig, (w, h), radius=5.0)
    disp = gt[0].numpy().copy()
    disp[:20, :30] *= 2.5  # a tear
    disp[40:44, 50:60] = np.nan
    yy, xx = np.mgrid[0:h, 0:w]
    mask = (xx - 48) ** 2 + (yy - 36) ** 2 < 30 ** 2
    (vc, fc), (vd, fd) = (ctb.convert_depth(rig.camera(0), "cam0", disp, str(tmp_path), triangles=500,
                                            depth_scale=depth_scale, foreground_mask=mask, device=d)
                          for d in ("cpu", dev))
    assert 0 < len(fd) <= 500
    assert vd.tobytes() == vc.tobytes() and fd.tobytes() == fc.tobytes()
