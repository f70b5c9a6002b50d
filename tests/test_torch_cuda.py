"""The CUDA kernels on the card, against their plain twins.

These tests need an NVIDIA GPU with nvcc and skip elsewhere. The GPU machine
has no JAX, which tests/conftest.py imports, so run them there with:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import math
import os

import numpy as np
import pytest
import torch

from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.depth import pipeline, solver
from facebook360_dep_tpu_torch.ops import cost as cost_ops
from facebook360_dep_tpu_torch.ops import filters
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
    assert wc.LAUNCHES == {"project_sample": 1, "ssd_combine": 0, "cost_fused": 0, "warp_sample": 0,
                           "tile_windows": 0, "project_sample_tpu": 0, "cost_fused_tpu": 0, "joint_bilateral": 0,
                           "chamfer": 0}
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
                               "cost_fused": 16 if fused else 0, "warp_sample": 0,
                               "tile_windows": 0, "project_sample_tpu": 0, "cost_fused_tpu": 0, "joint_bilateral": 0,
                               "chamfer": 0}
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



# the 2K mismatch stage against the benchmark's reference of it: at most this
# share of the 16 maps' pixels may differ in the mask, or in value beyond
# 1e-6 relative (K1's samples may sit an ulp off the exact projection's, so
# a sample on the edge of the +-10% band may vote otherwise; on an H100 none
# did: both shares read 0), and the stage may add at most this many bytes
# to the peak (K1's 16 x 16 sampled planes and valid flags, ~4.0 GB, and
# one map's chunk: +4.931 GiB on an H100)
MM_2K_OFF_SHARE = 1e-5
MM_2K_PEAK_BYTES = int(5.5 * 2**30)


def test_2k_mismatch_stage_equals_the_reference(dev, tmp_path):
    """The mismatch stage at sphere16.mismatch2k's level 0: 16 maps at
    2048x1536 of the benchmark's sphere_disk scene, 5% off the truth, in one
    C = 1 K1 launch and 16 one-map chunks, held to the benchmark's plain
    reference of the stage (depbench/reference/solve_mm.py) on the card
    within MM_2K_OFF_SHARE; a replaced pixel never rises, a kept one is
    untouched; the stage's peak stays within MM_2K_PEAK_BYTES."""
    from depbench.reference import camera as dcam
    from depbench.reference import solve as rbase
    from depbench.reference import solve_mm
    from depbench.rigs import forward_ring
    from depbench.scenes import sphere_disk

    w, h = 2048, 1536
    cams, ids = forward_ring.make(dict(num_cameras=16, resolution=[w, h], ring_radius=0.3, focal_scale=0.45,
                                       type="RECTILINEAR"))
    path = tmp_path / "rig.json"
    path.write_text(dcam.rig_json_text(cams, ids))
    cams_norm = dcam.normalize(dcam.load_rig_text(path.read_text())[0])
    rig = tcam.normalize_rig(tcam.load_rig(str(path)))
    colors, truth = sphere_disk.render(cams_norm.to(dev, torch.float32), (w, h), 7, 1)
    gen = torch.Generator(device=dev).manual_seed(25)
    disp = (truth * (1.0 + 0.05 * torch.randn(truth.shape, generator=gen, device=dev))).contiguous()
    ctx = solver.make_level_context(rig, rig, colors, pipeline.generate_fov_masks(rig, (h, w), dev), full_height=h)
    cfg = solver.SolverConfig(level=0, num_levels=10, mismatches_start_level=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    wc.reset_launch_counts()
    new, replace = solver.handle_mismatches(ctx, cfg, disp)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert wc.LAUNCHES["project_sample"] == 1 and wc.LAUNCHES_BY_SHAPE == {("project_sample", h, w): 1}
    del ctx
    lv = rbase.Level(cams_norm, colors, 0, h, torch.float32)
    want, want_mask = solve_mm.handle_mismatches(lv, disp)
    mask_off = (replace != want_mask).double().mean().item()
    value_off = ((new - want).abs() > 1e-6 * want.abs()).double().mean().item()
    print(f"mismatch 2K: replaced {int(replace.sum())} (reference {int(want_mask.sum())}), mask off {mask_off:.3g}, "
          f"value off {value_off:.3g}, peak +{peak / 2**30:.3f} GiB")
    assert replace.sum().item() > 10_000
    assert mask_off <= MM_2K_OFF_SHARE and value_off <= MM_2K_OFF_SHARE
    assert torch.all(new[replace] <= disp[replace]) and torch.equal(new[~replace], disp[~replace])
    assert peak <= MM_2K_PEAK_BYTES

# The joint bilateral kernel (csrc/joint_bilateral.cu) at every level shape
# of the benchmark's two configurations, sphere16 (heights (3w + 2) // 4)
# and ftheta16 (round(w * 2160 / 3360)), each at its level's radius.
JB_WIDTHS = [2048, 1024, 512, 256, 200, 128, 100, 80, 60, 50]
JB_FTHETA_HEIGHTS = [1317, 658, 329, 165, 129, 82, 64, 51, 39, 32]
JB_SHAPES = ([(w, (3 * w + 2) // 4, level) for level, w in enumerate(JB_WIDTHS)]
             + [(w, h, level) for level, (w, h) in enumerate(zip(JB_WIDTHS, JB_FTHETA_HEIGHTS))])


def _bits(a, b) -> bool:
    """Bit-for-bit equality of float32 maps (NaN payloads included)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _jb_radius(level: int) -> int:
    return max(math.ceil(filters.BILATERAL_SPACE_RADIUS_MAX * cost_ops.LEVEL_SCALE ** level),
               filters.BILATERAL_SPACE_RADIUS_MIN)


def _jb_mask(ctx, seed):
    """The FOV masks cut to an image circle (as an FTHETA rig's) and holed
    by a foreground mask."""
    d, h, w = ctx.dst_fov_masks.shape
    dev = ctx.dst_fov_masks.device
    yy = torch.arange(h, device=dev)[:, None] + 0.5 - h / 2
    xx = torch.arange(w, device=dev)[None, :] + 0.5 - w / 2
    circle = (xx / (0.5 * w)) ** 2 + (yy / (0.5 * w)) ** 2 < 1.0
    gen = torch.Generator(device=dev).manual_seed(seed)
    return ctx.dst_fov_masks & circle & (torch.rand((d, h, w), generator=gen, device=dev) > 0.2)


def _per_map_stage(ctx, cfg, disparity):
    """The bilateral stage a map at a time, as the solver ran it before its
    kernel: filters.joint_bilateral guided by src_imgs, then
    where(fg, filtered, disparity)."""
    radius = _jb_radius(cfg.level)
    return torch.stack([
        torch.where(ctx.dst_fg_masks[i],
                    filters.joint_bilateral(disparity[i], ctx.src_imgs[s][..., :3],
                                            ctx.dst_fov_masks[i] & ctx.dst_fg_masks[i], radius),
                    disparity[i])
        for i, s in enumerate(ctx.dst2src)])


@pytest.mark.parametrize("w,h,level", JB_SHAPES)
def test_joint_bilateral_bit_equal_to_twin_at_level_shapes(dev, w, h, level):
    """All 16 maps of a level in one launch equal the per-map twin run on
    the card bit for bit, at every level shape and radius of both
    configurations, on image-circle masks with holes."""
    ctx, disp = _level_all(dev, w, h)
    mask = _jb_mask(ctx, w + h)
    radius = _jb_radius(level)
    wc.reset_launch_counts()
    k = wc.joint_bilateral(ctx.src_rgba, ctx.dst2src, disp, mask, radius)
    assert wc.LAUNCHES["joint_bilateral"] == 1 and wc.LAUNCHES_BY_SHAPE == {("joint_bilateral", h, w): 1}
    p = wc.joint_bilateral_plain(ctx.src_rgba, ctx.dst2src, disp, mask, radius)
    torch.cuda.synchronize()
    assert _bits(k, p)
    assert not torch.equal(k[mask], disp[mask]) and _bits(k[~mask], disp[~mask])


@pytest.mark.parametrize("w,h", [(61, 45), (512, 384)])
@pytest.mark.parametrize("radius", [1, 2, 3, 4, 5])
def test_joint_bilateral_every_radius_with_nonfinite_taps(dev, w, h, radius):
    """Every radius on 16 maps, with NaN and infinite disparities under
    masked-out taps (each adds 0 x its value: NaN in the kernel as in the
    twin) and at masked-out centres (passed through), bit for bit."""
    ctx, disp = _level_all(dev, w, h)
    mask = _jb_mask(ctx, radius)
    gen = torch.Generator(device=dev).manual_seed(radius)
    u = torch.rand(disp.shape, generator=gen, device=dev)
    disp = torch.where(~mask & (u < 0.03), float("nan"), disp)
    disp = torch.where(~mask & (u > 0.99), float("inf"), disp)
    disp = torch.where(~mask & (u > 0.985) & (u <= 0.99), float("-inf"), disp).contiguous()
    k = wc.joint_bilateral(ctx.src_rgba, ctx.dst2src, disp, mask, radius)
    p = wc.joint_bilateral_plain(ctx.src_rgba, ctx.dst2src, disp, mask, radius)
    torch.cuda.synchronize()
    assert _bits(k, p)
    assert torch.isnan(k[mask]).any() and torch.isfinite(k[mask]).any()


def test_spatial_bilateral_on_a_block_context_on_the_card(dev):
    """A rank's block of a level (make_level_context(destinations=), the
    sharded solve's): its 3 maps guided by their sources among all 16, in
    one launch, as the whole level's stage and the twin give them."""
    w, h = 61, 45
    rig = tcam.normalize_rig(ring_rig(tcam, "", n=16, resolution=(w, h), mixed=True))
    colors, gt = synthetic.render_sphere_scene(rig, (w, h), device=dev)
    fov = pipeline.generate_fov_masks(rig, (h, w), dev)
    whole = solver.make_level_context(rig, rig, colors, fov)
    block = solver.make_level_context(rig, rig, colors, fov, destinations=[3, 7, 12])
    disp = torch.nan_to_num(gt, nan=1e-4).contiguous()
    cfg = solver.SolverConfig(level=3, num_levels=10)
    wc.reset_launch_counts()
    got = solver.spatial_bilateral(block, cfg, disp[[3, 7, 12]])
    assert wc.LAUNCHES["joint_bilateral"] == 1
    assert _bits(got, solver.spatial_bilateral(whole, cfg, disp)[[3, 7, 12]])
    assert _bits(got, _per_map_stage(block, cfg, disp[[3, 7, 12]]))


def test_process_level_launches_one_joint_bilateral(dev, monkeypatch):
    """process_level filters its 16 maps with one joint_bilateral launch and
    no per-map filter call."""
    def per_map(*args, **kw):
        raise AssertionError("filters.joint_bilateral called on the card")

    ctx, disp = _level_all(dev, 61, 45)
    monkeypatch.setattr(filters, "joint_bilateral", per_map)
    cfg = solver.SolverConfig(min_depth=1.0, max_depth=100.0, level=1, num_levels=3)
    wc.reset_launch_counts()
    solver.process_level(ctx, cfg, init_disparity=disp)
    assert wc.LAUNCHES["joint_bilateral"] == 1
    assert {k: v for k, v in wc.LAUNCHES_BY_SHAPE.items() if k[0] == "joint_bilateral"} == {
        ("joint_bilateral", 45, 61): 1}


def test_2k_level_solve_equals_the_per_map_stage(dev, monkeypatch):
    """A default level-0 solve of 16 maps at 2048x1536 (the bilateral at
    radius 5) gives the bits of the same solve with the per-map stage in
    its place, in every output: the maps the PFMs are written from."""
    ctx, disp = _level_all(dev, 2048, 1536)
    cfg = solver.SolverConfig(min_depth=1.0, max_depth=100.0, level=0, num_levels=10)
    got = solver.process_level(ctx, cfg, init_disparity=disp)
    monkeypatch.setattr(solver, "spatial_bilateral", _per_map_stage)
    want = solver.process_level(ctx, cfg, init_disparity=disp)
    for key, v in want.items():
        assert _bits(got[key], v) if v.dtype == torch.float32 else torch.equal(got[key], v), key
    assert torch.isfinite(got["disparity"]).double().mean().item() > 0.5


# The chamfer kernel (csrc/chamfer.cu) at every level shape of sphere16fg
# (sphere16's, heights (3w + 2) // 4) and at ftheta16's odd heights.
def _with_coarser(shapes):
    """(w, h, the next coarser level's (w, h) or None) of a pyramid's shapes, finest first."""
    return [(w, h, shapes[i + 1] if i + 1 < len(shapes) else None) for i, (w, h) in enumerate(shapes)]


CHAMFER_SHAPES = (_with_coarser([(w, (3 * w + 2) // 4) for w in JB_WIDTHS])
                  + _with_coarser(list(zip(JB_WIDTHS, JB_FTHETA_HEIGHTS))))


def _disk_masks(dev, w, h):
    """(16, h, w) bool: the foreground masks of the benchmark's scene
    sphere_disk (frame 1) on sphere16fg's ring, rendered at (w, h)."""
    from depbench.reference import camera as dcam
    from depbench.rigs import forward_ring
    from depbench.scenes import sphere_disk

    cams, ids = forward_ring.make(dict(num_cameras=16, resolution=[2048, 1536], ring_radius=0.3, focal_scale=0.45))
    cams = dcam.normalize(dcam.load_rig_text(dcam.rig_json_text(cams, ids))[0]).to(dev, torch.float32)
    return sphere_disk.render_inputs(cams, (w, h), 7, 1)["foreground_masks_levels"].to(torch.bool)


def _chamfer_stacks(dev, w, h, coarser):
    """Two (16, h, w) stacks of valid flags: the init's at this level (the
    disk's mask, less where the coarser level's mask, nearest-upsampled,
    leaves a hole) and random ones, among them a map with no valid pixel,
    a full one and one with a single valid pixel."""
    disk = _disk_masks(dev, w, h)
    if coarser is not None:
        cw, ch = coarser
        iy = torch.from_numpy(pipeline.io.nearest_index(ch, h)).to(dev)
        ix = torch.from_numpy(pipeline.io.nearest_index(cw, w)).to(dev)
        disk = disk & _disk_masks(dev, cw, ch).index_select(1, iy).index_select(2, ix)
    gen = torch.Generator(device=dev).manual_seed(w * h)
    rand = torch.rand((16, h, w), generator=gen, device=dev) < 0.02
    rand[3] = False
    rand[4] = True
    rand[5] = False
    rand[5, h // 2, w - 1] = True
    return disk.contiguous(), rand.contiguous()


@pytest.mark.parametrize("w,h,coarser", CHAMFER_SHAPES)
def test_chamfer_labels_equal_twin_at_level_shapes(dev, w, h, coarser):
    """All 16 maps of a level in one launch: the kernel's labels are the
    twin's (run on the card) at every level shape of both configurations,
    on the foreground scene's masks and on random ones."""
    for valid in _chamfer_stacks(dev, w, h, coarser):
        wc.reset_launch_counts()
        k = wc.chamfer_labels(valid)
        assert wc.LAUNCHES["chamfer"] == 1 and wc.LAUNCHES_BY_SHAPE == {("chamfer", h, w): 1}
        p = wc.chamfer_labels_plain(valid)
        torch.cuda.synchronize()
        assert k.dtype == torch.int32 and torch.equal(k, p)
        has = valid.flatten(1).any(1)
        assert (k[~has] == -1).all() and (k[has] >= 0).all()


def _fg_init_inputs(dev, fine, coarse, seed):
    """A level's foreground init inputs: 16 coarser maps (some NaN) and the
    masks of both levels from the foreground scene, the plate random."""
    (w, h), (cw, ch) = fine, coarse
    rng = np.random.RandomState(seed)
    disp = (rng.rand(16, ch, cw) * 0.3 + 0.1).astype(np.float32)
    disp[rng.rand(16, ch, cw) < 0.01] = np.nan
    mask = _disk_masks(dev, cw, ch).cpu().numpy()
    mask_up = _disk_masks(dev, w, h).cpu().numpy()
    bg = (rng.rand(16, h, w) * 0.1).astype(np.float32)
    return disp, mask, mask_up, bg


def test_2k_foreground_init_on_the_card_equals_the_host(dev):
    """Level 0 of sphere16fg (1024x768 -> 2048x1536, 16 maps): the init on
    the card (one chamfer launch) gives the array of the same init on CPU
    tensors (the chamfer's plain twin) byte for byte and the same counts."""
    disp, mask, mask_up, bg = _fg_init_inputs(dev, (2048, 1536), (1024, 768), 0)
    want, holes, swept = pipeline._upsample_fg_tensors(
        *(torch.from_numpy(a) for a in (disp, mask, mask_up, bg)), (2048, 1536))
    want = want.numpy()
    wc.reset_launch_counts()
    got, got_holes, got_swept = pipeline._upsample_fg_tensors(
        *(torch.from_numpy(a).to(dev) for a in (disp, mask, mask_up, bg)), (2048, 1536))
    assert wc.LAUNCHES["chamfer"] == 1 and wc.LAUNCHES_BY_SHAPE == {("chamfer", 1536, 2048): 1}
    assert got.is_cuda and got.cpu().numpy().tobytes() == want.tobytes()
    assert (got_holes, got_swept) == (holes, swept) and holes > 0 and swept == 16 * 2048 * 1536


def test_derp_cli_foreground_pyramid_on_the_card_equals_the_host_init(dev, tmp_path, monkeypatch):
    """A 16-camera, three-level derp_cli --use_foreground_masks on the card
    launches the chamfer once a level below the coarsest (one launch a
    load_coarser_disparity) and writes the PFMs, at every level, that the
    same run writes with the init made on CPU copies of its inputs (the
    chamfer's plain twin) and copied to the card."""
    from facebook360_dep_tpu_torch.cli import derp_cli
    from facebook360_dep_tpu_torch.core import imagetypes, io

    levels = {0: (96, 72), 1: (64, 48), 2: (48, 36)}
    rig = synthetic.make_test_rig(16, levels[0], ring_radius=0.3)
    colors, gt = synthetic.render_sphere_scene(rig, levels[0], radius=5.0)
    root = str(tmp_path / "project")
    for level, (w, h) in levels.items():
        masks = _disk_masks(torch.device("cpu"), w, h).numpy()
        for i, cam_id in enumerate(rig.ids):
            layers = (("color_levels", "png", io.resize_image(colors[i].numpy(), (w, h))),
                      ("foreground_masks_levels", "png", masks[i].astype(np.uint8) * 255),
                      ("background_disp_levels", "pfm",
                       io.resize_image(np.nan_to_num(gt[i].numpy(), nan=1e-4), (w, h)) * np.float32(0.8)))
            for image_type, ext, value in layers:
                d = imagetypes.image_dir(root, image_type, level, cam_id)
                os.makedirs(d, exist_ok=True)
                path = os.path.join(d, "000000." + ext)
                if image_type == "color_levels":
                    io.write_color(path, value, bit_depth=16)
                elif ext == "png":
                    io.write_png(path, value)
                else:
                    io.write_pfm(path, value.astype(np.float32))
    os.makedirs(os.path.join(root, "rigs"))
    tcam.save_rig(os.path.join(root, "rigs/rig_calibrated.json"), rig)
    argv = ["--input_root", root, "--use_foreground_masks", "true", "--min_depth_m", "1", "--max_depth_m", "100",
            "--resolution", "96"]

    wc.reset_launch_counts()
    derp_cli.main(argv + ["--output_root", str(tmp_path / "card")], device=dev)
    assert {k: v for k, v in wc.LAUNCHES_BY_SHAPE.items() if k[0] == "chamfer"} == {
        ("chamfer", 72, 96): 1, ("chamfer", 48, 64): 1}

    init_on_tensors = pipeline._upsample_fg_tensors

    def host_init(disp, mask, mask_up, bg, size_wh):
        up, holes, swept = init_on_tensors(*(t.cpu() for t in (disp, mask, mask_up, bg)), size_wh)
        return up.to(disp.device), holes, swept

    monkeypatch.setattr(pipeline, "_upsample_fg_tensors", host_init)
    wc.reset_launch_counts()
    derp_cli.main(argv + ["--output_root", str(tmp_path / "host")], device=dev)
    assert wc.LAUNCHES["chamfer"] == 0
    for level in levels:
        for cam_id in rig.ids:
            paths = [imagetypes.gen_filename(str(tmp_path / out), "disparity_levels", level, cam_id, "000000", "pfm")
                     for out in ("card", "host")]
            card, host = (open(p, "rb").read() for p in paths)
            assert card == host, (level, cam_id)


def test_2k_frame_job_same_pfms_with_one_io_thread_and_the_hosts(dev, tmp_path, monkeypatch):
    """A 16-camera sphere16 frame job on the card (2048x1536, ten levels):
    the estimator's pool of one host thread and of the host's cores writes
    the same PFMs at every level, and ``derp.pool.files`` counts the files
    of each level: 16 colors read, 16 PFMs written, and 16 coarser PFMs
    read below the coarsest level."""
    from concurrent.futures import ThreadPoolExecutor

    from facebook360_dep_tpu_torch.cli import derp_cli
    from facebook360_dep_tpu_torch.core import imagetypes, io

    widths = (2048, 1024, 512, 256, 200, 128, 100, 80, 60, 50)
    sizes = [(w, (3 * w + 2) // 4) for w in widths]
    rig = synthetic.make_test_rig(16, sizes[0], ring_radius=0.3)
    root = str(tmp_path / "project")

    def write(level, cam_id, color):
        d = imagetypes.image_dir(root, "color_levels", level, cam_id)
        os.makedirs(d, exist_ok=True)
        io.write_color(os.path.join(d, "000000.png"), color, bit_depth=16)

    with ThreadPoolExecutor(8) as pool:
        for level, size in enumerate(sizes):
            colors = synthetic.render_sphere_scene(rig, size, radius=5.0, device=dev)[0].cpu().numpy()
            list(pool.map(write, [level] * 16, rig.ids, colors))
    os.makedirs(os.path.join(root, "rigs"))
    tcam.save_rig(os.path.join(root, "rigs/rig_calibrated.json"), rig)
    argv = ["--input_root", root, "--min_depth_m", "1", "--max_depth_m", "100", "--resolution", "2048"]

    host_cores = len(os.sched_getaffinity(0))
    outs = {}
    for cores in (1, host_cores):
        monkeypatch.setattr(os, "sched_getaffinity", lambda pid, n=cores: set(range(n)))
        outs[cores] = str(tmp_path / f"out{cores}")
        est = derp_cli.main(argv + ["--output_root", outs[cores]], device=dev)
        assert est.io_workers == cores
        assert {lv: est.spans.counts[("000000", lv)]["derp.pool.files"] for lv in range(10)} == {
            lv: 16 * (2 if lv == 9 else 3) for lv in range(10)}
    for level in range(10):
        for cam_id in rig.ids:
            one, many = (open(imagetypes.gen_filename(outs[n], "disparity_levels", level, cam_id, "000000", "pfm"),
                              "rb").read() for n in (1, host_cores))
            assert one == many, (level, cam_id)


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


def test_sharded_level_over_nccl_equals_process_level(dev):
    """One NCCL rank on the card (parallel/sharding.py, the production
    backend): the level solve on the camera mesh, with its disparity
    all-gather before the mismatch stage, equals process_level bit for
    bit."""
    import torch.distributed as dist

    from facebook360_dep_tpu_torch.parallel import multihost, sharding
    from torch_ranks import free_port

    w, h = 96, 72
    rig = tcam.normalize_rig(ring_rig(tcam, "", n=8, resolution=(w, h), mixed=True))
    colors, gt = synthetic.render_sphere_scene(rig, (w, h), device=dev)
    ctx = solver.make_level_context(rig, rig, colors, pipeline.generate_fov_masks(rig, (h, w), dev),
                                    var_high_thresh=1e-2)
    cfg = solver.SolverConfig(min_depth=1.0, max_depth=100.0, level=0, num_levels=2, mismatches_start_level=0)
    init = (gt * 1.5).contiguous()
    want = solver.process_level(ctx, cfg, init_disparity=init)
    assert multihost.maybe_initialize(coordinator_address=f"127.0.0.1:{free_port()}", num_processes=1,
                                      process_id=0, device=dev)
    try:
        assert dist.get_backend() == "nccl"
        mesh = sharding.camera_mesh()
        got = sharding.gather_result(sharding.process_level_sharded(ctx, cfg, mesh, init_disparity=init), mesh)
    finally:
        multihost.shutdown()
    assert want["mismatches"].any()
    for k, v in want.items():
        a, b = (x.view(torch.int32) if x.dtype == torch.float32 else x for x in (got[k], v))
        assert torch.equal(a, b), k


# The TPU sampler's semantics (use_pallas_sampler=True): the anchor kernel,
# K1 and K3 in TPU mode against their twins at the JAX package's test
# shapes (whole tiles or not), a coarse ragged shape and the first K3
# level, with the default windows and with small ones that clip.
TPU_SHAPES = [(200, 50), (256, 48), (208, 49), (61, 45), (512, 384)]
TPU_WINDOWS = [None, (128, 16)]


def _tpu_level(dev, w, h, n=8):
    """A use_pallas_sampler level context of a mixed-type distorted ring and
    scattered candidate maps (depths 0.5-100 m), which clip."""
    rig = tcam.normalize_rig(ring_rig(tcam, "", n=n, resolution=(w, h), mixed=True))
    colors, _ = synthetic.render_sphere_scene(rig, (w, h), device=dev)
    ctx = solver.make_level_context(rig, rig, colors, pipeline.generate_fov_masks(rig, (h, w), dev),
                                    use_pallas_sampler=True)
    gen = torch.Generator(device=dev).manual_seed(w + h)
    return ctx, (0.01 + 1.99 * torch.rand((n, h, w), generator=gen, device=dev)).contiguous()


def _tpu_args(ctx, disp):
    return ctx.src_params, ctx.dst_cams.position, disp, ctx.dst_rays


@pytest.mark.parametrize("window", TPU_WINDOWS)
@pytest.mark.parametrize("w,h", TPU_SHAPES)
def test_tile_windows_matches_twin(dev, w, h, window):
    """Anchors over both paddings: the kernel projects as K1 and K3 do, the
    twin as PyTorch on the card; a coordinate an ulp apart moves a tile's
    span centre across an alignment step at < 2% of (tile, source) pairs,
    and then by one step."""
    ctx, disp = _tpu_level(dev, w, h)
    for reflect in (False, True):
        k = wc.tile_windows(*_tpu_args(ctx, disp), (h, w), window, reflect=reflect)
        p = wc.tile_windows_plain(*_tpu_args(ctx, disp), (h, w), window, reflect=reflect)
        assert k.shape == p.shape == (8, 8, -(-h // 24), -(-w // 128), 2) and k.dtype == torch.int32
        same = (k == p).all(-1)
        assert same.double().mean().item() >= 0.98
        step = torch.tensor([128, 8], device=dev)
        assert ((k - p).abs() <= step).all()


@pytest.mark.parametrize("n", [4, 15, 16, 150])
@pytest.mark.parametrize("w,h", [(208, 49), (61, 45)])
def test_tile_windows_all_maps_equal_one_map_launches(dev, w, h, n):
    """The anchor kernel's one launch for all D maps equals the stack of its
    one-map launches bit for bit, for rigs of 4, 15, 16 and 150 sources
    (past 48 KB of shared memory a block), edge and reflect padding, 8- and
    16-row alignment, on shapes with partial right and bottom tiles, with a
    tile no source sees (disparity 0 there: (0, 0)) and a small window; and
    it holds the twin to the bound of test_tile_windows_matches_twin."""
    ctx, disp = _tpu_level(dev, w, h, n=n)
    disp[1, :24, :min(w, 128)] = 0.0
    args = _tpu_args(ctx, disp)
    for reflect in (False, True):
        for align in (8, 16):
            wc.reset_launch_counts()
            k = wc.tile_windows(*args, (h, w), (128, 16), align, reflect)
            assert wc.LAUNCHES["tile_windows"] == 1
            assert k.shape == (n, n, -(-h // 24), -(-w // 128), 2) and k.dtype == torch.int32
            one = torch.stack([wc.tile_windows(args[0], *a, (h, w), (128, 16), align, reflect)
                               for a in zip(*args[1:])])
            assert torch.equal(k, one)
            assert not k[1, :, 0, 0].any()
            p = wc.tile_windows_plain(*args, (h, w), (128, 16), align, reflect)
            assert (k == p).all(-1).double().mean().item() >= 0.98
            assert ((k - p).abs() <= torch.tensor([128, align], device=dev)).all()


@pytest.mark.parametrize("window", TPU_WINDOWS)
@pytest.mark.parametrize("w,h", TPU_SHAPES)
def test_project_sample_tpu_matches_twin(dev, w, h, window):
    """K1 in TPU mode on the kernel's anchors, C = 3 on the quantized stack
    (all D maps in one launch) and C = 2 on the mismatch stage's planes:
    flags agree but for < 1e-3 of (source, pixel) pairs (coordinates an ulp
    apart at a window edge), samples are bit-equal at >= 99.5% of the
    pixels both call valid (k/256 sources; C = 2 within 1e-6 relative) and
    within 1/256 px elsewhere."""
    ctx, disp = _tpu_level(dev, w, h)
    args = _tpu_args(ctx, disp)
    anchors = wc.tile_windows(*args, (h, w), window)
    wc.reset_launch_counts()
    s_k, v_k, c_k = wc.project_sample_tpu(ctx.src_tpu, *args, anchors, window)
    assert wc.LAUNCHES["project_sample_tpu"] == 1 and wc.LAUNCHES["project_sample"] == 0
    s_p, v_p, c_p = wc.project_sample_tpu_plain(wc.planar_view(ctx.src_tpu), *args, anchors, window)
    assert c_p.any(), "nothing clipped"
    for a, b in ((v_k, v_p), (c_k, c_p)):
        assert (a != b).double().mean().item() < 1e-3
    both = (v_k & v_p)[:, :, None].expand_as(s_k)
    assert (s_k == s_p)[both].double().mean().item() >= 0.995
    assert (s_k - s_p)[both].abs().max().item() <= 2.0 / 256.0
    assert not s_k[~v_k[:, :, None].expand_as(s_k)].any()
    full = torch.where(torch.rand(disp.shape, device=dev) < 0.05, float("nan"), disp)
    planes = torch.stack([torch.nan_to_num(full), torch.isfinite(full).float()], dim=1)
    d_k, dv_k, dc_k = wc.project_sample_planes_tpu(planes, *args, anchors, window)
    d_p, dv_p, dc_p = wc.project_sample_tpu_plain(planes, *args, anchors, window)
    assert (dv_k != dv_p).double().mean().item() < 1e-3 and (dc_k != dc_p).double().mean().item() < 1e-3
    b2 = (dv_k & dv_p)[:, :, None].expand_as(d_k)
    rel = (d_k - d_p)[b2].abs() / (1 + d_p[b2].abs())
    assert (rel <= 1e-6).double().mean().item() >= 0.995


@pytest.mark.parametrize("window", TPU_WINDOWS)
@pytest.mark.parametrize("w,h", TPU_SHAPES)
def test_cost_fused_tpu_matches_twin(dev, w, h, window):
    """K3 in TPU mode on the kernel's reflect-padded anchors against its
    twin, destination 3: FLT_MAX patterns agree but for < 1e-2 of the
    pixels (a flag an ulp apart reaches a patch of 9 and the clip guard),
    costs within 1e-4 relative at >= 99% of the pixels both evaluate,
    confidence equal at >= 99.9%."""
    ctx, disp = _tpu_level(dev, w, h)
    cctx = solver.cost_context(ctx)
    one = (cctx.src_params, cctx.cam_dst.position[3], disp[3], cctx.dst_rays[3])
    rest = (cctx.dst_planar[3], cctx.variance[3], cctx.exclude_idx[3])
    anchors = wc.tile_windows(*one, (h, w), window, reflect=True)
    wc.reset_launch_counts()
    c_k, f_k = wc.cost_fused_tpu(ctx.src_tpu, *one, *rest, anchors, window)
    assert wc.LAUNCHES["cost_fused_tpu"] == 1 and wc.LAUNCHES["cost_fused"] == 0
    c_p, f_p = wc.cost_fused_tpu_plain(wc.planar_view(ctx.src_tpu), *one, *rest, anchors, window)
    fin_k, fin_p = c_k < FLT_MAX, c_p < FLT_MAX
    assert (fin_k != fin_p).double().mean().item() < 1e-2
    assert (~fin_p).any() and fin_p.any()
    both = fin_k & fin_p
    rel = (c_k[both] - c_p[both]).abs() / (1 + c_p[both].abs())
    assert (rel <= 1e-4).double().mean().item() >= 0.99
    assert (f_k == f_p).double().mean().item() >= 0.999


@pytest.mark.parametrize("w,h", [(208, 49), (512, 384)])
def test_cost_for_disparity_tpu_mode_launches(dev, w, h):
    """cost_for_disparity on a use_pallas_sampler context launches the TPU
    modes and never the default kernels: one anchor launch for all maps,
    then below 512x384 one K1 launch for all maps and K2 a map, from there
    up a K3 launch a map; the default context's costs are those of the
    default kernels."""
    ctx, disp = _tpu_level(dev, w, h)
    wc.reset_launch_counts()
    cost, conf = cost_ops.cost_for_disparity(solver.cost_context(ctx), disp, window=(128, 16))
    d = disp.shape[0]
    if w * h < cost_ops.FUSED_MIN_PIXELS:
        want = dict(tile_windows=1, project_sample_tpu=1, ssd_combine=d)
    else:
        want = dict(tile_windows=1, cost_fused_tpu=d)
    assert {k: v for k, v in wc.LAUNCHES.items() if v} == want
    assert (cost == FLT_MAX).any() and (cost < FLT_MAX).any()
