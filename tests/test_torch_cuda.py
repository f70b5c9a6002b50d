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
    cctx = solver._cost_ctx(ctx, 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    disp = (gt[0] * (1.0 + 0.05 * (2 * torch.rand((h, w), generator=gen, device=dev) - 1))).contiguous()
    return cctx, disp, gt


def _k1(cctx, disp, src=None):
    return (cctx.src_planar if src is None else src, cctx.src_params, cctx.cam_dst.position, disp, cctx.dst_rays)


@pytest.mark.parametrize("channels", [1, 3])
def test_project_sample_matches_twin(inputs, channels):
    """Built with -fmad=false, the kernel rounds as the twin does: validity
    identical but for atan2f-ulp edge flips, samples to 1e-6."""
    cctx, disp, gt = inputs
    src = cctx.src_planar if channels == 3 else gt[:, None].contiguous()
    s_k, v_k = wc.project_sample(*_k1(cctx, disp, src))
    s_p, v_p = wc.project_sample_plain(*_k1(cctx, disp, src))
    assert (v_k != v_p).double().mean().item() < 1e-3
    both = (v_k & v_p)[:, None].expand_as(s_k)
    assert (s_k[both] - s_p[both]).abs().max().item() < 1e-6
    assert (s_k[~v_k[:, None].expand_as(s_k)] == 0).all()


def test_ssd_combine_matches_twin(inputs):
    cctx, disp, _ = inputs
    s, v = wc.project_sample_plain(*_k1(cctx, disp))
    c_k, f_k = wc.ssd_combine(s, v, cctx.dst_planar, cctx.variance, cctx.exclude_idx)
    c_p, f_p = wc.ssd_combine_plain(s, v, cctx.dst_planar, cctx.variance, cctx.exclude_idx)
    assert torch.equal(c_k >= FLT_MAX, c_p >= FLT_MAX)
    ok = c_p < FLT_MAX
    assert ((c_k[ok] - c_p[ok]).abs() / (1 + c_p[ok].abs())).max().item() < 1e-5
    assert torch.equal(f_k, f_p)


def test_cost_fused_equals_k1_then_k2_and_twin(inputs):
    cctx, disp, _ = inputs
    rest = (cctx.dst_planar, cctx.variance, cctx.exclude_idx)
    rgba = wc.rgba_stack(cctx.src_planar.permute(0, 2, 3, 1))
    c3, f3 = wc.cost_fused(*_k1(cctx, disp, rgba), *rest)
    s, v = wc.project_sample(*_k1(cctx, disp))
    c12, f12 = wc.ssd_combine(s, v, *rest)
    assert torch.equal(c3, c12) and torch.equal(f3, f12)
    c_p, _ = wc.cost_fused_plain(*_k1(cctx, disp), *rest)
    both = (c3 < FLT_MAX) & (c_p < FLT_MAX)
    assert ((c3 >= FLT_MAX) != (c_p >= FLT_MAX)).double().mean().item() < 1e-3
    assert ((c3[both] - c_p[both]).abs() / (1 + c_p[both].abs())).max().item() < 1e-4
    with pytest.raises(ValueError, match="src_rgba"):  # the planar stack is not K3's layout
        wc.cost_fused(*_k1(cctx, disp), *rest)


def _level(dev, w, h, n=16):
    """Destination 3's cost context (not the first source, so the skipped
    self source sits inside K2's source loop) on a mixed-type distorted
    ring of ``n`` cameras at (w, h), with a noisy candidate map."""
    rig = tcam.normalize_rig(ring_rig(tcam, "", n=n, resolution=(w, h), mixed=True))
    colors, gt = synthetic.render_sphere_scene(rig, (w, h), device=dev)
    ctx = solver.make_level_context(rig, rig, colors, pipeline.generate_fov_masks(rig, (h, w), dev))
    cctx = solver._cost_ctx(ctx, 3)
    gen = torch.Generator(device=dev).manual_seed(w + h)
    noise = 1.0 + 0.05 * (2 * torch.rand((h, w), generator=gen, device=dev) - 1)
    disp = (torch.nan_to_num(gt[3], nan=1e-4) * noise).contiguous()
    return cctx, disp


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
        s, v = wc.project_sample_plain(*_k1(cctx, disp))
        s, dst = s[:, :channels].contiguous(), cctx.dst_planar[:channels].contiguous()
        c_k, f_k = wc.ssd_combine(s, v, dst, cctx.variance, cctx.exclude_idx)
        c_p, f_p = wc.ssd_combine_plain(s, v, dst, cctx.variance, cctx.exclude_idx)
        assert torch.equal(c_k >= FLT_MAX, c_p >= FLT_MAX)
        ok = c_p < FLT_MAX
        assert ok.double().mean().item() > 0.5
        bad = (c_k[ok] - c_p[ok]).abs() > 1e-6 + 1e-4 * c_p[ok].abs()
        assert bad.double().mean().item() <= 1e-4, (n, channels)
        assert torch.equal(f_k, f_p)


@pytest.mark.parametrize("w,h", LEVEL_SHAPES)
def test_cost_fused_bit_identical_to_k1_then_k2_at_level_shapes(dev, w, h):
    """K3 on the interleaved stack the level context builds (or builds here
    below FUSED_MIN_PIXELS) == K1 then K2, bit for bit, and its twin; from
    FUSED_MIN_PIXELS up the context's planar stack is a view, which K1
    takes as a contiguous copy."""
    cctx, disp = _level(dev, w, h)
    rgba = cctx.src_rgba if cctx.src_rgba is not None else wc.rgba_stack(cctx.src_planar.permute(0, 2, 3, 1))
    assert (cctx.src_rgba is not None) == (w * h >= cost_ops.FUSED_MIN_PIXELS)
    rest = (cctx.dst_planar, cctx.variance, cctx.exclude_idx)
    c3, f3 = wc.cost_fused(*_k1(cctx, disp, rgba), *rest)
    s, v = wc.project_sample(*_k1(cctx, disp, cctx.src_planar.contiguous()))
    c12, f12 = wc.ssd_combine(s, v, *rest)
    assert torch.equal(c3, c12) and torch.equal(f3, f12)
    assert (c3 < FLT_MAX).double().mean().item() > 0.5
    c_p, f_p = wc.cost_fused_plain(*_k1(cctx, disp), *rest)
    assert ((c3 >= FLT_MAX) != (c_p >= FLT_MAX)).double().mean().item() < 1e-3
    both = (c3 < FLT_MAX) & (c_p < FLT_MAX)
    assert ((c3[both] - c_p[both]).abs() > 1e-6 + 1e-4 * c_p[both].abs()).double().mean().item() <= 1e-4


def test_wrappers_validate_and_count(inputs):
    cctx, disp, _ = inputs
    wc.reset_launch_counts()
    wc.project_sample(*_k1(cctx, disp))
    wc.project_sample_plain(*_k1(cctx, disp))
    assert wc.LAUNCHES == {"project_sample": 1, "ssd_combine": 0, "cost_fused": 0, "warp_sample": 0}
    assert wc.LAUNCHES_BY_SHAPE == {("project_sample", *disp.shape): 1}
    with pytest.raises(ValueError, match="contiguous"):
        wc.project_sample(*_k1(cctx, disp.t().contiguous().t()))
    with pytest.raises(ValueError, match="dtype"):
        wc.project_sample(*_k1(cctx, disp.double()))
    with pytest.raises(ValueError, match="on cpu"):
        wc.project_sample(*_k1(cctx, disp.cpu()))
    with pytest.raises(ValueError, match="C=4"):
        wc.project_sample(*_k1(cctx, disp, cctx.src_planar[:, :1].expand(-1, 4, -1, -1).contiguous()))
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
    src = torch.cat([cctx.src_planar[:1].expand(8, -1, -1, -1), disp[:, None]], 1)[:, -channels:].contiguous()
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
