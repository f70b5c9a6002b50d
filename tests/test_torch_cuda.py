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
from facebook360_dep_tpu_torch.ops import warp_cuda as wc
from facebook360_dep_tpu_torch.render import synthetic

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
    c3, f3 = wc.cost_fused(*_k1(cctx, disp), *rest)
    s, v = wc.project_sample(*_k1(cctx, disp))
    c12, f12 = wc.ssd_combine(s, v, *rest)
    assert torch.equal(c3, c12) and torch.equal(f3, f12)
    c_p, _ = wc.cost_fused_plain(*_k1(cctx, disp), *rest)
    both = (c3 < FLT_MAX) & (c_p < FLT_MAX)
    assert ((c3 >= FLT_MAX) != (c_p >= FLT_MAX)).double().mean().item() < 1e-3
    assert ((c3[both] - c_p[both]).abs() / (1 + c_p[both].abs())).max().item() < 1e-4


def test_wrappers_validate_and_count(inputs):
    cctx, disp, _ = inputs
    wc.reset_launch_counts()
    wc.project_sample(*_k1(cctx, disp))
    wc.project_sample_plain(*_k1(cctx, disp))
    assert wc.LAUNCHES == {"project_sample": 1, "ssd_combine": 0, "cost_fused": 0}
    with pytest.raises(ValueError, match="contiguous"):
        wc.project_sample(*_k1(cctx, disp.t().contiguous().t()))
    with pytest.raises(ValueError, match="dtype"):
        wc.project_sample(*_k1(cctx, disp.double()))
    with pytest.raises(ValueError, match="on cpu"):
        wc.project_sample(*_k1(cctx, disp.cpu()))
    with pytest.raises(ValueError, match="C=4"):
        wc.project_sample(*_k1(cctx, disp, cctx.src_planar[:, :1].expand(-1, 4, -1, -1).contiguous()))
    assert wc.LAUNCHES["project_sample"] == 1
