"""The joint bilateral of a level (ops/warp_cuda.py::joint_bilateral, the
kernel csrc/joint_bilateral.cu) on the CPU, where it runs its plain twin:
the stack of per-map filters.joint_bilateral calls, bit for bit, and the
solver's bilateral stage through it, one call a level.
tests/test_torch_cuda.py holds the kernel to the twin on the card."""

import numpy as np
import pytest
import torch

from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.depth import pipeline, solver
from facebook360_dep_tpu_torch.ops import filters
from facebook360_dep_tpu_torch.ops import warp_cuda as wc
from facebook360_dep_tpu_torch.render import synthetic

from torch_parity import ring_rig

N = 16  # sources of the rig the maps are guided by


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-for-bit equality (NaN payloads and signed zeros included)."""
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _inputs(d, w, h, seed, circle=False, nonfinite=False):
    """Colors (N, H, W, 3) in steps of 1/65535 (a PNG16's) with edges and
    texture, D maps' sources, disparities and masks with holes (and an
    image circle); with ``nonfinite`` NaN, +inf and -inf disparities at
    masked-out pixels, which the taps of masked-in neighbours still read."""
    rng = np.random.RandomState(seed)
    ramp = np.linspace(0.0, 1.0, w)[None, None, :, None] * rng.rand(N, 1, 1, 3)
    step = (np.arange(h)[None, :, None, None] > h // 2) * 0.3 * rng.rand(N, 1, 1, 3)
    colors = np.clip(ramp + step + 0.02 * rng.rand(N, h, w, 3), 0.0, 1.0)
    colors = (np.round(colors * 65535.0) / 65535.0).astype(np.float32)
    dst2src = tuple(int(s) for s in rng.choice(N, d, replace=False))
    disp = (0.1 + 0.2 * rng.rand(d, h, w)).astype(np.float32)
    mask = rng.rand(d, h, w) > 0.2
    mask[:, h // 3:h // 2, w // 4:w // 2] = False
    if circle:
        yy, xx = np.mgrid[0:h, 0:w]
        mask &= ((xx + 0.5 - w / 2) / (0.5 * w)) ** 2 + ((yy + 0.5 - h / 2) / (0.5 * w)) ** 2 < 1.0
    if nonfinite:
        hole = ~mask
        for value, share in ((np.nan, 0.03), (np.inf, 0.01), (-np.inf, 0.01)):
            disp[hole & (rng.rand(d, h, w) < share)] = value
    return torch.from_numpy(colors), dst2src, torch.from_numpy(disp), torch.from_numpy(mask)


def _per_map(colors, dst2src, disp, mask, radius):
    """filters.joint_bilateral of each map, guided by its source's colors."""
    return torch.stack([filters.joint_bilateral(disp[i], colors[s], mask[i], radius)
                        for i, s in enumerate(dst2src)])


@pytest.mark.parametrize("radius", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("d", [1, 3, 16])
def test_joint_bilateral_on_cpu_equals_per_map_calls(d, radius):
    """The wrapper on CPU tensors is the stack of the per-map filter calls,
    guided from the interleaved stack in place, and counts no launch."""
    colors, dst2src, disp, mask = _inputs(d, 61, 45, seed=10 * d + radius)
    wc.reset_launch_counts()
    got = wc.joint_bilateral(wc.rgba_stack(colors), dst2src, disp, mask, radius)
    assert got.shape == (d, 45, 61) and got.dtype == torch.float32
    assert _same(got, _per_map(colors, dst2src, disp, mask, radius))
    assert _same(got, wc.joint_bilateral_plain(wc.rgba_stack(colors), dst2src, disp, mask, radius))
    assert not torch.equal(got, disp)
    assert all(v == 0 for v in wc.LAUNCHES.values()) and not wc.LAUNCHES_BY_SHAPE


# the solve's coarsest shapes of both configurations, a ragged one, and
# 2048x1317 scaled down by 32
@pytest.mark.parametrize("radius", [2, 5])
@pytest.mark.parametrize("w,h", [(61, 45), (50, 38), (50, 32), (64, 41)])
def test_joint_bilateral_ragged_circles_and_nonfinite_taps(w, h, radius):
    """Image-circle masks with holes and non-finite disparities under
    masked-out taps: a masked-out tap adds 0 x its disparity, so a NaN or
    an infinity there makes the masked-in neighbours NaN, as in the per-map
    filter; masked-out centres pass through, non-finite ones included."""
    colors, dst2src, disp, mask = _inputs(16, w, h, seed=w + h + radius, circle=True, nonfinite=True)
    got = wc.joint_bilateral(wc.rgba_stack(colors), dst2src, disp, mask, radius)
    assert _same(got, _per_map(colors, dst2src, disp, mask, radius))
    assert _same(got[~mask], disp[~mask]) and not torch.isfinite(disp[~mask]).all()
    assert torch.isnan(got[mask]).any() and torch.isfinite(got[mask]).any()


def test_joint_bilateral_validates_its_inputs():
    colors, dst2src, disp, mask = _inputs(3, 20, 12, seed=3)
    rgba = wc.rgba_stack(colors)
    for bad, match in (((rgba, dst2src, disp.double(), mask, 2), "dtype"),
                       ((rgba, dst2src, disp, mask.float(), 2), "dtype"),
                       ((rgba, dst2src[:2], disp, mask, 2), "shape"),
                       ((rgba[..., :3], dst2src, disp, mask, 2), "shape"),
                       ((rgba, dst2src, disp.transpose(1, 2).contiguous().transpose(1, 2), mask, 2), "contiguous"),
                       ((rgba, dst2src, disp, mask, 0), "radius"),
                       ((rgba, dst2src, disp, mask, 6), "radius"),
                       ((rgba, (0, 1, N), disp, mask, 2), "sources"),
                       ((rgba, (), disp[:0], mask[:0], 2), "maps")):
        with pytest.raises(ValueError, match=match):
            wc.joint_bilateral(*bad)


@pytest.fixture(scope="module")
def level():
    """A level context of a 4-camera mixed-type distorted ring (every camera
    a destination), one with foreground masks that have holes, and noisy
    start maps."""
    w, h, n = 48, 36, 4
    rig = tcam.normalize_rig(ring_rig(tcam, "", n=n, resolution=(w, h), mixed=True))
    colors, gt = synthetic.render_sphere_scene(rig, (w, h), radius=5.0)
    ctx = solver.make_level_context(rig, rig, colors, pipeline.generate_fov_masks(rig, (h, w)), full_height=60)
    rng = np.random.RandomState(5)
    init = (torch.nan_to_num(gt, nan=1e-4) * torch.from_numpy(1.0 + 0.04 * rng.randn(n, h, w))).float()
    fg = torch.from_numpy(rng.rand(n, h, w) > 0.3)
    return rig, colors, ctx, ctx._replace(dst_fg_masks=fg, dst_bg_disp=0.8 * init), init


def _per_map_stage(ctx, cfg, disparity):
    """The bilateral stage a map at a time, as the solver ran it before its
    kernel: each map's filter guided by its source's colors, then
    where(fg, filtered, disparity)."""
    radius = max(int(np.ceil(filters.BILATERAL_SPACE_RADIUS_MAX * 0.9 ** cfg.level)), 1)
    return torch.stack([
        torch.where(ctx.dst_fg_masks[i],
                    filters.joint_bilateral(disparity[i], ctx.src_imgs[s][..., :3],
                                            ctx.dst_fov_masks[i] & ctx.dst_fg_masks[i], radius),
                    disparity[i])
        for i, s in enumerate(ctx.dst2src)])


def _spy(monkeypatch):
    """Count the solver's calls of warp_cuda.joint_bilateral and their radii."""
    calls = []
    real = wc.joint_bilateral

    def spy(src_rgba, dst2src, disparity, mask, radius):
        calls.append((tuple(dst2src), tuple(disparity.shape), radius))
        return real(src_rgba, dst2src, disparity, mask, radius)

    monkeypatch.setattr(solver.warp_cuda, "joint_bilateral", spy)
    return calls


@pytest.mark.parametrize("fg", [False, True])
@pytest.mark.parametrize("level_index", [0, 5, 9])
def test_spatial_bilateral_one_call_equals_the_per_map_stage(level, monkeypatch, level_index, fg):
    """spatial_bilateral is one call for all the level's maps, at the
    level's radius (5, 3, 2), and gives the bits of the per-map stage, with
    foreground masks or without."""
    _, _, ctx, ctx_fg, init = level
    ctx = ctx_fg if fg else ctx
    cfg = solver.SolverConfig(level=level_index, num_levels=10)
    calls = _spy(monkeypatch)
    got = solver.spatial_bilateral(ctx, cfg, init)
    assert calls == [((0, 1, 2, 3), (4, 36, 48), {0: 5, 5: 3, 9: 2}[level_index])]
    assert _same(got, _per_map_stage(ctx, cfg, init))
    assert not torch.equal(got, init)


def test_spatial_bilateral_on_a_block_context(level, monkeypatch):
    """A rank's block of the level (make_level_context(destinations=)): its
    maps guided by their sources among all the level's, in one call, as
    the whole level's stage gives them."""
    rig, colors, _, _, init = level
    fov = pipeline.generate_fov_masks(rig, (36, 48))
    whole = solver.make_level_context(rig, rig, colors, fov, full_height=60)
    block = solver.make_level_context(rig, rig, colors, fov, full_height=60, destinations=[3, 1])
    cfg = solver.SolverConfig(level=1, num_levels=10)
    calls = _spy(monkeypatch)
    got = solver.spatial_bilateral(block, cfg, init[[3, 1]])
    assert calls == [((3, 1), (2, 36, 48), 5)]
    assert _same(got, solver.spatial_bilateral(whole, cfg, init)[[3, 1]])


@pytest.mark.parametrize("bilateral", [True, False])
def test_process_level_calls_the_bilateral_once(level, monkeypatch, bilateral):
    """process_level filters all its maps with one joint_bilateral call (none
    with do_bilateral_filter off), and its maps are those of the per-map
    stage run in its place."""
    _, _, ctx, _, init = level
    cfg = solver.SolverConfig(min_depth=1.0, max_depth=100.0, level=1, num_levels=3,
                              do_bilateral_filter=bilateral)
    calls = _spy(monkeypatch)
    got = solver.process_level(ctx, cfg, init_disparity=init)
    assert len(calls) == int(bilateral)
    monkeypatch.setattr(solver, "spatial_bilateral", _per_map_stage)
    want = solver.process_level(ctx, cfg, init_disparity=init)
    assert len(calls) == int(bilateral)
    for k in want:
        assert _same(got[k], want[k]) if got[k].dtype == torch.float32 else torch.equal(got[k], want[k]), k
