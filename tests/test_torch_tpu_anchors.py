"""The anchors of the TPU sampler's semantics (ops/warp_cuda.py's
tile_windows, ops/cost.py::_cost_tpu) on the CPU, through the twins.

A cost evaluation on a use_pallas_sampler context takes the anchors of all
its D maps from one call, on either side of FUSED_MIN_PIXELS: reflect-padded
tiles for K3 in TPU mode from there up, edge-padded ones for K1 in TPU mode
below. Each map's anchors are those of a call for that map alone, so the
costs and confidences equal, bit for bit, those of a call a map.
"""

import numpy as np
import pytest
import torch

from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.depth import pipeline, solver
from facebook360_dep_tpu_torch.ops import cost as cost_ops
from facebook360_dep_tpu_torch.ops import warp_cuda as wc
from facebook360_dep_tpu_torch.render import synthetic

from torch_parity import ring_rig

SMALL = (128, 16)  # (ww_max, wh_max): below the defaults 256 x 40, so tiles clip


def _tpu_level(w, h, n=4, d=2, seed=0):
    """A use_pallas_sampler cost context of a mixed-type distorted ring on
    the CPU (its first ``d`` destinations) and scattered candidate maps
    (depths 0.5-100 m, drawn with numpy) for them."""
    rig = tcam.normalize_rig(ring_rig(tcam, "", n=n, resolution=(w, h), mixed=True))
    colors, _ = synthetic.render_sphere_scene(rig, (w, h))
    ctx = solver.make_level_context(rig, rig, colors, pipeline.generate_fov_masks(rig, (h, w), "cpu"),
                                    use_pallas_sampler=True)
    cctx = solver.cost_context(solver.select_destinations(ctx, list(range(d))))
    disp = 0.01 + 1.99 * np.random.RandomState(seed).random_sample((d, h, w))
    return cctx, torch.from_numpy(disp.astype(np.float32))


def _per_map_costs(cctx, disp, window):
    """_cost_tpu with the anchors of one map a call: K3 in TPU mode a map
    from FUSED_MIN_PIXELS up, else K1 in TPU mode a map, K2 and the clip
    guard."""
    d, _, h, w = cctx.dst_planar.shape
    src_hw = tuple(cctx.src_tpu.shape[1:3])
    pos, rays, params, align = cctx.cam_dst.position, cctx.dst_rays, cctx.src_params, cctx.tpu_align
    lanes = torch.arange(params.shape[0])[:, None, None]
    costs, confs = [], []
    for i in range(d):
        one = (params, pos[i], disp[i], rays[i])
        if h * w >= cost_ops.FUSED_MIN_PIXELS:
            anchors = wc.tile_windows(*one, src_hw, window, align, reflect=True)
            cost, conf = wc.cost_fused_tpu(cctx.src_tpu, *one, cctx.dst_planar[i], cctx.variance[i],
                                           cctx.exclude_idx[i], anchors, window, align)
        else:
            anchors = wc.tile_windows(*one, src_hw, window, align)
            sampled, valid, clipped = wc.project_sample_tpu(cctx.src_tpu, *one, anchors, window, align)
            cost, conf = wc.ssd_combine(sampled, valid, cctx.dst_planar[i], cctx.variance[i], cctx.exclude_idx[i])
            any_clip = (clipped & (lanes != cctx.exclude_idx[i])).any(dim=0)
            cost = torch.where(any_clip, cost_ops.FLT_MAX, cost)
        costs.append(cost)
        confs.append(conf)
    return torch.stack(costs), torch.stack(confs)


@pytest.mark.parametrize("w,h", [(208, 49), (512, 384)])
def test_cost_tpu_one_anchor_call_equals_per_map_calls(monkeypatch, w, h):
    """On both sides of FUSED_MIN_PIXELS (208x49: K1 then K2; 512x384: K3),
    cost_for_disparity takes every map's anchors from one tile_windows call
    (reflect-padded from FUSED_MIN_PIXELS up) and its costs and
    confidences equal those of anchors computed a map."""
    assert (w * h >= cost_ops.FUSED_MIN_PIXELS) == (w == 512)
    cctx, disp = _tpu_level(w, h)
    calls = []
    real = wc.tile_windows

    def counted(*args, **kwargs):
        calls.append((tuple(args[2].shape), kwargs.get("reflect", False)))
        return real(*args, **kwargs)

    monkeypatch.setattr(wc, "tile_windows", counted)
    cost, conf = cost_ops.cost_for_disparity(cctx, disp, window=SMALL)
    assert calls == [(tuple(disp.shape), w == 512)]
    monkeypatch.setattr(wc, "tile_windows", real)
    want_cost, want_conf = _per_map_costs(cctx, disp, SMALL)
    assert torch.equal(cost, want_cost) and torch.equal(conf, want_conf)
    assert (cost == cost_ops.FLT_MAX).any() and (cost < cost_ops.FLT_MAX).any()


@pytest.mark.parametrize("reflect", [False, True])
@pytest.mark.parametrize("align", [8, 16])
def test_tile_windows_plain_all_maps_equal_per_map_calls(reflect, align):
    """The twin on D maps is the stack of its one-map calls, on a ragged
    shape (partial right and bottom tiles) with a tile no source sees
    (disparity 0 there): its anchors are (0, 0)."""
    w, h = 208, 49
    cctx, disp = _tpu_level(w, h, n=5, d=3, seed=1)
    disp[1, :24, :128] = 0.0
    args = (cctx.src_params, cctx.cam_dst.position, disp, cctx.dst_rays)
    got = wc.tile_windows_plain(*args, (h, w), SMALL, align, reflect)
    assert got.shape == (3, 5, 3, 2, 2) and got.dtype == torch.int32
    want = torch.stack([wc.tile_windows_plain(args[0], *one, (h, w), SMALL, align, reflect)
                        for one in zip(*args[1:])])
    assert torch.equal(got, want)
    assert not got[1, :, 0, 0].any()
