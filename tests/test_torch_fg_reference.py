"""The port's foreground pass against the benchmark's plain reference of it
(depbench/reference/solve_fg.py), on the CPU at a small size: each
foreground branch alone (brute force, random proposals, ping-pong, the
bilateral, the median, the init between levels), the whole pyramid of
``derp_cli --use_foreground_masks`` on a tiny tree, and the reference's
chamfer labels against cv2.distanceTransformWithLabels.

Every comparison is bit for bit: the reference writes each elementwise
expression of the program in the program's order, the port runs its plain
twins on the CPU, and the init copies values without arithmetic, so the
two give the same float32 bits, NaN positions included. The colours, masks,
plate and initial maps are drawn from fixed seeds."""

import os
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest
import torch

from depbench import harness, judge
from depbench.reference import camera as rcam
from depbench.reference import solve as rbase
from depbench.reference import solve_fg as ref
from facebook360_dep_tpu_torch.cli import derp_cli
from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.depth import pipeline as tpipe
from facebook360_dep_tpu_torch.depth import solver as ts

SEED = 2**31 + 2121
W, H = 48, 36
LEVEL, NUM_LEVELS = 1, 3
MIN_DEPTH, MAX_DEPTH = 1.0, 100.0
RIG = {"maker": "forward_ring", "num_cameras": 4, "resolution": [W, H], "ring_radius": 0.3, "focal_scale": 0.45,
       "type": "RECTILINEAR"}


def _blobs(rng, shape, count, rmin, rmax):
    """(N, H, W) bool: a union of ``count`` seeded disks in each map."""
    n, h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.zeros(shape, bool)
    for i in range(n):
        for _ in range(count):
            cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(rmin, rmax)
            out[i] |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    return out


@pytest.fixture(scope="module")
def level(tmp_path_factory):
    """One level of the sphere_disk scene on a 4-camera ring, as the reference and the port hold it:
    (reference Level, port LevelContext, port SolverConfig, masks, plate, initial maps)."""
    maker = harness.load_module(os.path.join(harness.BASE, "rigs", "forward_ring.py"))
    scene = harness.load_module(os.path.join(harness.BASE, "scenes", "sphere_disk.py"))
    cams, ids = maker.make(RIG)
    path = str(tmp_path_factory.mktemp("fg_ref_rig") / "rig.json")
    with open(path, "w") as f:
        f.write(rcam.rig_json_text(cams, ids))
    with open(path) as f:
        cams_norm = rcam.normalize(rcam.load_rig_text(f.read())[0])
    rig = tcam.normalize_rig(tcam.load_rig(path))
    colors, truth = scene.render(cams_norm.to(None, torch.float32), (W, H), SEED, 1)
    rng = np.random.RandomState(7)
    # masks well beyond the disk's, and a plate that lies in front of the truth in places, so that
    # every floor and every mask of the branches decides some pixels
    fg = torch.from_numpy(scene.render_inputs(cams_norm.to(None, torch.float32), (W, H), SEED, 1)[
        "foreground_masks_levels"].numpy() | _blobs(rng, (4, H, W), 3, 3, 9))
    bg = (truth * torch.from_numpy(rng.uniform(0.6, 1.3, (4, H, W)).astype(np.float32))).contiguous()
    init = truth * torch.from_numpy((1.0 + 0.3 * rng.randn(4, H, W)).astype(np.float32))
    init = torch.where(fg, init, bg)
    lv = rbase.Level(cams_norm, colors, LEVEL, H, torch.float32)
    fov = tpipe.generate_fov_masks(rig, (H, W))
    ctx = ts.make_level_context(rig, rig, colors, fov, dst_fg_masks=fg, dst_bg_disp=bg, full_height=H)
    cfg = ts.SolverConfig(min_depth=MIN_DEPTH, max_depth=MAX_DEPTH, level=LEVEL, num_levels=NUM_LEVELS,
                          has_fg_masks=True)
    assert torch.equal(lv.fov, ctx.dst_fov_masks) and torch.equal(lv.variance, ctx.dst_variance)
    return lv, ctx, cfg, fg, bg, init


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_brute_force_branch(level):
    """A probe at or behind the plate is refused; outside the masks the map is the plate."""
    lv, ctx, cfg, fg, bg, _ = level
    want = ref.brute_force(lv, fg, bg, MIN_DEPTH, MAX_DEPTH)
    got = ts.brute_force_all(ctx, cfg)
    for g, w in zip(got, want):
        _equal(g, w)
    # where a probe won, it lies in front of the plate (where none did, the far fallback stays)
    won = lv.fov & fg & torch.isfinite(got[1])
    assert won.any() and torch.all(got[0][won] > bg[won]) and torch.equal(got[0][~fg], bg[~fg])


@pytest.fixture(scope="module")
def proposals(level):
    lv, ctx, cfg, fg, bg, init = level
    uniforms = torch.from_numpy(np.random.RandomState(11).rand(4, 2, H, W).astype(np.float32))
    want = ref.random_proposals(lv, init, uniforms, fg, bg, MIN_DEPTH)
    got = ts.random_proposals(ctx, cfg, init, torch.full_like(init, np.inf), torch.zeros_like(init),
                              uniforms=uniforms)
    return uniforms, want, got


def test_proposals_branch(level, proposals):
    """Draws bounded below by the plate, only inside fov & fg; the plate outside the masks."""
    lv, ctx, cfg, fg, bg, init = level
    uniforms, want, got = proposals
    for g, w in zip(got, want):
        _equal(g, w)
    accepted = got[0] != init
    assert accepted.any() and not accepted[~fg].any()
    # the comparison sees a proposal drawn below the plate: without the floor the maps differ
    unfloored = ts.random_proposals(ctx, cfg._replace(has_fg_masks=False), init, torch.full_like(init, np.inf),
                                    torch.zeros_like(init), uniforms=uniforms)
    assert not torch.equal(unfloored[0], want[0])


def test_ping_pong_branch(level, proposals):
    """Candidates below the plate are refused; the plate outside the masks."""
    lv, ctx, cfg, fg, bg, _ = level
    disp, cost, conf = proposals[1]
    want = ref.ping_pong(lv, disp, cost, conf, fg, bg)
    got = ts.ping_pong(ctx, cfg, disp, cost, conf)
    for g, w in zip(got, want):
        _equal(g, w)
    assert not torch.equal(got[0], disp)


def test_bilateral_branch(level, proposals):
    """Only pixels inside fov & fg are read or filtered; the others pass through."""
    lv, ctx, cfg, fg, bg, _ = level
    disp = proposals[1][0]
    got = ts.spatial_bilateral(ctx, cfg, disp)
    _equal(got, ref.bilateral(lv, disp, fg))
    assert torch.equal(got[~fg], disp[~fg]) and not torch.equal(got[fg], disp[fg])


def test_median_branch(level, proposals):
    """Masked median inside fov & fg, the plate (not 0) outside."""
    lv, ctx, cfg, fg, bg, _ = level
    disp = proposals[1][0].clone()
    disp[:, ::7, ::5] = np.nan  # samples the median skips
    got = ts.median_filter(ctx, cfg, disp)
    _equal(got, ref.median(lv, disp, fg, bg))
    assert torch.equal(got[~fg], bg[~fg])


def _coarse_case(rng, src_hw, dst_wh, n=3):
    h, w = src_hw
    w_out, h_out = dst_wh
    disp = (rng.rand(n, h, w) * 0.3 + 0.1).astype(np.float32)
    disp[rng.rand(n, h, w) < 0.05] = np.nan
    mask = _blobs(rng, (n, h, w), 3, 2, 6) | (rng.rand(n, h, w) < 0.1)
    mask_up = _blobs(rng, (n, h_out, w_out), 4, 3, 10)
    mask_up[0] = False  # a map with no mask: nothing to fill
    mask[1] = False  # a map whose coarser mask is empty: no valid pixel, so its holes take the plate
    bg = (rng.rand(n, h_out, w_out) * 0.1).astype(np.float32)
    bg[:, :2, :3] = np.nan
    return disp, mask, mask_up, bg


@pytest.mark.parametrize("src_hw,dst_wh", [((21, 28), (40, 30)), ((30, 40), (80, 60)), ((42, 56), (80, 60)),
                                           ((38, 50), (60, 45))])
def test_init_between_levels(src_hw, dst_wh):
    """upsample_disparity_fg: nearest upsample, chamfer fill of the holes, the plate elsewhere."""
    disp, mask, mask_up, bg = _coarse_case(np.random.RandomState(src_hw[0]), src_hw, dst_wh)
    got = tpipe.upsample_disparity_fg(disp, mask, mask_up, bg, dst_wh)
    want = ref.upsample_fg(torch.from_numpy(disp), torch.from_numpy(mask), torch.from_numpy(mask_up),
                           torch.from_numpy(bg), dst_wh)
    assert got.dtype == np.float32
    _equal(got, want)


def _random_valid(rng, h, w, kind):
    if kind == "blobs":
        return _blobs(rng, (1, h, w), 3, 2, 8)[0]
    if kind == "lattice":  # valid pixels on a grid: every pixel midway between two is a tie
        valid = np.zeros((h, w), bool)
        valid[1::6, 2::6] = True
        return valid
    if kind == "pair":  # two valid pixels in one row, far apart: a column of ties between them
        valid = np.zeros((h, w), bool)
        valid[h // 2, 1] = valid[h // 2, w - 2] = True
        return valid
    return rng.rand(h, w) < {"sparse": 0.03, "half": 0.5, "dense": 0.95}[kind]


def _opencv_labels(valid):
    """cv2's nearest zero pixel of ~valid (DIST_L2, DIST_LABEL_PIXEL) as a flat index y * W + x."""
    _, lab = cv2.distanceTransformWithLabels((~valid).astype(np.uint8), cv2.DIST_L2, 3,
                                             labelType=cv2.DIST_LABEL_PIXEL)
    zy, zx = np.nonzero(valid)  # the labels number the zero pixels in raster order, from 1
    return (zy * valid.shape[1] + zx)[lab - 1]


@pytest.mark.parametrize("kind", ["sparse", "half", "dense", "blobs", "lattice", "pair"])
def test_chamfer_labels_equal_opencv(kind):
    """The reference's chamfer gives cv2's labels exactly, ties included, map by map and as a stack."""
    rng = np.random.RandomState(len(kind))
    for h, w in ((37, 53), (60, 80), (5, 9), (1, 12), (13, 1)):
        valid = _random_valid(rng, h, w, kind) if min(h, w) > 4 else rng.rand(h, w) < 0.3
        valid[rng.randint(h), rng.randint(w)] = True
        got = ref.chamfer_labels(torch.from_numpy(valid)[None])[0].numpy()
        np.testing.assert_array_equal(got, _opencv_labels(valid), err_msg=f"{kind} {h}x{w}")
    stack = np.stack([_random_valid(rng, 30, 40, kind) for _ in range(3)] + [np.zeros((30, 40), bool)])
    stack[:3, 7, 3] = True
    got = ref.chamfer_labels(torch.from_numpy(stack)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], _opencv_labels(stack[i]))
    assert (got[3] == -1).all()


def test_chamfer_ties_follow_opencv_not_the_first_found():
    """On a lattice many pixels are equidistant from two valid pixels; cv2 settles each tie by its scan
    order, and the reference must settle it the same way."""
    valid = _random_valid(None, 31, 43, "lattice")
    want = _opencv_labels(valid)
    # many pixels lie equally far from two or more valid pixels
    ys, xs = np.nonzero(valid)
    d2 = (np.arange(31)[:, None, None] - ys) ** 2 + (np.arange(43)[None, :, None] - xs) ** 2
    tied = (d2 == d2.min(-1, keepdims=True)).sum(-1) > 1
    assert tied.sum() > 100
    np.testing.assert_array_equal(ref.chamfer_labels(torch.from_numpy(valid)[None])[0].numpy(), want)


def _cell():
    cell = {"name": "tiny4.fgtest", "config": "tiny4", "traffic": "fgtest", "scene": "sphere_disk",
            "inputs": ["foreground_masks_levels", "background_disp_levels"], "reference": "solve_fg",
            "derp_flags": ["--resolution", "64", "--use_foreground_masks", "true"], "frames_per_job": 1,
            "distinct_frames": 2, "levels_written": [0, 1, 2], "trace_jobs": 1,
            "compare": {"rel_tol": 0.01, "limits": {"finest_off_share": 0.01, "coarsest_off_share": 0.01}}}
    config = {"name": "tiny4", "rig": {**RIG, "resolution": [64, 48]},
              "levels": {"widths": [64, 48, 32], "heights": [48, 36, 24]}, "min_depth_m": MIN_DEPTH,
              "max_depth_m": MAX_DEPTH, "precision": "float32"}
    return harness.Cell(cell["name"], {}, {"chips": 1}, cell, config)


def test_whole_pyramid_through_derp_cli(tmp_path):
    """derp_cli --use_foreground_masks over a tree with masks and a plate, every level against the
    reference's solve of the same files."""
    c = _cell()
    with ThreadPoolExecutor(max_workers=4) as pool:
        tree = harness.make_tree(c, str(tmp_path / "tree"), SEED, torch.device("cpu"), pool)
    frame = c.frames[1]
    out = str(tmp_path / "out")
    est = derp_cli.main(["--input_root", tree.root, "--output_root", out, "--first", frame, "--last", frame,
                         *c.flags()], device="cpu")
    sizes = {lv: c.size(lv) for lv in c.levels}
    want = ref.solve_pyramid(tree.cams_norm, tree.colors[frame], sizes, tree.full_height, MIN_DEPTH, MAX_DEPTH,
                             torch.device("cpu"), keep=c.levels, inputs=tree.inputs_of(frame))
    for lv in c.levels:
        w, h = c.size(lv)
        got = judge.read_maps(out, lv, tree.ids, frame, (h, w))
        _equal(got, want[lv])
        assert np.isfinite(got).all()
    masks = tree.inputs_of(frame)["foreground_masks_levels"]
    assert all(est.spans.counts[(frame, lv)]["derp.fg.mask_px"] == int(masks[lv].sum()) for lv in c.levels)


def test_reference_refuses_a_frame_without_inputs():
    c = _cell()
    with pytest.raises(ValueError, match="foreground_masks_levels"):
        ref.solve_pyramid(None, {}, {lv: c.size(lv) for lv in c.levels}, 48, MIN_DEPTH, MAX_DEPTH,
                          torch.device("cpu"), inputs={})
