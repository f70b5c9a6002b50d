"""The port's mismatch stage against the benchmark's plain reference of it
(depbench/reference/solve_mm.py), on the CPU at a small size: the stage
alone (one chunk, several chunks, planted outliers), the whole pyramid of
``derp_cli --mismatches_start_level 0`` on a tiny tree, the cell's flag,
the stage's planted faults and the bfloat16 control against the limits of
``sphere16.mismatch2k``, and the two readers of the stage's span and
counter on a canned trace.

Every comparison of the stage is bit for bit: the reference writes each
elementwise expression of the program in the program's order, and the port
runs its plain twins on the CPU, so the two give the same float32 bits, NaN
positions included. The colours and maps are drawn from fixed seeds."""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from depbench import harness, judge, trace
from depbench.reference import camera as rcam
from depbench.reference import solve as rbase
from depbench.reference import solve_mm as ref
from depbench.tests import faults_mm
from facebook360_dep_tpu_torch.cli import derp_cli
from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.depth import pipeline as tpipe
from facebook360_dep_tpu_torch.depth import solver as ts

SEED = 2**31 + 2525
# the tiny tree's seed: its second frame's level 0 has 96 pixels replaced, and each planted fault changes
# some of its maps beyond the 1% tolerance (near_median 11 pixels, skipped 31, no_variance_gate 225)
TREE_SEED = 2**31 + 1352
W, H = 48, 36
MIN_DEPTH, MAX_DEPTH = 1.0, 100.0
RIG = {"maker": "forward_ring", "num_cameras": 4, "resolution": [W, H], "ring_radius": 0.3, "focal_scale": 0.45,
       "type": "RECTILINEAR"}
CELL = "sphere16.mismatch2k"


def _cell_file(kind, name):
    with open(os.path.join(harness.BASE, kind, name + ".json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def level(tmp_path_factory):
    """Level 0 of three of the sphere_disk scene on a 4-camera ring, as the reference and the port hold
    it, with its colours pulled towards grey so that most pixels' variance lies inside the stage's band,
    and noisy maps around the truth: (reference Level, port LevelContext, port SolverConfig, maps)."""
    maker = harness.load_module(os.path.join(harness.BASE, "rigs", "forward_ring.py"))
    scene = harness.load_module(os.path.join(harness.BASE, "scenes", "sphere_disk.py"))
    cams, ids = maker.make(RIG)
    path = str(tmp_path_factory.mktemp("mm_ref_rig") / "rig.json")
    with open(path, "w") as f:
        f.write(rcam.rig_json_text(cams, ids))
    with open(path) as f:
        cams_norm = rcam.normalize(rcam.load_rig_text(f.read())[0])
    rig = tcam.normalize_rig(tcam.load_rig(path))
    colors, truth = scene.render(cams_norm.to(None, torch.float32), (W, H), SEED, 1)
    colors = (0.5 + 0.3 * (colors - 0.5)).contiguous()
    rng = np.random.RandomState(5)
    disp = (truth * torch.from_numpy((1.0 + 0.05 * rng.randn(4, H, W)).astype(np.float32))).contiguous()
    lv = rbase.Level(cams_norm, colors, 0, H, torch.float32)
    ctx = ts.make_level_context(rig, rig, colors, tpipe.generate_fov_masks(rig, (H, W)), full_height=H)
    cfg = ts.SolverConfig(min_depth=MIN_DEPTH, max_depth=MAX_DEPTH, level=0, num_levels=3, mismatches_start_level=0)
    assert torch.equal(lv.fov, ctx.dst_fov_masks) and torch.equal(lv.variance, ctx.dst_variance)
    band = (lv.variance >= lv.var_noise_floor) & (lv.variance <= lv.var_high_thresh)
    assert band.double().mean().item() > 0.5
    return lv, ctx, cfg, disp


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("case", ["one_chunk", "several_chunks", "outliers"])
def test_stage_equals_reference(level, monkeypatch, case):
    """handle_mismatches on all four maps against the reference's stage, bit for bit: the decision in
    one chunk, in chunks of three maps and one, and on maps with planted outliers."""
    lv, ctx, cfg, disp = level
    if case == "several_chunks":
        monkeypatch.setattr(ts, "MISMATCH_CHUNK_ELEMENTS", 3 * 4 * H * W)
    if case == "outliers":
        disp = disp.clone()
        disp[1, 10:16, 8:20] *= 1.8  # nearer than every other camera sees it
        disp[2, 20:26, 30:40] *= 0.5  # farther
        disp[0, ::9, ::7] = 0.2  # scattered pixels at 5 m
    new, replace = ts.handle_mismatches(ctx, cfg, disp)
    want, want_mask = ref.handle_mismatches(lv, disp)
    _equal(new, want)
    _equal(replace, want_mask)
    assert replace.sum().item() > (40 if case == "outliers" else 5)
    # a replaced pixel never rises above its solved disparity, and a kept one is untouched
    assert torch.all(new[replace] <= disp[replace]) and torch.equal(new[~replace], disp[~replace])
    if case == "outliers":
        assert replace[1, 10:16, 8:20].sum().item() > 20


def test_stage_keeps_pixels_outside_the_variance_band(level):
    """Outside [var_noise_floor, var_high_thresh] nothing is replaced, in the port and the reference."""
    lv, ctx, cfg, disp = level
    disp = disp.clone()
    disp[1, 10:16, 8:20] *= 1.8
    band = (lv.variance >= lv.var_noise_floor) & (lv.variance <= lv.var_high_thresh)
    _, replace = ts.handle_mismatches(ctx, cfg, disp)
    _, want_mask = ref.handle_mismatches(lv, disp)
    assert replace.any() and not replace[~band].any() and not want_mask[~band].any()


def _cell():
    """A test size of sphere16.mismatch2k: 4 cameras, 64x48, three levels, its flags and limits."""
    cell = {**_cell_file("cells", CELL), "name": "tiny4.mmtest", "config": "tiny4mm", "traffic": "mmtest",
            "derp_flags": ["--resolution", "64", "--mismatches_start_level", "0"], "levels_written": [0, 1, 2]}
    config = {"name": "tiny4mm", "rig": {**RIG, "resolution": [64, 48]},
              "levels": {"widths": [64, 48, 32], "heights": [48, 36, 24]}, "min_depth_m": MIN_DEPTH,
              "max_depth_m": MAX_DEPTH, "precision": "float32"}
    return harness.Cell(cell["name"], {}, {"chips": 1}, cell, config)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny cell's tree, and the reference's maps and masks of its second frame at every level."""
    root = str(tmp_path_factory.mktemp("mm_tree"))
    c = _cell()
    with ThreadPoolExecutor(max_workers=4) as pool:
        tree = harness.make_tree(c, os.path.join(root, "tree"), TREE_SEED, torch.device("cpu"), pool)
    frame = c.frames[1]
    masks = {}
    want = ref.solve_pyramid(tree.cams_norm, tree.colors[frame], {lv: c.size(lv) for lv in c.levels},
                             tree.full_height, MIN_DEPTH, MAX_DEPTH, torch.device("cpu"), keep=c.levels, masks=masks)
    return c, tree, frame, want, masks


def test_whole_pyramid_through_derp_cli(tiny, tmp_path, monkeypatch):
    """derp_cli --mismatches_start_level 0 over the tiny tree, every level against the reference's solve
    of the same files; the counter equals the set pixels of the mask the program saved with its maps."""
    c, tree, frame, want, masks = tiny
    saved = {}
    save = tpipe.DepthEstimator.save_results

    def spy(self, level, frame_, result):
        saved[level] = int(np.count_nonzero(result["mismatches"]))
        save(self, level, frame_, result)

    monkeypatch.setattr(tpipe.DepthEstimator, "save_results", spy)
    out = str(tmp_path / "out")
    est = derp_cli.main(["--input_root", tree.root, "--output_root", out, "--first", frame, "--last", frame,
                         *c.flags()], device="cpu")
    for lv in c.levels:
        w, h = c.size(lv)
        _equal(judge.read_maps(out, lv, tree.ids, frame, (h, w)), want[lv])
    counts = {lv: est.spans.counts[(frame, lv)].get("derp.mismatch.replaced_px") for lv in c.levels}
    # the stage ran at level 0 only, and replaced what the reference replaced
    assert counts == {0: saved[0], 1: None, 2: None}
    assert saved == {0: int(masks[0].sum()), 1: 0, 2: 0} and saved[0] > 0


def test_cell_runs_the_stage_where_the_reference_does():
    """The cell's --mismatches_start_level is the reference's constant."""
    flags = _cell_file("cells", CELL)["derp_flags"]
    assert int(flags[flags.index("--mismatches_start_level") + 1]) == ref.MISMATCHES_START_LEVEL
    assert _cell_file("cells", CELL)["reference"] == "solve_mm"
    # BENCHMARK.json names the cell, and the harness finds its files by that name
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        c = harness.find_cell(CELL, json.load(f))
    assert c.config["name"] == "sphere16mm" and c.workload["chips"] == 1 and c.cell["why"] == c.workload["why"]
    assert {m["name"] for m in c.metrics("per_layer")} >= {"mismatch_host_s", "mismatch_replaced_kpx"}
    assert [ref.runs_stage(lv, 10) for lv in range(10)] == [True] + [False] * 9


def _judged(c, job, want):
    """The compared numbers of one job, and whether they lie within the cell's limits."""
    limits = c.cell["compare"]["limits"]
    numbers = {f"{tag}_off_share": judge.off_stats(job.maps[lv], want[lv], c.cell["compare"]["rel_tol"])["off_share"]
               for tag, lv in zip(("finest", "coarsest"), c.judged)}
    return numbers, all(numbers[k] <= limits[k] for k in numbers)


def test_program_is_correct_at_the_cell_limits(tiny, tmp_path):
    c, tree, frame, want, _ = tiny
    numbers, ok = _judged(c, harness.run_job(c, tree, str(tmp_path / "out"), frame, torch.device("cpu")), want)
    assert ok and all(v == 0 for v in numbers.values()), numbers


@pytest.mark.parametrize("fault", sorted(faults_mm.FAULTS))
def test_broken_stage_is_not_correct(tiny, tmp_path, monkeypatch, fault):
    """Each planted fault changes level 0's maps of the tiny tree beyond the cell's finest limit."""
    c, tree, frame, want, _ = tiny
    faults_mm.plant(fault, monkeypatch.setattr)
    numbers, ok = _judged(c, harness.run_job(c, tree, str(tmp_path / "out"), frame, torch.device("cpu")), want)
    assert not ok and numbers["finest_off_share"] > c.cell["compare"]["limits"]["finest_off_share"], numbers


def test_control_in_bfloat16_is_not_correct(tiny, tmp_path, monkeypatch):
    from depbench import control

    c, tree, frame, want, _ = tiny
    monkeypatch.setattr(harness, "solve", control.solve)
    numbers, ok = _judged(c, harness.run_job(c, tree, str(tmp_path / "out"), frame, torch.device("cpu")), want)
    assert not ok, numbers


def test_register_adds_the_faults_calibrate_plants():
    from depbench.tests import faults

    before = dict(faults.FAULTS)
    try:
        faults_mm.register()
        assert set(faults.FAULTS) == set(before) | set(faults_mm.FAULTS)
    finally:
        faults.FAULTS.clear()
        faults.FAULTS.update(before)


# one job, 0-1000 us, levels 1 (0-300 us) and 0 (300-1000 us); a second traced job 2000-2600 us;
# the span and counter at 1500 us lie between the jobs, outside the window
HOST = [
    ("derp.stage.ping_pong", 350_000, 400_000), ("derp.stage.mismatches", 400_000, 520_000),
    ("derp.stage.bilateral", 520_000, 560_000), ("derp.readback", 600_000, 650_000),
    ("derp.mismatch.replaced_px=1500", 650_100, 650_100), ("derp.pool.files=12", 990_000, 990_000),
    ("derp.stage.mismatches", 1_500_000, 1_600_000), ("derp.mismatch.replaced_px=9", 1_500_000, 1_500_000),
    ("derp.stage.mismatches", 2_100_000, 2_180_000), ("derp.mismatch.replaced_px=500", 2_300_100, 2_300_100),
]


def _canned(host_ops=HOST) -> trace.TraceData:
    return trace.TraceData(
        kernels=[("k", 100_000, 50_000)], busy=[(100_000, 150_000)], window=[(0, 1_000_000), (2_000_000, 2_600_000)],
        levels=[(1, 0, 300_000), (0, 300_000, 1_000_000), (0, 2_000_000, 2_600_000)],
        level_sizes={0: (64, 48), 1: (32, 24)}, level_seconds=[{0: 7e-4, 1: 3e-4}, {0: 6e-4}], frames=2,
        cameras=4, finest_level=0, host_ops=list(host_ops))


def _read(name: str, t: trace.TraceData):
    return harness.load_module(os.path.join(harness.BASE, "metrics", name + ".py")).read(t)


def test_mismatch_readers_on_a_canned_trace():
    t = _canned()
    # the stage: 120 us in the first job and 80 in the second, not the 100 between them; a frame of two
    assert _read("mismatch_host_s", t) == pytest.approx(200e-6 / 2)
    assert _read("mismatch_replaced_kpx", t) == pytest.approx((1500 + 500) / 1e3 / 2)
    # the counter lies under no io or stage prefix, so the accepted readers do not count it
    assert _read("search_host_s", t) == pytest.approx((50_000 + 120_000 + 80_000) / 1e9 / 2)
    assert _read("host_io_s", t) is None


def test_mismatch_readers_find_nothing_without_the_stage():
    bare = _canned([op for op in HOST if not op[0].startswith(("derp.mismatch.", "derp.stage.mismatches"))])
    assert _read("mismatch_host_s", bare) is None and _read("mismatch_replaced_kpx", bare) is None
    # a counter range outside the window alone is nothing to read
    outside = _canned([("derp.mismatch.replaced_px=9", 1_500_000, 1_500_000)])
    assert _read("mismatch_replaced_kpx", outside) is None
    # a run of the stage that replaced nothing reads 0, not nothing
    assert _read("mismatch_replaced_kpx", _canned([("derp.mismatch.replaced_px=0", 500_000, 500_000)])) == 0
