"""The foreground cell's check and readers: the test-sized foreground cell that names the
reference ``solve_fg`` reads correct on the CPU; at ``sphere16.fg2k``'s limits the bfloat16
control and the faults planted in the foreground branches (``faults_fg.py``) that change a map
read not correct; the three foreground metrics read a synthetic trace, counter ranges included,
and nothing where no such span or range opened.

A random proposal is accepted only where it halves the pixel's cost, and from the coarser
level's init none is inside the masks of ``sphere_disk`` (on the CPU at 48-128 px wide; at 2K
on the card). So dropping the proposals' plate floor changes no map in this scene, and no
comparison of maps can see it: its test says so. The floor itself is held to the reference
branch by branch, from a noisy init where proposals are accepted, in
``tests/test_torch_fg_reference.py::test_proposals_branch``."""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from depbench import harness, trace
from depbench.tests import faults_fg, helpers

CELL = "tiny4.fgref"
FG_METRICS = ("fg_init_host_s", "fg_io_s", "fg_chamfer_mpx")
UNSEEN = "fg_no_plate_floor"


def _fg2k_limits():
    with open(os.path.join(helpers.ROOT, "depbench", "cells", "sphere16.fg2k.json")) as f:
        return json.load(f)["compare"]["limits"]


def test_foreground_cell_is_correct():
    r = helpers.run_cpu(CELL, limits=_fg2k_limits())
    assert r["correct"] is True and r["failed"] == 0, r["compared"]
    assert all(v["value"] == 0 for v in r["compared"].values())


def test_control_in_bfloat16_is_not_correct(monkeypatch):
    from depbench import control

    monkeypatch.setattr(harness, "solve", control.solve)
    r = helpers.run_cpu(CELL, limits=_fg2k_limits())
    assert r["correct"] is False and r["failed"] >= 1, r["compared"]


@pytest.mark.parametrize("fault", sorted(set(faults_fg.FAULTS) - {UNSEEN}))
def test_broken_foreground_branch_is_not_correct(monkeypatch, fault):
    faults_fg.plant(fault, monkeypatch.setattr)
    r = helpers.run_cpu(CELL, limits=_fg2k_limits())
    assert r["correct"] is False and r["failed"] >= 1, r["compared"]


def test_dropped_proposal_floor_changes_no_map(monkeypatch):
    """The blind spot of the module docstring: the fault leaves every compared map within the
    tolerance. Should a change make proposals win inside the masks, this fails, and the fault then
    belongs with those that read not correct."""
    faults_fg.plant(UNSEEN, monkeypatch.setattr)
    r = helpers.run_cpu(CELL, limits=_fg2k_limits())
    assert r["correct"] is True and all(v["value"] == 0 for v in r["compared"].values()), r["compared"]


def test_register_adds_the_faults_calibrate_plants():
    from depbench.tests import faults

    before = dict(faults.FAULTS)
    try:
        faults_fg.register()
        assert set(faults.FAULTS) == set(before) | set(faults_fg.FAULTS)
    finally:
        faults.FAULTS.clear()
        faults.FAULTS.update(before)


# one job, 0-1000 us, levels 1 (0-300 us) and 0 (300-1000 us); a second traced job 2000-2600 us;
# the span and counter at 1500 us lie between the jobs, outside the window
HOST = [
    ("derp.io.read_colors", 10_000, 40_000), ("derp.io.read_fg", 40_000, 60_000),
    ("derp.fg.mask_px=1200", 60_500, 60_500),
    ("derp.io.read_colors", 300_000, 400_000), ("derp.io.read_fg", 400_000, 450_000),
    ("derp.fg.mask_px=5000", 450_100, 450_100), ("derp.io.read_coarser", 450_200, 460_000),
    ("derp.io.read_fg", 460_000, 470_000), ("derp.stage.fg_init", 470_000, 770_000),
    ("derp.fg.hole_px=300", 770_100, 770_100), ("derp.fg.chamfer_px=4000000", 770_200, 770_200),
    ("derp.stage.fg_init", 1_500_000, 1_600_000), ("derp.fg.chamfer_px=9", 1_500_000, 1_500_000),
    ("derp.io.read_fg", 2_000_000, 2_100_000), ("derp.stage.fg_init", 2_100_000, 2_300_000),
    ("derp.fg.chamfer_px=2000000", 2_300_100, 2_300_100),
]


def canned(host_ops=HOST) -> trace.TraceData:
    return trace.TraceData(
        kernels=[("k", 100_000, 50_000)], busy=[(100_000, 150_000)], window=[(0, 1_000_000), (2_000_000, 2_600_000)],
        levels=[(1, 0, 300_000), (0, 300_000, 1_000_000), (0, 2_000_000, 2_600_000)],
        level_sizes={0: (64, 48), 1: (32, 24)}, level_seconds=[{0: 7e-4, 1: 3e-4}, {0: 6e-4}], frames=2,
        cameras=4, finest_level=0, host_ops=list(host_ops))


def read(name: str, t: trace.TraceData):
    return harness.load_module(os.path.join(harness.BASE, "metrics", name + ".py")).read(t)


def test_foreground_readers_on_a_canned_trace():
    t = canned()
    # fg_init: 300 us in the first job and 200 in the second, not the 100 between them; a frame of two
    assert read("fg_init_host_s", t) == pytest.approx(500e-6 / 2)
    assert read("fg_io_s", t) == pytest.approx((20_000 + 50_000 + 10_000 + 100_000) / 1e9 / 2)
    assert read("fg_chamfer_mpx", t) == pytest.approx((4_000_000 + 2_000_000) / 1e6 / 2)
    # the new spans stay under the io and stage prefixes, so the accepted readers count them
    assert read("host_io_s", t) == pytest.approx((30_000 + 20_000 + 100_000 + 50_000 + 9_800 + 10_000 + 100_000)
                                                 / 1e9 / 2)
    assert read("solve_idle_pct", t) == pytest.approx(100 * (300_000 + 200_000) / 1_600_000)


def test_foreground_readers_find_nothing_without_the_foreground_pass():
    bare = canned([op for op in HOST if not op[0].startswith(("derp.fg.", "derp.stage.fg_init", "derp.io.read_fg"))])
    for name in FG_METRICS:
        assert read(name, bare) is None
    # a counter range outside the window alone is nothing to read
    outside = canned([("derp.fg.chamfer_px=9", 1_500_000, 1_500_000)])
    assert read("fg_chamfer_mpx", outside) is None


def test_a_traced_foreground_run_reports_the_foreground_metrics():
    """The test cell traced on the CPU, with the foreground metrics listed for it."""
    from depbench.tests.helpers import bench_with_test_cells

    b = bench_with_test_cells()
    for m in b["per_layer"]:
        if m["name"] in FG_METRICS:
            m["workloads"] = [CELL]
    c = harness.find_cell(CELL, b, helpers.DATA)
    r = harness.run(c, 2**31 + 777, 0.5, True, torch.device("cpu"), time.perf_counter())
    assert r["correct"], r["compared"]
    got = {k: v["value"] for k, v in r["metrics"].items() if k in FG_METRICS}
    assert set(got) == set(FG_METRICS) and all(v > 0 for v in got.values()), got
    # tiny4's levels 1 and 0: every map with a mask is chamfered at both, 4 x (48 x 36 + 64 x 48) pixels at most
    assert got["fg_chamfer_mpx"] <= 4 * (48 * 36 + 64 * 48) / 1e6
