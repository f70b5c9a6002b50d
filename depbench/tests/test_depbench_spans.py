"""The readers of the program's spans (host_io_s, copies_s, search_host_s,
filters_host_s, io_idle_pct, solve_idle_pct) on a canned trace of two
traced jobs, and on a test-sized traced run on the CPU."""

from __future__ import annotations

import os

import pytest

from depbench import harness, trace
from depbench.tests import helpers

SECONDS = ("host_io_s", "copies_s", "search_host_s", "filters_host_s")
IDLE = ("io_idle_pct", "solve_idle_pct")

# two jobs, 0-300 us and 400-600 us; a derp.io.write between them lies outside the window
SPANS = [
    ("derp.io.read_colors", 10_000, 60_000), ("aten::to", 60_500, 69_000), ("derp.upload", 60_000, 70_000),
    ("derp.stage.setup", 70_000, 80_000), ("derp.stage.brute_force", 80_000, 150_000),
    ("derp.stage.bilateral", 150_000, 250_000), ("derp.stage.median", 250_000, 270_000),
    ("derp.readback", 270_000, 290_000), ("derp.io.write", 290_000, 300_000),
    ("derp.io.write", 320_000, 380_000),
    ("derp.io.read_colors", 400_000, 450_000), ("derp.stage.proposals", 450_000, 500_000),
    ("derp.stage.ping_pong", 500_000, 550_000), ("derp.stage.mismatches", 550_000, 560_000),
    ("derp.io.read_coarser", 560_000, 580_000), ("derp.io.write", 580_000, 600_000),
]
BUSY = [(20_000, 40_000), (100_000, 200_000), (460_000, 470_000), (590_000, 600_000)]


def canned(host_ops=SPANS, busy=BUSY) -> trace.TraceData:
    return trace.TraceData(
        kernels=[("k", s, e - s) for s, e in busy], busy=list(busy), window=[(0, 300_000), (400_000, 600_000)],
        levels=[(0, 5_000, 300_000), (0, 400_000, 600_000)], level_sizes={0: (64, 48)},
        level_seconds=[{0: 3e-4}, {0: 2e-4}], frames=2, cameras=4, finest_level=0, host_ops=list(host_ops))


def read(name: str, t: trace.TraceData):
    return harness.load_module(os.path.join(harness.BASE, "metrics", name + ".py")).read(t)


@pytest.mark.parametrize("name, ns", [
    # io: 50 + 10 us in the first job, 50 + 20 + 20 in the second; not the 60 us between them
    ("host_io_s", 150_000), ("copies_s", 30_000), ("search_host_s", 180_000), ("filters_host_s", 120_000)])
def test_span_seconds_a_frame(name, ns):
    assert read(name, canned()) == pytest.approx(ns / 1e9 / 2)


def test_idle_shares_are_the_spans_minus_the_busy_card():
    t = canned()
    # io: 10-60 us less 20 busy, 290-300, 400-450, 560-600 less 10 busy: 120 of 500 us
    assert read("io_idle_pct", t) == pytest.approx(100 * 120_000 / 500_000)
    # the stages: 70-270 us less 100 busy, 450-560 less 10: 200 of 500 us
    assert read("solve_idle_pct", t) == pytest.approx(100 * 200_000 / 500_000)
    assert read("io_idle_pct", t) + read("solve_idle_pct", t) <= read("gpu_idle_pct", t)


def test_the_gap_between_two_jobs_does_not_count():
    alone = [op for op in SPANS if op[1] != 320_000]
    for name in SECONDS + IDLE:
        assert read(name, canned()) == pytest.approx(read(name, canned(alone)))
    # a span that straddles the gap counts only inside the jobs: 290-300 us, and 400-420 us under read_colors
    wide = [op for op in SPANS if op[0] != "derp.io.write" or op[1] == 320_000] + [("derp.io.write", 290_000, 420_000)]
    assert read("io_idle_pct", canned(wide)) == pytest.approx(100 * (30_000 + 10_000 + 50_000 + 20_000) / 500_000)


def test_nothing_to_read_gives_nothing():
    bare = canned(host_ops=[("aten::to", 60_500, 69_000)])
    for name in SECONDS + IDLE:
        assert read(name, bare) is None
    no_device = canned(busy=[])
    for name in IDLE:
        assert read(name, no_device) is None
    assert read("host_io_s", no_device) == pytest.approx(75e-6)


def test_breakdown_names_the_span_over_a_gap():
    b = trace.breakdown(canned())
    # 200-300 us, half of it under the bilateral
    assert ["derp level 0: derp.stage.bilateral", 100_000 / 1e9] in b["idle_gaps"]


def test_a_traced_cpu_run_reports_the_span_seconds():
    r = helpers.run_cpu("tiny4.small", traced=True)
    assert r["correct"], r
    for name in SECONDS:
        assert r["metrics"][name]["value"] > 0 and r["metrics"][name]["unit"] == "s/frame"
    # no device intervals on the CPU: no idle shares
    assert not set(IDLE) & set(r["metrics"]) and "gpu_idle_pct" not in r["metrics"]
