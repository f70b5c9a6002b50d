"""The frame job's spans (facebook360_dep_tpu_torch/core/spans.py): no
record_function without a profiler; under one, every span under its exact
name inside its ``derp level N`` range, none enclosing another;
``level_seconds`` the level ranges' lengths; the per-frame log line's split
still read by log_reader. On the tests/test_torch_derp_cli.py project
(4 cameras, 80x60, 3 pyramid levels), written by the port."""

import logging
import os

import pytest
import torch

from facebook360_dep_tpu_torch.cli import derp_cli, log_reader
from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.core import imagetypes, io, spans
from facebook360_dep_tpu_torch.depth import pipeline
from facebook360_dep_tpu_torch.render import synthetic as tsyn

LEVELS = {0: (80, 60), 1: (56, 42), 2: (40, 30)}
ARGS = ["--min_depth_m", "1.0", "--max_depth_m", "100.0", "--resolution", "80"]
# levels 0 and 1 run the mismatch stage, so every span of the frame job opens
MISMATCHES = ["--mismatches_start_level", "1"]
COMMON = {"derp.stage.setup", "derp.io.read_colors", "derp.upload", "derp.stage.bilateral", "derp.stage.median",
          "derp.readback", "derp.io.write"}
EXPECTED = {
    2: COMMON | {"derp.stage.brute_force", "derp.coverage"},
    1: COMMON | {"derp.io.read_coarser", "derp.stage.proposals", "derp.stage.ping_pong", "derp.stage.mismatches"},
    0: COMMON | {"derp.io.read_coarser", "derp.stage.proposals", "derp.stage.ping_pong", "derp.stage.mismatches"},
}


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_spans_project")
    rig = tsyn.make_test_rig(num_cameras=4, resolution=(80, 60), ring_radius=0.3)
    colors, _ = tsyn.render_sphere_scene(rig, (80, 60), radius=5.0)
    colors = colors.numpy()
    for level, size in LEVELS.items():
        for i, cam_id in enumerate(rig.ids):
            d = imagetypes.image_dir(root, "color_levels", level, cam_id)
            os.makedirs(d, exist_ok=True)
            img = colors[i] if size == (80, 60) else io.resize_image(colors[i], size)
            io.write_color(os.path.join(d, "000000.png"), img, bit_depth=16)
    os.makedirs(os.path.join(root, "rigs"), exist_ok=True)
    tcam.save_rig(os.path.join(root, "rigs/rig_calibrated.json"), rig)
    return str(root)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture(scope="module")
def profiled(project, tmp_path_factory):
    """One CPU-profiled derp_cli run: (estimator, host ranges (name, start_ns, end_ns), log lines)."""
    from torch.profiler import ProfilerActivity, profile

    out = str(tmp_path_factory.mktemp("torch_spans_out"))
    handler = _Lines()
    logger = logging.getLogger("derp")
    logger.addHandler(handler)
    old_level = logger.level
    logger.setLevel(logging.INFO)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            est = derp_cli.main(["--input_root", project, "--output_root", out] + ARGS + MISMATCHES, device="cpu")
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old_level)
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("derp")]
    return est, ranges, handler.lines


def _levels(ranges):
    return {int(n[len("derp level "):]): (s, e) for n, s, e in ranges if n.startswith("derp level ")}


def test_no_record_function_without_a_profiler(project, tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    est = derp_cli.main(["--input_root", project, "--output_root", str(tmp_path)] + ARGS + MISMATCHES, device="cpu")
    assert sorted(est.level_seconds) == [0, 1, 2]
    for level, names in EXPECTED.items():
        assert set(est.spans.ns[("000000", level)]) | set(est.spans.ns[(None, level)]) == names | {
            f"derp level {level}"}


def test_spans_inside_their_level_ranges(profiled):
    est, ranges, _ = profiled
    levels = _levels(ranges)
    assert sorted(levels) == [0, 1, 2]
    program = [(n, s, e) for n, s, e in ranges if not n.startswith("derp level ")]
    assert all(n.startswith("derp.") and n != "depbench job" for n, _, _ in program)
    found = {lv: set() for lv in levels}
    for n, s, e in program:
        inside = [lv for lv, (lo, hi) in levels.items() if lo <= s and e <= hi]
        if n == "derp.init":
            assert not inside and all(e <= lo for lo, _ in levels.values())
            continue
        assert len(inside) == 1, (n, s, e)
        found[inside[0]].add(n)
    assert found == EXPECTED
    assert sum(n == "derp.init" for n, _, _ in program) == 1
    # leaves: no program span encloses or overlaps another
    program.sort(key=lambda r: r[1])
    for (n0, _, e0), (n1, s1, _) in zip(program, program[1:]):
        assert e0 <= s1, (n0, n1)


def test_level_seconds_are_the_level_ranges(profiled):
    est, ranges, _ = profiled
    for level, (lo, hi) in _levels(ranges).items():
        assert est.level_seconds[level] == pytest.approx((hi - lo) / 1e9, rel=0.01, abs=1e-3)


def test_log_line_keeps_log_readers_level_seconds(profiled):
    est, _, lines = profiled
    pattern = dict(log_reader.METRIC_PATTERNS)["level_seconds"]
    frame_lines = {int(line.split()[3]): line for line in lines if line.startswith("frame 000000 level ")}
    assert sorted(frame_lines) == [0, 1, 2]
    for level, line in frame_lines.items():
        m = pattern.search(line)
        assert m and float(m.group(1)) == pytest.approx(est.spans.wall[("000000", level)] / 1e9, abs=0.006)
        assert line.endswith("s)") and all(f"{g} " in line for g in spans.GROUPS)
    metrics, progress = {}, {}
    for line in lines:
        log_reader.scan_line(line, metrics, progress)
    assert len(metrics["level_seconds"]) == 3 and len(metrics["elapsed_s"]) == 3 and len(metrics["total_s"]) == 1
    assert metrics["total_s"][0] == pytest.approx(sum(est.level_seconds.values()), abs=0.006)


def test_a_span_outside_an_estimator_records_nothing():
    with spans.span("derp.stage.median") as s:
        pass
    assert s.ns >= 0 and spans._SINK.get() is None
    rec = spans.Record()
    with rec.at("000001", 3):
        with spans.span("derp.io.write"):
            pass
    with spans.span("derp.io.write"):
        pass
    assert set(rec.ns) == {("000001", 3)} and set(rec.ns[("000001", 3)]) == {"derp.io.write"}


def test_two_estimators_share_no_record(project, tmp_path):
    a = pipeline.DepthEstimator(pipeline.DepthEstimatorOptions(input_root=project, output_root=str(tmp_path)),
                                device="cpu")
    b = pipeline.DepthEstimator(pipeline.DepthEstimatorOptions(input_root=project, output_root=str(tmp_path)),
                                device="cpu")
    assert a.spans is not b.spans and a.spans.ns is not b.spans.ns
    assert set(a.spans.ns) == set(b.spans.ns) == {(None, None)}
    assert set(a.spans.ns[(None, None)]) == {"derp.init"}


def test_split_groups_the_spans():
    rec = spans.Record()
    rec.ns[("f", 0)] = {"derp.io.read_colors": 1e9, "derp.io.write": 5e8, "derp.upload": 2e8, "derp.readback": 1e8,
                        "derp.stage.setup": 3e8, "derp.stage.brute_force": 4e8, "derp.stage.ping_pong": 1e8,
                        "derp.stage.bilateral": 7e8, "derp.stage.median": 1e8, "derp.coverage": 9e9}
    assert rec.split("f", 0) == pytest.approx(
        {"io": 1.5, "copies": 0.3, "setup": 0.3, "search": 0.5, "filters": 0.8})
    assert rec.split("g", 1) == {g: 0 for g in spans.GROUPS}
