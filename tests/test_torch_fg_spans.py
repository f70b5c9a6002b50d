"""The foreground pass's spans and counters (core/spans.py, depth/pipeline.py):
``derp.io.read_fg`` and ``derp.stage.fg_init`` are leaves inside their level
ranges and open only with ``--use_foreground_masks``; the counters
``derp.fg.mask_px``, ``derp.fg.hole_px`` and ``derp.fg.chamfer_px``, and
the estimator pool's ``derp.pool.files``, equal hand counts on a hand-made
pair of masks; ``count`` opens a range only
while a profiler runs. On a 4-camera project of two levels, 16x12 and 8x6,
written by the port."""

import logging
import os

import numpy as np
import pytest
import torch

from facebook360_dep_tpu_torch.cli import derp_cli
from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.core import imagetypes, io, spans
from facebook360_dep_tpu_torch.render import synthetic as tsyn

LEVELS = {0: (16, 12), 1: (8, 6)}
ARGS = ["--min_depth_m", "1.0", "--max_depth_m", "100.0", "--resolution", "16"]
FG = ["--use_foreground_masks", "true"]
NEW_SPANS = {"derp.io.read_fg", "derp.stage.fg_init"}
COUNTERS = ("derp.fg.mask_px", "derp.fg.hole_px", "derp.fg.chamfer_px", "derp.pool.files")


def _masks():
    """level -> (4, H, W): at level 1 rows 1-3, columns 2-5 of every camera (12 pixels); at level 0 what
    that upsamples to (rows 2-7, columns 4-11) and column 12 of rows 2-7 besides (6 holes a camera), in
    cameras 0-2 only."""
    m1 = np.zeros((4, 6, 8), bool)
    m1[:, 1:4, 2:6] = True
    m0 = np.zeros((4, 12, 16), bool)
    m0[:3, 2:8, 4:13] = True
    return {1: m1, 0: m0}


# the hand counts: in-mask pixels a level; at level 0 the 6 holes of each of cameras 0-2, and those three
# maps chamfered (camera 3 has no mask there, so nothing to fill); the files through the estimator's pool:
# each of the 4 cameras' color, mask, plate and PFM written, and at level 0 its coarser PFM and mask besides
HAND = {1: {"derp.fg.mask_px": 4 * 12, "derp.pool.files": 4 * 4},
        0: {"derp.fg.mask_px": 3 * 6 * 9, "derp.fg.hole_px": 3 * 6, "derp.fg.chamfer_px": 3 * 16 * 12,
            "derp.pool.files": 4 * 6}}


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_fg_spans_project"))
    rig = tsyn.make_test_rig(num_cameras=4, resolution=(16, 12), ring_radius=0.3)
    colors, _ = tsyn.render_sphere_scene(rig, (16, 12), radius=5.0)
    colors = colors.numpy()
    masks = _masks()
    for level, size in LEVELS.items():
        for i, cam_id in enumerate(rig.ids):
            img = colors[i] if size == (16, 12) else io.resize_image(colors[i], size)
            for image_type, ext, write, value in (
                    ("color_levels", "png", lambda p, v: io.write_color(p, v, bit_depth=16), img),
                    ("foreground_masks_levels", "png", io.write_png, masks[level][i].astype(np.uint8) * 255),
                    ("background_disp_levels", "pfm", io.write_pfm, np.full(size[::-1], 0.05, np.float32))):
                d = imagetypes.image_dir(root, image_type, level, cam_id)
                os.makedirs(d, exist_ok=True)
                write(os.path.join(d, f"000000.{ext}"), value)
    os.makedirs(os.path.join(root, "rigs"), exist_ok=True)
    tcam.save_rig(os.path.join(root, "rigs/rig_calibrated.json"), rig)
    return root


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _run(project, out, flags, profiled):
    """(estimator, "derp" host ranges (name, start_ns, end_ns), log lines) of one derp_cli run."""
    from torch.profiler import ProfilerActivity, profile

    handler, logger = _Lines(), logging.getLogger("derp")
    logger.addHandler(handler)
    old_level = logger.level
    logger.setLevel(logging.INFO)
    argv = ["--input_root", project, "--output_root", out] + ARGS + flags
    try:
        if not profiled:
            return derp_cli.main(argv, device="cpu"), [], handler.lines
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            est = derp_cli.main(argv, device="cpu")
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old_level)
    ranges = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("derp")]
    return est, ranges, handler.lines


@pytest.fixture(scope="module")
def profiled(project, tmp_path_factory):
    return _run(project, str(tmp_path_factory.mktemp("torch_fg_spans_out")), FG, True)


def _levels(ranges):
    return {int(n[len("derp level "):]): (s, e) for n, s, e in ranges if n.startswith("derp level ")}


def test_new_spans_are_leaves_inside_their_levels(profiled):
    est, ranges, _ = profiled
    levels = _levels(ranges)
    assert sorted(levels) == [0, 1]
    program = [(n, s, e) for n, s, e in ranges if not n.startswith("derp level ") and "=" not in n]
    found = {lv: set() for lv in levels}
    for n, s, e in program:
        inside = [lv for lv, (lo, hi) in levels.items() if lo <= s and e <= hi]
        if n != "derp.init":
            assert len(inside) == 1, (n, s, e)
            found[inside[0]].add(n)
    # the masks and the plate are read at both levels, the coarser masks again at level 0; the init between
    # levels runs at level 0 only, in place of the set-up span there
    assert found[1] & NEW_SPANS == {"derp.io.read_fg"} and found[0] & NEW_SPANS == NEW_SPANS
    assert sum(n == "derp.io.read_fg" for n, s, _ in program if levels[0][0] <= s <= levels[0][1]) == 2
    program.sort(key=lambda r: r[1])
    for (n0, _, e0), (n1, s1, _) in zip(program, program[1:]):
        assert e0 <= s1, (n0, n1)
    # a counter's range is empty, lies inside a level and in no span
    for n, s, e in ranges:
        if "=" in n:
            assert n.split("=")[0] in COUNTERS
            assert any(lo <= s and e <= hi for lo, hi in levels.values())
            assert not any(s0 < s < e0 for n0, s0, e0 in program)


def test_counters_equal_the_hand_counts(profiled):
    est, ranges, lines = profiled
    for level, want in HAND.items():
        assert est.spans.counts[("000000", level)] == want
    # the trace holds each count as a range named name=n
    traced = {}
    for n, s, _ in ranges:
        if "=" in n:
            name, v = n.split("=")
            level = [lv for lv, (lo, hi) in _levels(ranges).items() if lo <= s <= hi][0]
            traced.setdefault(level, {})[name] = traced.get(level, {}).get(name, 0) + int(v)
    assert traced == HAND
    # and the per-frame log line ends with them
    frame_lines = {int(line.split()[3]): line for line in lines if line.startswith("frame 000000 level ")}
    for level, want in HAND.items():
        assert frame_lines[level].endswith("".join(f"; {n} {v}" for n, v in sorted(want.items())) + ")")


def test_the_split_still_adds_up(profiled):
    est, _, lines = profiled
    ns = est.spans.ns[("000000", 0)]
    split = est.spans.split("000000", 0)
    assert split["setup"] == pytest.approx((ns["derp.stage.setup"] + ns["derp.stage.fg_init"]) / 1e9)
    assert split["io"] == pytest.approx(sum(v for n, v in ns.items() if n.startswith("derp.io.")) / 1e9)
    assert ns["derp.io.read_fg"] > 0


def test_new_spans_and_counters_only_with_masks(project, tmp_path):
    est, _, lines = _run(project, str(tmp_path), [], False)
    for key, names in est.spans.ns.items():
        assert not set(names) & NEW_SPANS, key
    # without masks the pool's count alone: 4 colors read and 4 PFMs written a level, 4 coarser PFMs read at 0
    assert {key: c for key, c in est.spans.counts.items() if c} == {
        ("000000", 1): {"derp.pool.files": 4 * 2}, ("000000", 0): {"derp.pool.files": 4 * 3}}
    assert not any("derp.fg." in line for line in lines)


def test_count_opens_a_range_only_under_a_profiler(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler active")

    rec = spans.Record()
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        m.setattr(torch.autograd.profiler, "record_function", refuse)
        spans.count("derp.fg.mask_px", 3)  # bound to no record: nothing
        with rec.at("000001", 2):
            spans.count("derp.fg.mask_px", 3)
            spans.count("derp.fg.mask_px", np.int64(4))
    assert rec.counts == {("000001", 2): {"derp.fg.mask_px": 7}}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.at("000001", 2):
            spans.count("derp.fg.hole_px", 5)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "derp.fg.hole_px=5" in names
    assert rec.counts[("000001", 2)] == {"derp.fg.mask_px": 7, "derp.fg.hole_px": 5}
