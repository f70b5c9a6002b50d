"""The port's project driver and its host layers against the JAX package's:
verify_data's problem lists and reports on the same trees, log_reader's
summaries of real logs of the port's derp_cli and calibration,
render_pipeline's stages (names, outputs, argv), and dep's subcommands,
ending in one end-to-end ``dep init -> depth -> depth -> export -> status``
on a 4-camera sphere tree at 64 px with ``DEP_TORCH_DEVICE=cpu`` in the
farm's subprocesses. These mirror tests/test_verify_data.py and
tests/test_dep_driver.py."""

import json
import logging
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from facebook360_dep_tpu.cli import log_reader as jlr
from facebook360_dep_tpu.cli import render_pipeline as jrp
from facebook360_dep_tpu.cli import verify_data as jvd
from facebook360_dep_tpu.farm import runner as jrunner
from facebook360_dep_tpu_torch.cli import dep, derp_cli
from facebook360_dep_tpu_torch.cli import calibration as tcalib
from facebook360_dep_tpu_torch.cli import log_reader as tlr
from facebook360_dep_tpu_torch.cli import render_pipeline as trp
from facebook360_dep_tpu_torch.cli import verify_data as tvd
from facebook360_dep_tpu_torch.core import camera as cam, imagetypes, io
from facebook360_dep_tpu_torch.farm import runner as trunner
from facebook360_dep_tpu_torch.render import synthetic

import torch_parity  # noqa: F401  (torch threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_tree(root, num_cameras=3, size=(50, 38), frames=2, levels=(), background=False):
    """A sphere project: rig, video/color frames, optional color_levels
    (widths) and background frame. Returns (rig, level-0 truth)."""
    rig = synthetic.make_test_rig(num_cameras, size, ring_radius=0.1 if num_cameras == 3 else 0.3)
    os.makedirs(os.path.join(root, "rigs"), exist_ok=True)
    cam.save_rig(os.path.join(root, "rigs", "rig_calibrated.json"), rig)
    trees = [("color", None, size, range(frames))]
    trees += [("color_levels", lvl, (w, w * size[1] // size[0]), range(frames)) for lvl, w in enumerate(levels)]
    if background:
        trees.append(("background_color", None, size, range(1)))
    gt0 = None
    for image_type, level, wh, frame_range in trees:
        colors, gt = synthetic.render_sphere_scene(rig, wh, radius=5.0)
        if image_type == "color":
            gt0 = gt.numpy()
        for i, cam_id in enumerate(rig.ids):
            d = imagetypes.image_dir(root, image_type, level, cam_id)
            os.makedirs(d, exist_ok=True)
            for f in frame_range:
                io.write_color(os.path.join(d, io.frame_name(f) + ".png"), colors[i].numpy(), bit_depth=16)
    return rig, gt0


# ---- verify_data ------------------------------------------------------------


def _gaps(root, rig):
    shutil.rmtree(os.path.join(root, "video", "color", rig.ids[2]))
    os.remove(os.path.join(root, "video", "color", rig.ids[0], "000001.png"))


def _resolution(root, rig):
    io.write_color(os.path.join(root, "video", "color", rig.ids[0], "000000.png"), np.zeros((10, 10, 3), np.float32))


def _empty_background(root, rig):  # the skeleton dep init makes
    os.makedirs(imagetypes.image_dir(root, "background_color"))


def _levels_and_masks(root, rig):
    for lvl in (0, 1):
        for cam_id in rig.ids:
            d = imagetypes.image_dir(root, "color_levels", lvl, cam_id)
            os.makedirs(d)
            io.write_color(os.path.join(d, "000000.png"), np.zeros((8, 8, 3), np.float32))
    d = imagetypes.image_dir(root, "foreground_masks", None, rig.ids[1])
    os.makedirs(d)
    io.write_mask(os.path.join(d, "000000.png"), np.ones((8, 8), bool))
    d = imagetypes.image_dir(root, "video_disp", None, rig.ids[0])
    os.makedirs(d)
    io.write_disparity(os.path.join(d, "000007.pfm"), np.ones((8, 8), np.float32))


def _bad_rig(root, rig):
    with open(os.path.join(root, "rigs", "rig_calibrated.json"), "w") as f:
        f.write("{not json")


def _no_rig(root, rig):
    shutil.rmtree(os.path.join(root, "rigs"))


@pytest.mark.parametrize("mutate", [None, _gaps, _resolution, _empty_background, _levels_and_masks, _bad_rig, _no_rig])
def test_verify_data_matches_jax(tmp_path, mutate):
    root = str(tmp_path)
    rig, _ = write_tree(root, frames=3)
    if mutate is not None:
        mutate(root, rig)
    for check_sizes in (False, True):
        got, want = tvd.verify_project(root, check_sizes=check_sizes), jvd.verify_project(root, check_sizes=check_sizes)
        assert got == want
    if mutate is None:
        assert got[0] == [] and len(got[1]["color_frames"]) == 3
    else:
        assert got[0]
    rc_t = tvd.main(["--project_root", root, "--json_out", str(tmp_path / "t.json")])
    rc_j = jvd.main(["--project_root", root, "--json_out", str(tmp_path / "j.json")])
    assert rc_t == rc_j == (1 if got[0] else 0)
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()


# ---- log_reader -------------------------------------------------------------


@pytest.fixture(scope="module")
def port_logs(tmp_path_factory):
    """Logs of the port's derp_cli (2 levels, 4 cameras at 64 px) and of its
    calibration (300 artificial points, 2 passes, --enable_timing), as a
    farm stage's log file holds them."""
    tmp = tmp_path_factory.mktemp("logs")
    root = str(tmp / "proj")
    write_tree(root, num_cameras=4, size=(64, 48), frames=1, levels=(64, 32))
    logs = tmp / "logs"
    logs.mkdir()

    def logged(name, fn):
        handler = logging.FileHandler(logs / f"{name}.log")
        handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(message)s"))
        logging.getLogger().addHandler(handler)
        level = logging.getLogger().level
        logging.getLogger().setLevel(logging.INFO)
        try:
            fn()
        finally:
            logging.getLogger().removeHandler(handler)
            logging.getLogger().setLevel(level)
            handler.close()

    logged("derp_cli", lambda: derp_cli.main(["--input_root", root, "--output_root", str(tmp / "out"),
                                              "--min_depth_m", "1", "--max_depth_m", "100", "--resolution", "64"],
                                             device="cpu"))
    logged("calibration", lambda: tcalib.main_geometric([
        "--rig_in", os.path.join(root, "rigs", "rig_calibrated.json"), "--rig_out", str(tmp / "rig.json"),
        "--point_count", "300", "--pass_count", "2", "--perturb_rotations", "0.01", "--enable_timing", "true"],
        device="cpu"))
    return logs


def test_log_reader_patterns_match_jax():
    assert [(n, p.pattern) for n, p in tlr.METRIC_PATTERNS] == [(n, p.pattern) for n, p in jlr.METRIC_PATTERNS]
    assert tlr.PROGRESS_PATTERN.pattern == jlr.PROGRESS_PATTERN.pattern


@pytest.mark.parametrize("which, expect", [
    ("derp_cli.log", {"elapsed_s", "total_s", "level_seconds"}),
    ("calibration.log", {"median_reprojection_error_px", "elapsed_s"}),
    ("", {"elapsed_s", "total_s", "level_seconds", "median_reprojection_error_px"}),
])
def test_log_reader_summaries_of_port_logs_match_jax(port_logs, tmp_path, which, expect):
    path = str(port_logs / which) if which else str(port_logs)
    got = tlr.main(["--logs", path, "--json_out", str(tmp_path / "t.json")])
    want = jlr.main(["--logs", path, "--json_out", str(tmp_path / "j.json")])
    assert got == want
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert set(got["metrics"]) == expect
    if "level_seconds" in expect:
        assert got["metrics"]["level_seconds"]["count"] == 2 and got["progress"] == {"frame": "000000", "level": 0}


# ---- render_pipeline --------------------------------------------------------


def _stages(module, runner_module, monkeypatch, argv):
    """The stages and chunks ``module.main(argv)`` hands its pipeline, each
    with its outputs and argv for every chunk."""
    seen = {}

    class Recorder:
        def __init__(self, *args, **kwargs):
            seen["pipeline"] = (type(self).__name__, args, kwargs)

        def run(self, stages, chunks):
            seen["stages"] = [(s.name, [list(s.outputs(c)) for c in chunks], [list(s.command(c)) for c in chunks])
                              for s in stages]

    monkeypatch.setattr(runner_module, "Pipeline", Recorder)
    monkeypatch.setattr(runner_module, "DistributedPipeline", Recorder)
    module.main(argv)
    return seen


@pytest.mark.parametrize("flags", [
    [], ["--format", "eqrcolor"], ["--do_temporal_filter", "true", "--format", "tbstereo"],
    ["--use_foreground_masks", "true", "--workers", "2"],
    ["--use_foreground_masks", "true", "--run_generate_foreground_masks", "false", "--run_fusion", "false"],
    ["--queue_dir", "QUEUE", "--no_worker_timeout", "7", "--force_recompute", "true"],
])
def test_render_pipeline_stages_match_jax(tmp_path, monkeypatch, flags):
    root = str(tmp_path / "proj")
    write_tree(root, num_cameras=2, size=(16, 12), frames=1)
    flags = [f.replace("QUEUE", str(tmp_path / "q")) for f in flags]
    argv = ["--input_root", root, "--output_root", str(tmp_path / "out"), "--first", "000000", "--last", "000003",
            "--chunk_size", "2", *flags]
    got = _stages(trp, trunner, monkeypatch, argv)
    want = _stages(jrp, jrunner, monkeypatch, argv)
    assert got["pipeline"] == want["pipeline"]
    want_stages = list(want["stages"])
    if "--use_foreground_masks" in flags:  # the mask resize the JAX list leaves out, before the depth stage
        at = [name for name, _, _ in want_stages].index("depth_estimation")
        fg = imagetypes.image_dir(root, "foreground_masks")
        fg_levels = imagetypes.image_dir(root, "foreground_masks_levels")
        want_stages.insert(at, ("precompute_resizes_foreground", [
            [os.path.join(fg_levels, "level_0", cam_id, f + ".png") for cam_id in ("cam0", "cam1") for f in frames]
            for frames in (["000000", "000001"], ["000002", "000003"])], [
            [sys.executable, "-m", "facebook360_dep_tpu.cli.resize_images", f"--rig={root}/rigs/rig_calibrated.json",
             f"--color={fg}", f"--output={fg_levels}", "--threshold=0.5", f"--first={first}", f"--last={last}"]
            for first, last in (("000000", "000001"), ("000002", "000003"))]))
    assert [s[0] for s in got["stages"]] == [s[0] for s in want_stages]
    for (name, outputs, argvs), (_, want_outputs, want_argvs) in zip(got["stages"], want_stages):
        assert outputs == want_outputs, name
        for a in argvs:
            assert a[2].startswith("facebook360_dep_tpu_torch.cli.") and not any("facebook360_dep_tpu." in x for x in a)
        assert [[x.replace("facebook360_dep_tpu_torch.", "facebook360_dep_tpu.") for x in a] for a in argvs] == want_argvs


# ---- dep --------------------------------------------------------------------


def test_init_and_status(tmp_path):
    root = str(tmp_path)
    assert dep.main(["init", "--project_root", root]) == 0
    for d in ("video/color", "background/color", "rigs", "logs"):
        assert os.path.isdir(os.path.join(root, d))
    assert json.load(open(os.path.join(root, "project.json"))) == {"version": 1}
    assert dep.main(["status", "--project_root", root]) == 1  # no rig yet


def test_calibration_runs_in_process_on_the_callers_device(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(tcalib, "main", lambda argv, device=None: seen.append((argv, device)))
    root = str(tmp_path)
    assert dep.main(["calibration", "--project_root", root, "--min_depth_m", "1"], device="cpu") == 0
    argv, device = seen[0]
    assert device == "cpu"
    assert argv[argv.index("--rig_in") + 1] == os.path.join(root, "rigs/rig.json")
    assert argv[argv.index("--rig_out") + 1] == os.path.join(root, "rigs/rig_calibrated.json")
    assert dep.load_state(root)["calibration"]["frame"] == "000000"
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("DEP_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dep.main(["calibration", "--project_root", root])


def test_dep_background_stages_use_the_tree_init_makes(tmp_path, monkeypatch):
    root = str(tmp_path / "proj")
    write_tree(root, num_cameras=2, size=(16, 12), frames=1)
    got = _stages(dep, trunner, monkeypatch, ["background", "--project_root", root, "--frame", "000003",
                                               "--min_depth_m", "1", "--max_depth_m", "100"])
    rig = os.path.join(root, "rigs/rig_calibrated.json")
    color, levels = (imagetypes.image_dir(root, t) for t in ("background_color", "background_color_levels"))
    disp = imagetypes.image_dir(root, "background_disp_levels")
    assert got["stages"] == [
        ("precompute_resizes_background", [[os.path.join(levels, "level_0", c, "000003.png") for c in ("cam0", "cam1")]],
         [[sys.executable, "-m", "facebook360_dep_tpu_torch.cli.resize_images", f"--rig={rig}", f"--color={color}",
           f"--output={levels}", "--first=000003", "--last=000003"]]),
        ("depth_estimation_background", [[os.path.join(disp, "level_0", c, "000003.pfm") for c in ("cam0", "cam1")]],
         [[sys.executable, "-m", "facebook360_dep_tpu_torch.cli.derp_cli", f"--input_root={root}",
           f"--output_root={os.path.join(root, 'background')}", f"--color={levels}", f"--rig={rig}",
           "--first=000003", "--last=000003", "--resolution=2048", "--min_depth_m=1.0", "--max_depth_m=100.0"]]),
    ]
    assert dep.load_state(root)["background"] == {"frame": "000003"}


def test_dep_background_end_to_end_on_the_cpu(tmp_path, monkeypatch, caplog):
    """init -> background (derp_cli as a farm subprocess on background/color_levels)
    -> background again (every chunk cached), with DEP_TORCH_DEVICE=cpu in the
    children; the solve lands where a foreground solve's default
    --background_disp reads it."""
    from facebook360_dep_tpu_torch.cli import resize_images
    from facebook360_dep_tpu_torch.depth import pipeline as depth_pipeline

    monkeypatch.setenv("DEP_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PYTHONPATH", REPO)
    root = str(tmp_path / "proj")
    rig, gt0 = write_tree(root, num_cameras=4, size=(64, 48), frames=1, background=True)
    assert dep.main(["init", "--project_root", root]) == 0
    rig_path = os.path.join(root, "rigs/rig_calibrated.json")
    # the stage's own resize would build the 2048..50 pyramid; the test's is 64, 32
    resize_images.main(["--rig", rig_path, "--color", imagetypes.image_dir(root, "background_color"),
                        "--output", imagetypes.image_dir(root, "background_color_levels"), "--widths", "64,32"])
    background = ["background", "--project_root", root, "--resolution", "64", "--min_depth_m", "1",
                  "--max_depth_m", "100"]
    caplog.set_level(logging.INFO, logger="farm")
    assert dep.main(background) is None
    assert "precompute_resizes_background: 1/1 chunks cached, skipping" in caplog.messages
    assert any(m.startswith("done: depth_estimation_background/000000_000000") for m in caplog.messages)
    opts = depth_pipeline.DepthEstimatorOptions(input_root=root, output_root=root)
    opts.resolve_paths()
    reads = opts.background_disp
    assert reads == imagetypes.image_dir(root, "background_disp_levels")
    disp = np.stack([io.read_disparity(os.path.join(reads, "level_0", c, "000000.pfm")) for c in rig.ids])
    ok = np.isfinite(disp)
    assert ok.mean() > 0.9
    assert np.median(np.abs(disp[ok] - gt0[ok]) / gt0[ok]) < 0.05
    caplog.clear()
    assert dep.main(background) is None
    assert "depth_estimation_background: 1/1 chunks cached, skipping" in caplog.messages
    assert not any(m.startswith("done:") for m in caplog.messages)


def test_dep_shoot_end_to_end_on_the_cpu(tmp_path, monkeypatch, caplog):
    """init -> depth (derp_cli as a farm subprocess) -> depth again (every
    chunk cached) -> export eqrcolor (simple_mesh_renderer) -> status, with
    DEP_TORCH_DEVICE=cpu in the children's environment."""
    monkeypatch.setenv("DEP_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PYTHONPATH", REPO)
    root = str(tmp_path / "proj")
    rig, gt0 = write_tree(root, num_cameras=4, size=(64, 48), frames=1, levels=(64, 32), background=True)
    assert dep.main(["init", "--project_root", root]) == 0
    depth = ["depth", "--project_root", root, "--resolution", "64", "--min_depth_m", "1", "--max_depth_m", "100"]
    caplog.set_level(logging.INFO, logger="farm")
    assert dep.main(depth) is None
    assert any(m.startswith("done: depth_estimation/000000_000000") for m in caplog.messages)
    disp = np.stack([io.read_disparity(imagetypes.gen_filename(root, "disparity_levels", 0, c, "000000", "pfm"))
                     for c in rig.ids])
    ok = np.isfinite(disp)
    assert ok.mean() > 0.9
    assert np.median(np.abs(disp[ok] - gt0[ok]) / gt0[ok]) < 0.05
    caplog.clear()
    assert dep.main(depth) is None
    assert "depth_estimation: 1/1 chunks cached, skipping" in caplog.messages
    assert not any(m.startswith("done:") for m in caplog.messages)
    assert dep.main(["export", "--project_root", root, "--format", "eqrcolor", "--resolution", "64"]) is None
    export = io.read_color(os.path.join(imagetypes.image_dir(root, "exports_eqrcolor"), "000000.png"))
    assert export.shape == (1024, 2048, 3) and (export.max(axis=-1) > 0).mean() > 0.05  # 4 forward cameras
    assert dep.main(["status", "--project_root", root]) == 0
    assert dep.load_state(root) == {"version": 1, "depth": {"first": "000000", "last": "000000"},
                                    "export": {"format": "eqrcolor"}}
