"""The port's render and quality CLIs end to end: its derp_cli solves a small
project, then its compute_rephotography_errors and simple_mesh_renderer run
on that output beside the JAX package's CLIs on the same files."""

import logging
import os

import cv2
import numpy as np
import pytest

from facebook360_dep_tpu.cli import compute_rephotography_errors as jcre
from facebook360_dep_tpu.cli import log_reader
from facebook360_dep_tpu.cli import simple_mesh_renderer as jsmr
from facebook360_dep_tpu_torch.cli import compute_rephotography_errors as tcre
from facebook360_dep_tpu_torch.cli import derp_cli as tderp
from facebook360_dep_tpu_torch.cli import simple_mesh_renderer as tsmr
from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.core import imagetypes, io
from facebook360_dep_tpu_torch.render import synthetic as tsyn

import torch_parity  # noqa: F401  (thread count)

LEVELS = {0: (64, 48), 1: (32, 24)}


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    """A 4-camera sphere project written by the port (PNG16 colors) and its
    2-level disparity solve by the port's derp_cli."""
    root = str(tmp_path_factory.mktemp("torch_render_project"))
    rig = tsyn.make_test_rig(4, LEVELS[0], ring_radius=0.2)
    for level, size in LEVELS.items():
        colors, _ = tsyn.render_sphere_scene(rig, size, radius=5.0)
        for i, cam_id in enumerate(rig.ids):
            d = imagetypes.image_dir(root, "color_levels", level, cam_id)
            os.makedirs(d, exist_ok=True)
            io.write_color(os.path.join(d, "000000.png"), colors[i].numpy(), bit_depth=16)
    os.makedirs(os.path.join(root, "rigs"), exist_ok=True)
    tcam.save_rig(os.path.join(root, "rigs/rig_calibrated.json"), rig)
    out = os.path.join(root, "out")
    tderp.main(["--input_root", root, "--output_root", out, "--min_depth_m", "1.0", "--max_depth_m", "100.0",
                "--resolution", "64"], device="cpu")
    return dict(root=root, color=os.path.join(root, "video/color_levels/level_0"),
                disparity=os.path.join(out, "disparity_levels/level_0"),
                rig=os.path.join(root, "rigs/rig_calibrated.json"))


def _total_mssim(records):
    metrics, progress = {}, {}
    for rec in records:
        log_reader.scan_line(rec.getMessage(), metrics, progress)
    return np.mean([metrics[f"rephoto_mssim_{c}"][-1] for c in "rgb"])


def test_rephotography_cli_matches_jax(solved, tmp_path, caplog):
    """The JAX log reader parses the port's TOTAL line, and the port's
    MSSIM is within 0.5 pp of the JAX CLI's on the same derp_cli output."""
    argv = ["--color", solved["color"], "--disparity", solved["disparity"], "--rig", solved["rig"],
            "--first", "000000", "--last", "000000"]
    with caplog.at_level(logging.INFO):
        result = tcre.main(argv + ["--output", str(tmp_path / "t")], device="cpu")
    port = _total_mssim(caplog.records)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        jcre.main(argv + ["--output", str(tmp_path / "j")])
    ref = _total_mssim(caplog.records)
    assert 50.0 < port <= 100.0
    assert abs(port - ref) < 0.5, (port, ref)
    np.testing.assert_allclose(100 * np.mean(result["total"]), port, atol=0.01)
    assert sorted(result["frames"]["000000"]["cameras"]) == ["cam0", "cam1", "cam2", "cam3"]


@pytest.mark.parametrize("fmt", tsmr.FORMATS)
def test_simple_mesh_renderer_matches_jax(solved, tmp_path, fmt):
    """Same file, shape and PNG type as the JAX CLI's; 8-bit colors (16-bit
    disparities) agree to 2 levels on >= 99% of pixels (a splat index may
    flip where a coordinate lands within an ulp of a pixel edge)."""
    argv = ["--rig", solved["rig"], "--color", solved["color"], "--disparity", solved["disparity"],
            "--format", fmt, "--width", "64", "--height", "32"]
    records = tsmr.main(argv + ["--output", str(tmp_path / "t")], device="cpu")
    jsmr.main(argv + ["--output", str(tmp_path / "j")])
    assert os.listdir(tmp_path / "t") == os.listdir(tmp_path / "j") == ["000000.png"]
    got = cv2.imread(str(tmp_path / "t/000000.png"), cv2.IMREAD_UNCHANGED)
    want = cv2.imread(str(tmp_path / "j/000000.png"), cv2.IMREAD_UNCHANGED)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert records[0]["shape"][:2] == got.shape[:2] and records[0]["finite"]
    assert 0.1 < records[0]["coverage"] < 1.0
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert (diff > 2).mean() <= 0.01, (diff > 2).mean()
