"""The port's entry points run on the card unless the caller names another
device: without a visible card they raise, and never carry on silently on
the CPU. The tests that compare each CLI with the JAX package's pass
``device="cpu"`` (test_torch_derp_cli.py, test_torch_fg_depth.py,
test_torch_render_cli.py, test_torch_depth_tools.py, test_torch_publish.py,
test_torch_calib_cli.py, test_torch_isp.py, test_torch_inspect_cli.py,
test_torch_multihost.py, test_torch_sharding.py). A
CLI run with no ``device`` takes it from ``DEP_TORCH_DEVICE`` (unset: the
card; ``cpu``: the CPU; any other value raises), which is how the farm's
subprocess stages are steered (test_torch_dep_driver.py)."""

import importlib
import json
import os
import subprocess
import sys

import pytest
import torch

import facebook360_dep_tpu_torch as pkg
from facebook360_dep_tpu_torch import cli
from facebook360_dep_tpu_torch.depth import pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each CLI that computes on a device, with its required flags (paths that
# need not exist: the device is resolved before any file is read)
ENTRY_POINTS = {
    "derp_cli": ["--input_root", "in", "--output_root", "out"],
    "generate_foreground_masks": ["--background_color", "b", "--color", "c", "--foreground_masks", "m",
                                  "--rig", "r.json", "--first", "000000", "--last", "000000"],
    "temporal_bilateral_filter": ["--input_root", "in", "--output_root", "out", "--rig", "r.json"],
    "upsample_disparity": ["--disparity", "d", "--output", "o", "--resolution", "64", "--rig", "r.json"],
    "compute_rephotography_errors": ["--color", "c", "--disparity", "d", "--rig", "r.json", "--output", "o",
                                     "--first", "000000", "--last", "000000"],
    "simple_mesh_renderer": ["--rig", "r.json", "--color", "c", "--disparity", "d", "--output", "o",
                             "--format", "eqrcolor"],
    "convert_to_binary": ["--rig", "r.json", "--bin", "b", "--disparity", "d", "--fused", "f"],
    "view_fused": ["--rig", "r.json", "--catalog", "c.json", "--output", "o"],
    "calibration": ["--color", "c", "--rig_in", "r.json", "--matches", "m.json", "--rig_out", "o.json"],
    "align_point_cloud": ["--point_cloud", "p.xyz", "--rig_in", "r.json", "--disparity", "d", "--rig_out", "o.json"],
    "align_colors": ["--rig_red", "r.json", "--rig_green", "g.json", "--rig_blue", "b.json", "--color", "c",
                     "--output", "o"],
    "raw_to_rgb": ["--input_image_path", "in.raw", "--output_image_path", "o.png", "--isp_config_path", "isp.json"],
    "correct_vignetting": ["--raw", "in.png", "--out", "o.png", "--vignetting_x", "1,1", "--vignetting_y", "1,1"],
    "rig_simulator": ["--dest", "out"],
    "rig_analyzer": ["--rig", "r.json", "--output", "o"],
    "render_tools": ["geometric_consistency", "--rig", "r.json", "--color", "c", "--disparity", "d", "--output", "o"],
    "conversions": ["export_point_cloud", "--rig", "r.json", "--disparity", "d", "--output", "o.xyz"],
    "view_thresholds": ["color_variance", "--fullsize_image", "in.png", "--output_dir", "o"],
}


@pytest.fixture
def no_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(cli.DEVICE_ENV, raising=False)
    monkeypatch.chdir(tmp_path)


def test_default_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pkg.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pkg.resolve_device(None)
    assert pkg.resolve_device("cpu") == torch.device("cpu")


def test_default_device_is_the_card_where_one_is_visible(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert pkg.default_device() == torch.device("cuda")
    assert pkg.resolve_device(None) == torch.device("cuda")


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_cli_without_a_device_raises_without_a_card(no_card, name):
    mod = importlib.import_module(f"facebook360_dep_tpu_torch.cli.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(ENTRY_POINTS[name])


@pytest.mark.parametrize("entry, argv", [
    ("main_match_corners", ["--color", "c", "--rig_in", "r.json", "--matches", "m.json"]),
    ("main_geometric", ["--rig_in", "r.json", "--rig_out", "o.json"]),
])
def test_calibration_stages_without_a_device_raise_without_a_card(no_card, entry, argv):
    from facebook360_dep_tpu_torch.cli import calibration

    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(calibration, entry)(argv)


def test_depth_estimator_without_a_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.DepthEstimator(pipeline.DepthEstimatorOptions(input_root="in", output_root="out"))


def test_multihost_without_a_device_raises_without_a_card(no_card):
    """The rank's device and the backend's choice mean the card unless the
    CPU is asked for; derp_cli's coordinator flags join no group first."""
    from facebook360_dep_tpu_torch.cli import derp_cli
    from facebook360_dep_tpu_torch.parallel import multihost

    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.local_device(device)
    assert multihost.local_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.maybe_initialize(coordinator_address="127.0.0.1:1", num_processes=1, process_id=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        derp_cli.main(ENTRY_POINTS["derp_cli"] + ["--coordinator_address", "127.0.0.1:1"])
    assert not torch.distributed.is_initialized()


def test_device_variable_steers_a_cli_and_an_argument_beats_it(no_card, monkeypatch):
    assert cli.DEVICE_ENV == "DEP_TORCH_DEVICE"
    monkeypatch.setenv(cli.DEVICE_ENV, "")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.resolve_device(None)
    monkeypatch.setenv(cli.DEVICE_ENV, "cpu")
    assert cli.resolve_device(None) == torch.device("cpu")
    for bad in ("cuda", "CPU", "gpu", "cuda:0"):
        monkeypatch.setenv(cli.DEVICE_ENV, bad)
        with pytest.raises(ValueError, match="DEP_TORCH_DEVICE"):
            cli.resolve_device(None)
        with pytest.raises(ValueError, match="DEP_TORCH_DEVICE"):
            importlib.import_module("facebook360_dep_tpu_torch.cli.derp_cli").main(ENTRY_POINTS["derp_cli"])
        assert cli.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("name", ["rig_simulator", "rig_analyzer", "render_tools", "conversions", "view_thresholds"])
def test_fixture_and_inspection_clis_follow_the_variable(no_card, monkeypatch, name):
    mod = importlib.import_module(f"facebook360_dep_tpu_torch.cli.{name}")
    monkeypatch.setenv(cli.DEVICE_ENV, "cuda")
    with pytest.raises(ValueError, match="DEP_TORCH_DEVICE"):
        mod.main(ENTRY_POINTS[name])
    if name == "rig_simulator":  # and runs on the CPU where it says so
        monkeypatch.setenv(cli.DEVICE_ENV, "cpu")
        mod.main(["--dest", "out", "--num_cameras", "2", "--resolution", "16", "--levels", "1"])
        assert os.path.exists("out/truth/cam1/000000.pfm")


def test_device_argument_beats_the_variable_in_a_cli(tmp_path, monkeypatch):
    from facebook360_dep_tpu_torch.cli import raw_to_rgb

    monkeypatch.setenv(cli.DEVICE_ENV, "bogus")
    (tmp_path / "isp.json").write_text(json.dumps({"CameraIsp": {"width": 8, "height": 6, "bitsPerPixel": 8}}))
    (tmp_path / "in.raw").write_bytes(bytes(range(48)))
    argv = ["--input_image_path", str(tmp_path / "in.raw"), "--output_image_path", str(tmp_path / "o.png"),
            "--isp_config_path", str(tmp_path / "isp.json")]
    with pytest.raises(ValueError, match="DEP_TORCH_DEVICE"):
        raw_to_rgb.main(argv)
    raw_to_rgb.main(argv, device="cpu")
    assert (tmp_path / "o.png").exists()


@pytest.mark.parametrize("value, ok, message", [
    (None, False, "no CUDA device"), ("cpu", True, ""), ("cuda:0", False, "DEP_TORCH_DEVICE='cuda:0'")])
def test_device_variable_in_a_cli_subprocess(tmp_path, value, ok, message):
    """``python -m`` a CLI with no card visible: unset raises, ``cpu`` runs,
    any other value raises."""
    (tmp_path / "isp.json").write_text(json.dumps({"CameraIsp": {"width": 8, "height": 6, "bitsPerPixel": 8}}))
    (tmp_path / "in.raw").write_bytes(bytes(range(48)))
    env = {k: v for k, v in os.environ.items() if k != cli.DEVICE_ENV}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    if value is not None:
        env[cli.DEVICE_ENV] = value
    result = subprocess.run(
        [sys.executable, "-m", "facebook360_dep_tpu_torch.cli.raw_to_rgb", "--input_image_path",
         str(tmp_path / "in.raw"), "--output_image_path", str(tmp_path / "o.png"), "--isp_config_path",
         str(tmp_path / "isp.json")], env=env, capture_output=True, text=True, timeout=120)
    assert (result.returncode == 0) == ok, result.stderr[-2000:]
    assert (tmp_path / "o.png").exists() == ok
    assert message in result.stderr
