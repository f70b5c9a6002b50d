"""The port's entry points run on the card unless the caller names another
device: without a visible card they raise, and never carry on silently on
the CPU. The tests that compare each CLI with the JAX package's pass
``device="cpu"`` (test_torch_derp_cli.py, test_torch_fg_depth.py,
test_torch_render_cli.py, test_torch_depth_tools.py, test_torch_publish.py,
test_torch_calib_cli.py)."""

import importlib

import pytest
import torch

import facebook360_dep_tpu_torch as pkg
from facebook360_dep_tpu_torch.depth import pipeline

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
}


@pytest.fixture
def no_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
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
