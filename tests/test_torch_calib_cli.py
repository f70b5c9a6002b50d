"""The port's calibration and rig CLIs against the JAX package's, on the same
files, with ``device="cpu"``: calibration (the combined binary,
main_match_corners and main_geometric), rig_aligner, rig_compare,
align_point_cloud and align_colors; then each CLI's options and defaults.

The rigs are turned by one common rotation (see test_torch_calib.py: the
JAX bundle adjustment cannot turn a camera whose rotvec is 0). The
image-matched scene has FTHETA cameras: on a rectilinear ring some
two-view traces of image-corner matches make the triangulation's
Gauss-Newton step behind a camera, where the projection is tan(pi/2) ~ 1e16
and the 3x3 normal equations are near-singular; from equal residuals and
Jacobians the two packages then take roundoff-driven paths (the JAX one
often to NaN), so their kept observations, and the rigs, part.
Tolerances: matches.json corner positions to 1e-5 px and ZNCC scores to
2e-6 with the same pairs (float32); the solved rig JSONs to 1e-7 relative
(float64; the scatter-adds sum in another order); align_colors' PNG16 to
1 LSB.
"""

import argparse
import importlib
import json
import logging
import os

import numpy as np
import pytest

from facebook360_dep_tpu.calib import rig_tools as jrt
from facebook360_dep_tpu.core import camera as jcam
from facebook360_dep_tpu.core import io as jio
from facebook360_dep_tpu.render import synthetic as jsyn
from facebook360_dep_tpu_torch.core import io as tio

from torch_parity import ring_rig

TURN = np.asarray([0.3, -0.2, 0.5])
JSON_RTOL = 1e-7


def turned(rig):
    return jrt.transform_rig(rig, rotation(TURN), np.zeros(3), 1.0)


def run_both(module, argv_of, tmp, fn="main"):
    """Run the JAX CLI and the port's (on the CPU) with ``argv_of(side)``;
    returns their return values."""
    jmod = importlib.import_module(f"facebook360_dep_tpu.cli.{module}")
    tmod = importlib.import_module(f"facebook360_dep_tpu_torch.cli.{module}")
    for side in ("jax", "torch"):
        os.makedirs(os.path.join(tmp, side), exist_ok=True)
    return getattr(jmod, fn)(argv_of("jax")), getattr(tmod, fn)(argv_of("torch"), device="cpu")


def assert_json_close(got_path, want_path, rtol=JSON_RTOL, atol=1e-9):
    def walk(g, w, where):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), where
            for k in w:
                walk(g[k], w[k], f"{where}.{k}")
        elif isinstance(w, list):
            assert len(g) == len(w), where
            for i, (a, b) in enumerate(zip(g, w)):
                walk(a, b, f"{where}[{i}]")
        elif isinstance(w, float):
            assert g == pytest.approx(w, rel=rtol, abs=atol), where
        else:
            assert g == w, where

    with open(got_path) as f, open(want_path) as h:
        walk(json.load(f), json.load(h), "")


def assert_matches_close(got_path, want_path):
    with open(got_path) as f, open(want_path) as h:
        got, want = json.load(f), json.load(h)
    assert list(got["images"]) == list(want["images"])
    for k, pts in want["images"].items():
        np.testing.assert_allclose([[p["x"], p["y"]] for p in got["images"][k]],
                                   [[p["x"], p["y"]] for p in pts], rtol=0, atol=1e-5)
    assert [(m["image1"], m["image2"]) for m in got["all_matches"]] == \
        [(m["image1"], m["image2"]) for m in want["all_matches"]]
    for g, w in zip(got["all_matches"], want["all_matches"]):
        assert [(m["idx1"], m["idx2"]) for m in g["matches"]] == [(m["idx1"], m["idx2"]) for m in w["matches"]]
        np.testing.assert_allclose([m["score"] for m in g["matches"]], [m["score"] for m in w["matches"]],
                                   rtol=0, atol=2e-6)
    return sum(len(m["matches"]) for m in want["all_matches"])


@pytest.fixture(scope="module")
def shoot(tmp_path_factory):
    """A turned 3-camera FTHETA ring at 160x120 and its sphere scene, written
    by the JAX package (rig JSON, PNG16 colors with a constant 8-px frame, on
    which the corner detectors' border rules agree: test_torch_features.py);
    the JAX combined calibration run on it into jax/."""
    from facebook360_dep_tpu.cli import calibration as jcli

    root = str(tmp_path_factory.mktemp("torch_calib_cli"))
    rig = turned(jsyn.make_test_rig(num_cameras=3, resolution=(160, 120), ring_radius=0.2, type_name="FTHETA"))
    colors, _ = jsyn.render_sphere_scene(rig, (160, 120), radius=5.0, seed=11)
    for i, cam_id in enumerate(rig.ids):
        img = np.array(colors[i])
        img[:8], img[-8:], img[:, :8], img[:, -8:] = 0.5, 0.5, 0.5, 0.5
        os.makedirs(os.path.join(root, "color", cam_id))
        jio.write_color(os.path.join(root, "color", cam_id, "000000.png"), img, bit_depth=16)
    jcam.save_rig(os.path.join(root, "rig.json"), rig)

    def argv(side):
        return ["--color", os.path.join(root, "color"), "--rig_in", os.path.join(root, "rig.json"),
                "--matches", os.path.join(root, side, "matches.json"), "--rig_out",
                os.path.join(root, side, "rig_calibrated.json"), "--max_corners", "200", "--min_depth_m", "1",
                "--max_depth_m", "100", "--perturb_rotations", "0.02", "--lock_principals", "true",
                "--lock_focal", "true", "--pass_count", "2"]

    jcli.main(argv("jax"))
    return root, rig, argv


def test_calibration_cli_matches_jax(shoot, caplog):
    from facebook360_dep_tpu_torch.cli import calibration as tcli

    root, _, argv = shoot
    timings = {}
    with caplog.at_level(logging.INFO, logger="calibration"):
        median = tcli.main(argv("torch"), device="cpu", timings=timings)
    assert assert_matches_close(os.path.join(root, "torch", "matches.json"),
                                os.path.join(root, "jax", "matches.json")) > 100
    assert_json_close(os.path.join(root, "torch", "rig_calibrated.json"),
                      os.path.join(root, "jax", "rig_calibrated.json"))
    passes = [r.getMessage() for r in caplog.records if r.getMessage().startswith("pass ")]
    assert len(passes) == 2 and median <= 0.5
    assert set(timings) == {"match", "assemble", "triangulate", "lm", "pass_medians"}


def test_match_corners_cli_matches_jax(shoot):
    from facebook360_dep_tpu_torch.cli import calibration as tcli

    root, _, argv = shoot
    args = argv("torch_mc")[:6] + ["--max_corners", "200", "--min_depth_m", "1", "--max_depth_m", "100",
                                   "--enable_timing", "true"]
    out = tcli.main_match_corners(args, device="cpu")
    assert_matches_close(os.path.join(root, "torch_mc", "matches.json"), os.path.join(root, "jax", "matches.json"))
    assert sorted(out) == ["all_matches", "images"]


def test_geometric_cli_from_matches(shoot):
    """main_geometric on the JAX run's matches.json gives the JAX run's rig."""
    from facebook360_dep_tpu_torch.cli import calibration as tcli

    root, _, _ = shoot
    out = os.path.join(root, "torch_geo_matches", "rig.json")
    os.makedirs(os.path.dirname(out))
    tcli.main_geometric(["--rig_in", os.path.join(root, "rig.json"), "--matches",
                         os.path.join(root, "jax", "matches.json"), "--rig_out", out, "--perturb_rotations", "0.02",
                         "--lock_principals", "true", "--lock_focal", "true", "--pass_count", "2"], device="cpu")
    assert_json_close(out, os.path.join(root, "jax", "rig_calibrated.json"))


@pytest.mark.parametrize("flags", [
    ["--perturb_rotations", "0.01", "--perturb_principals", "1", "--point_error_stddev", "0.3"],
    ["--perturb_positions", "0.005", "--lock_positions", "false", "--robust", "false", "--seed", "2",
     "--point_error_stddev", "0"],
])
def test_geometric_cli_artificial_points(tmp_path, flags):
    """The four camera types with distortion (5 cameras, 160x120, turned),
    300 artificial points, 2 passes."""
    rig = turned(ring_rig(jcam, "FTHETA", n=5, resolution=(160, 120), ring_radius=0.2, mixed=True))
    rig_path = str(tmp_path / "rig.json")
    jcam.save_rig(rig_path, rig)

    def argv(side):
        return ["--rig_in", rig_path, "--rig_out", str(tmp_path / side / "rig.json"), "--point_count", "300",
                "--pass_count", "2"] + flags

    _, median = run_both("calibration", argv, str(tmp_path), fn="main_geometric")
    assert median < 0.8
    assert_json_close(str(tmp_path / "torch" / "rig.json"), str(tmp_path / "jax" / "rig.json"))


@pytest.fixture
def rig_files(tmp_path):
    rig = turned(ring_rig(jcam, "FTHETA", n=5, resolution=(64, 48), ring_radius=0.3, mixed=True))
    path = str(tmp_path / "rig.json")
    jcam.save_rig(path, rig)
    moved = jrt.transform_rig(rig, rotation([0.1, 0.2, -0.3]), [0.5, -0.2, 1.0], 1.3)
    moved_path = str(tmp_path / "moved.json")
    jcam.save_rig(moved_path, moved)
    return tmp_path, path, moved_path


def rotation(rotvec):
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(rotvec).as_matrix()


@pytest.mark.parametrize("flags", [["--randomize_rig", "true"], [], ["--lock_scale", "1", "--lock_rotation", "true"]])
def test_rig_aligner_cli(rig_files, flags):
    from facebook360_dep_tpu.cli import rig_aligner as jra
    from facebook360_dep_tpu_torch.cli import rig_aligner as tra

    tmp, path, moved = rig_files
    for side, mod in (("jax", jra), ("torch", tra)):
        mod.main(["--rig_in", moved, "--rig_reference", path, "--rig_out", str(tmp / f"{side}_aligned.json"),
                  "--transformed_rig", str(tmp / f"{side}_transformed.json")] + flags)
    assert_json_close(str(tmp / "torch_aligned.json"), str(tmp / "jax_aligned.json"), rtol=1e-9, atol=1e-9)
    if "--randomize_rig" in flags:
        assert_json_close(str(tmp / "torch_transformed.json"), str(tmp / "jax_transformed.json"), rtol=1e-12)


@pytest.mark.parametrize("skip_align", ["false", "true"])
def test_rig_compare_cli(rig_files, caplog, skip_align):
    from facebook360_dep_tpu.cli import rig_compare as jrc
    from facebook360_dep_tpu_torch.cli import rig_compare as trc

    _, path, moved = rig_files
    lines = {}
    for side, mod in (("jax", jrc), ("torch", trc)):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="rig"):
            mod.main(["--rig", moved, "--reference", path, "--skip_align", skip_align])
        lines[side] = [r.getMessage() for r in caplog.records if r.name == "rig"]
    assert len(lines["torch"]) == len(lines["jax"]) == 6 + (skip_align == "false")
    for g, w in zip(lines["torch"], lines["jax"]):
        gw, ww = g.split(), w.split()
        assert [x for x in gw if not _is_number(x)] == [x for x in ww if not _is_number(x)]
        np.testing.assert_allclose([float(x) for x in gw if _is_number(x)],
                                   [float(x) for x in ww if _is_number(x)], rtol=1e-6, atol=1e-9)


def _is_number(s):
    try:
        float(s)
    except ValueError:
        return False
    return True


def test_align_point_cloud_cli(tmp_path):
    import jax
    import jax.numpy as jnp

    from facebook360_dep_tpu.ops import sampling

    size = (64, 48)
    rig = turned(jsyn.make_test_rig(num_cameras=4, resolution=size, ring_radius=0.1))
    _, gt_disp = jsyn.render_sphere_scene(rig, size, radius=5.0)
    for i, cam_id in enumerate(rig.ids):
        os.makedirs(tmp_path / "disparity" / cam_id)
        jio.write_disparity(str(tmp_path / "disparity" / cam_id / "000000.pfm"), np.asarray(gt_disp[i]))
    jcam.save_rig(str(tmp_path / "rig.json"), rig)
    c0 = jcam.rescale(rig.camera(0), [size[0], size[1]])
    world = np.asarray(jcam.rig_point(jax.tree.map(jnp.asarray, c0), sampling.pixel_center_grid(size[1], size[0]),
                                      jnp.asarray(1.0 / np.asarray(gt_disp[0])))).reshape(-1, 3)
    np.savetxt(str(tmp_path / "cloud.xyz"), world + np.asarray([0.05, -0.02, 0.03]))

    def argv(side):
        return ["--point_cloud", str(tmp_path / "cloud.xyz"), "--rig_in", str(tmp_path / "rig.json"),
                "--rig_out", str(tmp_path / side / "aligned.json"), "--disparity", str(tmp_path / "disparity"),
                "--cameras", "cam0,cam2", "--max_points_per_cam", "1500", "--iterations", "8"]

    want, got = run_both("align_point_cloud", argv, str(tmp_path))
    assert got == pytest.approx(want, rel=1e-9) and got < 0.02
    assert_json_close(str(tmp_path / "torch" / "aligned.json"), str(tmp_path / "jax" / "aligned.json"),
                      rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("calibrated", [False, True])
def test_align_colors_cli(tmp_path, calibrated):
    size = (80, 60)
    base = turned(ring_rig(jcam, "RECTILINEAR", n=3, resolution=size, ring_radius=0.2))
    colors, _ = jsyn.render_sphere_scene(base, size, radius=5.0, seed=3)
    for i, cam_id in enumerate(base.ids):
        os.makedirs(tmp_path / "color" / cam_id)
        jio.write_color(str(tmp_path / "color" / cam_id / "000000.png"), np.asarray(colors[i]), bit_depth=16)
    paths = {}
    for ch, (fscale, d0) in {"red": (1.004, -0.045), "green": (1.0, -0.05), "blue": (0.995, -0.056)}.items():
        cams = base.cameras._replace(focal=np.asarray(base.cameras.focal) * fscale)
        cams = cams._replace(distortion=np.asarray(cams.distortion) * 0 + np.asarray([d0, 0.004, 0.0]))
        paths[ch] = str(tmp_path / f"rig_{ch}.json")
        jcam.save_rig(paths[ch], base._replace(cameras=cams))
    extra = ["--calibrated_rig", paths["green"]] if calibrated else []

    def argv(side):
        return ["--rig_red", paths["red"], "--rig_green", paths["green"], "--rig_blue", paths["blue"],
                "--color", str(tmp_path / "color"), "--output", str(tmp_path / side / "aligned")] + extra

    run_both("align_colors", argv, str(tmp_path))
    changed = 0
    for cam_id in base.ids:
        rel = os.path.join("aligned", cam_id, "000000.png")
        got = tio.read_png(str(tmp_path / "torch" / rel)).astype(np.int64)
        want = tio.read_png(str(tmp_path / "jax" / rel)).astype(np.int64)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.abs(got - want).max() <= 1
        src = tio.read_png(str(tmp_path / "color" / cam_id / "000000.png")).astype(np.int64)
        changed += int((np.abs(got[..., [0, 2]] - src[..., [0, 2]]) > 1).sum())
        np.testing.assert_array_equal(got[..., 1], src[..., 1])
    assert changed > 0


# ---------------------------------------------------------------------------
# flags
# ---------------------------------------------------------------------------


class _Captured(Exception):
    def __init__(self, parser):
        self.parser = parser


def _capture_parser(module_name, fn):
    """Build a CLI's parser by running it up to parse_args (as
    tests/test_flag_parity.py:130-145 does)."""
    mod = importlib.import_module(module_name)
    orig = argparse.ArgumentParser.parse_args

    def trap(self, *a, **k):
        raise _Captured(self)

    argparse.ArgumentParser.parse_args = trap
    try:
        getattr(mod, fn)([])
    except _Captured as c:
        return c.parser
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError(f"{module_name}.{fn} never called parse_args")


@pytest.mark.parametrize("entry", ["calibration.main", "calibration.main_match_corners",
                                   "calibration.main_geometric", "rig_aligner.main", "rig_compare.main",
                                   "align_point_cloud.main", "align_colors.main"])
def test_cli_options_and_defaults_match_jax(entry):
    name, fn = entry.split(".")

    def options(parser):
        return {s: (a.default, a.required, getattr(a.type, "__name__", None), type(a).__name__)
                for a in parser._actions for s in a.option_strings if s not in ("-h", "--help")}

    want = options(_capture_parser(f"facebook360_dep_tpu.cli.{name}", fn))
    got = options(_capture_parser(f"facebook360_dep_tpu_torch.cli.{name}", fn))
    assert got == want
