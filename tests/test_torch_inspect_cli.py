"""The port's fixture generator and inspection CLIs against the JAX
package's, on the same files, with ``device="cpu"``: rig_simulator's trees
file by file in five modes, then each subcommand of rig_analyzer,
render_tools, conversions and view_thresholds on one small sphere tree,
then each new CLI's options and defaults.

Tolerances: PNG16 colors within 1 LSB (the renders agree to ~1e-5 in
float32, so a value near a rounding boundary lands one step apart; the
2/3-step pyramid resize itself is bit-identical on equal inputs); PFM
disparities within 2e-6 relative with equal NaNs; rig JSONs and OBJ text
equal; 8-bit PNGs within 1 LSB, coverage counts on all but 0.5% of pixels
(a projection at a pixel edge); point clouds within 1e-4 m (float32 rig
points printed with 6 decimals).

``render_tools generate_equirect`` is held to the true equirect instead:
the JAX tool rescales the rig to the image and then multiplies the
projected pixel by the image size again, so nearly every tap clamps to an
edge; its mean error is shown to be the scene's own spread.
"""

import argparse
import glob
import importlib
import json
import os

import numpy as np
import pytest

from facebook360_dep_tpu.core import io as jio
from facebook360_dep_tpu_torch.core import io as tio
from facebook360_dep_tpu_torch.render import synthetic as tsyn

import torch_parity  # noqa: F401  (two torch threads per worker)

PNG16_LSB = 1
PFM_RTOL = 2e-6
COUNT_DIFF_FRAC = 0.005
CLOUD_ATOL = 1e-4


def run_both(module, argv_of, tmp):
    """Run the JAX CLI and the port's (on the CPU) with ``argv_of(side)``."""
    jmod = importlib.import_module(f"facebook360_dep_tpu.cli.{module}")
    tmod = importlib.import_module(f"facebook360_dep_tpu_torch.cli.{module}")
    for side in ("jax", "torch"):
        os.makedirs(os.path.join(tmp, side), exist_ok=True)
    jmod.main(argv_of("jax"))
    tmod.main(argv_of("torch"), device="cpu")


def files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "**", "*"), recursive=True)
                  if os.path.isfile(p))


def assert_same_file(want, got, png_lsb=PNG16_LSB, count_image=False):
    if want.endswith(".png"):
        a, b = tio.read_png(want).astype(np.int64), tio.read_png(got).astype(np.int64)
        assert a.shape == b.shape, want
        if count_image:
            assert (a != b).any(axis=-1).mean() <= COUNT_DIFF_FRAC, want
        else:
            assert np.abs(a - b).max() <= png_lsb, want
    elif want.endswith(".pfm"):
        a, b = jio.read_pfm(want), tio.read_pfm(got)
        assert a.shape == b.shape and np.array_equal(np.isnan(a), np.isnan(b)), want
        ok = ~np.isnan(a)
        np.testing.assert_allclose(b[ok], a[ok], rtol=PFM_RTOL, atol=1e-12, err_msg=want)
    elif want.endswith(".json"):
        with open(want) as f, open(got) as g:
            assert json.load(f) == json.load(g), want
    elif want.endswith(".obj"):  # equal but for the directory of a referenced .mtl
        with open(want) as f, open(got) as g:
            a, b = f.read().splitlines(), g.read().splitlines()
        if a and a[0].startswith("mtllib "):
            assert os.path.basename(a[0]) == os.path.basename(b[0]), want
            a, b = a[1:], b[1:]
        assert a == b, want
    else:
        with open(want, "rb") as f, open(got, "rb") as g:
            assert f.read() == g.read(), want


def assert_same_tree(want_root, got_root, **kw):
    names = files(want_root)
    assert names and names == files(got_root)
    for name in names:
        assert_same_file(os.path.join(want_root, name), os.path.join(got_root, name), **kw)
    return names


# ---------------------------------------------------------------------------
# rig_simulator
# ---------------------------------------------------------------------------

SIM_MODES = {
    "sphere": lambda d: ["--dest", d, "--num_cameras", "3", "--resolution", "48", "--levels", "3",
                         "--eqr_width", "32"],
    "occluders": lambda d: ["--dest", d, "--scene", "occluders", "--num_occluders", "2", "--num_cameras", "2",
                            "--resolution", "40", "--levels", "2", "--eqr_width", "32"],
    "ftheta_ring_box": lambda d: ["--dest", d, "--mode", "ftheta_ring", "--num_cams_in_ring", "3",
                                  "--resolution", "36", "--scene", "box", "--levels", "2", "--distortion", "true",
                                  "--rig_out", f"{d}/rig_out.json", "--dest_cam_images", f"{d}/cams"],
    "mono_eqr": lambda d: ["--mode", "mono_eqr", "--scene", "box", "--eqr_width", "48",
                           "--dest_mono", f"{d}/mono.png", "--dest_mono_depth", f"{d}/mono_depth.pfm"],
    "stereo_eqr": lambda d: ["--mode", "stereo_eqr", "--eqr_width", "48", "--dest_left", f"{d}/l.png",
                             "--dest_right", f"{d}/r.png", "--dest_stereo", f"{d}/s.png"],
}


@pytest.mark.parametrize("mode", sorted(SIM_MODES))
def test_rig_simulator_tree_matches_jax(tmp_path, mode):
    run_both("rig_simulator", lambda side: SIM_MODES[mode](str(tmp_path / side)), str(tmp_path))
    names = assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))
    if mode == "sphere":
        assert "truth_eqr/000000_disparity.pfm" in names
        assert [n for n in names if n.startswith("video/color_levels/level_2/")]


def test_simulator_pyramid_resize_is_bit_identical():
    """The 2/3-step pyramid of 2048 (2048, 1365, 910, ...) at a small scale:
    the port's INTER_AREA equals the JAX CLI's on one float input."""
    from facebook360_dep_tpu_torch.cli import rig_simulator as tsim

    sizes = tsim.pyramid_sizes(96, 72, 5)
    assert sizes == [(96, 72), (64, 48), (42, 32), (28, 21), (18, 14)]
    img = np.random.RandomState(0).rand(72, 96, 3).astype(np.float32)
    for size in sizes[1:]:
        assert np.array_equal(tio.resize_image(img, size), jio.resize_image(img, size)), size


# ---------------------------------------------------------------------------
# inspection tools on one tree
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A 4-camera sphere tree at 64x48 (the port's rig_simulator), with the
    truth as disparity and a copy whose camera 1 holds a wrong patch."""
    from facebook360_dep_tpu_torch.cli import rig_simulator as tsim

    root = tmp_path_factory.mktemp("tree")
    tsim.main(["--dest", str(root), "--num_cameras", "4", "--resolution", "64", "--levels", "1",
               "--eqr_width", "64"], device="cpu")
    for cid in ("cam0", "cam1", "cam2", "cam3"):
        disp = tio.read_pfm(str(root / "truth" / cid / "000000.pfm"))
        if cid == "cam1":
            disp = disp.copy()
            disp[10:22, 20:36] *= 3.0
        os.makedirs(root / "noisy" / cid, exist_ok=True)
        tio.write_pfm(str(root / "noisy" / cid / "000000.pfm"), disp)
    return root


def _paths(tree):
    return dict(rig=str(tree / "rigs/rig_calibrated.json"), color=str(tree / "video/color_levels/level_0"),
                truth=str(tree / "truth"), noisy=str(tree / "noisy"))


def test_rig_analyzer_matches_jax(tree, tmp_path):
    p = _paths(tree)
    run_both("rig_analyzer", lambda s: [
        "--rig", p["rig"], "--output", str(tmp_path / s / "report"), "--depths", "5",
        "--eqr_width", "64", "--eqr_height", "32", "--output_equirect", str(tmp_path / s / "eqr.png"),
        "--output_cross_section", str(tmp_path / s / "cross.png"), "--output_camera", str(tmp_path / s / "c1.png"),
        "--output_camera_id", "cam1", "--output_obj", str(tmp_path / s / "frusta.obj")], str(tmp_path))
    names = assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"), count_image=True)
    assert "report/rig.obj" in names and "report/coverage_5m.png" in names
    cov = tio.read_png(str(tmp_path / "torch" / "report" / "coverage_5m.png"))
    assert cov.max() > 0


def test_rig_analyzer_rearrange_matches_jax(tree, tmp_path):
    p = _paths(tree)
    run_both("rig_analyzer", lambda s: [
        "--rig", p["rig"], "--rearrange", "tetra", "--output_rig", str(tmp_path / s / "tetra.json"),
        "--output_equirect", str(tmp_path / s / "eqr.png"), "--eqr_width", "48", "--eqr_height", "24"],
        str(tmp_path))
    assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"), count_image=True)


def test_render_tools_geometric_consistency_matches_jax(tree, tmp_path):
    """The mismatch pass (K1's twin) adjusts the same pixels; maps within
    the solver tests' tolerance."""
    p = _paths(tree)
    run_both("render_tools", lambda s: [
        "geometric_consistency", "--rig", p["rig"], "--color", p["color"], "--disparity", p["noisy"],
        "--output", str(tmp_path / s), "--iterations", "2"], str(tmp_path))
    assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))
    before = tio.read_pfm(os.path.join(p["noisy"], "cam1", "000000.pfm"))
    after = tio.read_pfm(str(tmp_path / "torch" / "cam1" / "000000.pfm"))
    assert (before != after).sum() > 0  # the wrong patch was adjusted


@pytest.mark.parametrize("sub, extra", [
    ("generate_camera_overlaps", ["--depth", "5", "--min_overlap", "0.1", "--cameras", "cam0,cam1"]),
    ("generate_keypoint_projections", ["--grid", "6", "--extent", "4"]),
])
def test_render_tools_subcommand_matches_jax(tree, tmp_path, sub, extra):
    p = _paths(tree)

    def argv(s):
        base = [sub, "--rig", p["rig"], "--output", str(tmp_path / s)]
        return base + (["--color", p["color"]] if sub == "generate_camera_overlaps" else []) + extra

    run_both("render_tools", argv, str(tmp_path))
    names = assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"), png_lsb=1)
    assert len(names) >= 2


def test_render_tools_generate_equirect_against_truth(tree, tmp_path):
    """At depth = the sphere's radius every camera's projection lands on the
    true surface: the port's average matches the true equirect; the JAX
    tool's double-scaled taps do not (its error is the scene's spread)."""
    p = _paths(tree)
    run_both("render_tools", lambda s: [
        "generate_equirect", "--rig", p["rig"], "--color", p["color"], "--output", str(tmp_path / s),
        "--num_depths", "1", "--min_depth", "5", "--max_depth", "5", "--eqr_width", "64", "--eqr_height", "32"],
        str(tmp_path))
    truth, _ = tsyn.ground_truth_equirect(None, 64, 32, "sphere", 5.0, seed=7)
    truth = truth.numpy()
    port = tio.read_png(str(tmp_path / "torch" / "eqr_depth_5.00.png")).astype(np.float64) / 255.0
    jax_out = tio.read_png(str(tmp_path / "jax" / "eqr_depth_5.00.png")).astype(np.float64) / 255.0
    covered = port.sum(-1) > 0
    assert covered.mean() > 0.1
    port_err = np.abs(port - truth)[covered].mean()
    jax_err = np.abs(jax_out - truth)[covered].mean()
    assert port_err < 0.03, port_err
    assert jax_err > 0.1 and jax_err > 0.5 * truth[covered].std(), jax_err


def test_conversions_point_cloud_matches_jax(tree, tmp_path):
    p = _paths(tree)
    run_both("conversions", lambda s: [
        "export_point_cloud", "--rig", p["rig"], "--disparity", p["truth"], "--color", p["color"],
        "--output", str(tmp_path / s / "cloud.xyz"), "--cameras", "cam0,cam2"], str(tmp_path))
    want = np.loadtxt(tmp_path / "jax" / "cloud.xyz")
    got = np.loadtxt(tmp_path / "torch" / "cloud.xyz")
    assert want.shape == got.shape and want.shape[1] == 6
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=CLOUD_ATOL)
    np.testing.assert_allclose(got[:, 3:], want[:, 3:], atol=1e-5)


def _jax_import_point_cloud(rig_path, cloud, width, height, cam_ids):
    """The JAX CLI's import_point_cloud body with its validity array copied:
    the CLI itself ANDs into the read-only view np.asarray gives of a JAX
    array and raises (test below)."""
    import jax
    import jax.numpy as jnp

    from facebook360_dep_tpu.core import camera as jcam

    rig = jcam.load_rig(rig_path)
    pts = np.loadtxt(cloud)[:, :3].astype(np.float32)
    out = {}
    for i, cam_id in enumerate(rig.ids):
        if cam_id not in cam_ids:
            continue
        c = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32) if jnp.asarray(a).dtype.kind == "f"
                         else jnp.asarray(a), jcam.rescale(rig.camera(i), [width, height]))
        pix, valid = jcam.sees(c, jnp.asarray(pts))
        pix, valid = np.asarray(pix), np.array(valid)
        dist = np.linalg.norm(pts - np.asarray(c.position), axis=-1)
        xi = np.clip(pix[:, 0].astype(int), 0, width - 1)
        yi = np.clip(pix[:, 1].astype(int), 0, height - 1)
        zbuf = np.full((height, width), np.inf, np.float32)
        np.minimum.at(zbuf, (yi[valid], xi[valid]), dist[valid])
        out[cam_id] = np.where(np.isfinite(zbuf), 1.0 / np.maximum(zbuf, 1e-12), np.nan)
    return out


def test_conversions_import_point_cloud_against_jax_functions(tree, tmp_path):
    """The JAX CLI's import_point_cloud raises (a read-only array, ROADMAP
    queue C); the port's splat equals that body run with the JAX package's
    camera, and camera 0's own points land back on its truth."""
    from facebook360_dep_tpu.cli import conversions as jconv
    from facebook360_dep_tpu_torch.cli import conversions as tconv

    p = _paths(tree)
    cloud = str(tmp_path / "cloud.xyz")
    tconv.main(["export_point_cloud", "--rig", p["rig"], "--disparity", p["truth"], "--output", cloud,
                "--cameras", "cam0"], device="cpu")
    argv = ["import_point_cloud", "--rig", p["rig"], "--point_cloud", cloud, "--width", "64",
            "--cameras", "cam0,cam1"]
    with pytest.raises(ValueError, match="read-only"):
        jconv.main(argv + ["--output", str(tmp_path / "jax")])
    tconv.main(argv + ["--output", str(tmp_path / "torch")], device="cpu")
    want = _jax_import_point_cloud(p["rig"], cloud, 64, 48, ("cam0", "cam1"))
    for cam_id, w in want.items():
        got = tio.read_pfm(str(tmp_path / "torch" / cam_id / "000000.pfm"))
        assert np.array_equal(np.isnan(got), np.isnan(w)), cam_id
        np.testing.assert_allclose(got[~np.isnan(w)], w[~np.isnan(w)], rtol=PFM_RTOL)
    back = tio.read_pfm(str(tmp_path / "torch" / "cam0" / "000000.pfm"))
    truth = tio.read_pfm(os.path.join(p["truth"], "cam0", "000000.pfm"))
    ok = np.isfinite(back)
    assert ok.mean() > 0.9
    np.testing.assert_allclose(back[ok], truth[ok], rtol=1e-5)
    assert np.isfinite(tio.read_pfm(str(tmp_path / "torch" / "cam1" / "000000.pfm"))).any()


def test_conversions_projections_match_jax(tree, tmp_path):
    p = _paths(tree)
    run_both("conversions", lambda s: [
        "project_cameras_to_equirects", "--rig", p["rig"], "--color", p["color"],
        "--output", str(tmp_path / s / "eqr"), "--depth", "5", "--eqr_width", "64", "--eqr_height", "32",
        "--cameras", "cam0,cam1"],
        str(tmp_path))
    run_both("conversions", lambda s: [
        "project_equirects_to_cameras", "--rig", p["rig"], "--eqr", str(tree / "truth_eqr/000000_color.png"),
        "--output", str(tmp_path / s / "cams"), "--depth", "5", "--width", "48", "--cameras", "cam0,cam1"],
        str(tmp_path))
    # camera 0's equirect as every camera's mask root
    for cid in ("cam0", "cam1"):
        os.makedirs(tmp_path / "masks" / cid, exist_ok=True)
        src = tmp_path / "jax" / "eqr" / "cam0" / "000000.png"
        (tmp_path / "masks" / cid / "000000.png").write_bytes(src.read_bytes())
    run_both("conversions", lambda s: [
        "project_equirects_to_cameras", "--rig", p["rig"], "--eqr_masks", str(tmp_path / "masks"),
        "--output", str(tmp_path / s / "masked"), "--depth", "5", "--width", "48", "--cameras", "cam0,cam1"],
        str(tmp_path))
    names = assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"), png_lsb=1)
    assert len(names) == 6
    proj = tio.read_png(str(tmp_path / "torch" / "cams" / "cam0" / "000000.png"))
    assert proj.shape == (36, 48, 3) and proj.std() > 0


def test_conversions_host_tools_match_jax(tree, tmp_path):
    png16 = str(tmp_path / "disp.png")
    disp = tio.read_pfm(str(tree / "truth_eqr/000000_disparity.pfm"))
    tio.write_png(png16, np.round(disp / disp.max() * 65535.0).astype(np.uint16))
    run_both("conversions", lambda s: ["png_to_pfm", "--png", png16, "--pfm", str(tmp_path / s / "d.pfm")],
             str(tmp_path))
    run_both("conversions", lambda s: [
        "create_obj_from_disparity_equirect", "--disparity", str(tree / "truth_eqr/000000_disparity.pfm"),
        "--output", str(tmp_path / s / "eqr.obj"), "--create_mtl", "--input_png_color",
        str(tree / "truth_eqr/000000_color.png"), "--num_faces", "1000"], str(tmp_path))
    names = assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))
    assert names == ["d.pfm", "eqr.mtl", "eqr.obj"]
    with open(tmp_path / "torch" / "eqr.obj") as f:
        faces = sum(1 for line in f if line.startswith("f "))
    assert 0 < faces <= 1000


def test_view_thresholds_match_jax(tree, tmp_path):
    p = _paths(tree)
    img0 = os.path.join(p["color"], "cam0", "000000.png")
    img1 = os.path.join(p["color"], "cam1", "000000.png")
    run_both("view_thresholds", lambda s: [
        "color_variance", "--fullsize_image", img0, "--width", "48", "--steps", "3",
        "--output_dir", str(tmp_path / s / "var")], str(tmp_path))
    run_both("view_thresholds", lambda s: [
        "foreground_masks", "--fullsize_bg_image", img0, "--fullsize_fg_image", img1, "--width", "48",
        "--steps", "2", "--blur_radius_max", "3", "--morph_closing_size_max", "4",
        "--output_dir", str(tmp_path / s / "masks")], str(tmp_path))
    names = files(str(tmp_path / "jax"))
    assert names == files(str(tmp_path / "torch")) and len(names) == 4 + 8 + 1
    for name in names:
        want, got = str(tmp_path / "jax" / name), str(tmp_path / "torch" / name)
        if name.endswith(".json"):
            with open(want) as f, open(got) as g:
                a, b = json.load(f), json.load(g)
            assert json.dumps(a, sort_keys=True).count(":") == json.dumps(b, sort_keys=True).count(":")
            np.testing.assert_allclose(_numbers(b), _numbers(a), rtol=1e-4, atol=1e-7, err_msg=name)
        else:
            assert_same_file(want, got, png_lsb=1, count_image=name.startswith("masks/"))


def _numbers(obj):
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in _numbers(obj[k])]
    if isinstance(obj, list):
        return [x for v in obj for x in _numbers(v)]
    return [float(obj)]


# ---------------------------------------------------------------------------
# flags
# ---------------------------------------------------------------------------


class _Captured(Exception):
    def __init__(self, parser):
        self.parser = parser


def _capture_parser(module_name):
    """Build a CLI's parser by running it up to parse_args (as
    tests/test_flag_parity.py:130-145 does)."""
    mod = importlib.import_module(module_name)
    orig = argparse.ArgumentParser.parse_args

    def trap(self, *a, **k):
        raise _Captured(self)

    argparse.ArgumentParser.parse_args = trap
    try:
        mod.main([])
    except _Captured as c:
        return c.parser
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError(f"{module_name}.main never called parse_args")


def _options(parser, prefix=""):
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            for name, sub in a.choices.items():
                out.update(_options(sub, f"{prefix}{name} "))
        for s in a.option_strings:
            if s not in ("-h", "--help"):
                out[prefix + s] = (a.default, a.required, getattr(a.type, "__name__", None), type(a).__name__,
                                   tuple(a.choices) if a.choices else None)
    return out


@pytest.mark.parametrize("name", ["rig_simulator", "rig_analyzer", "render_tools", "conversions",
                                  "view_thresholds", "gl_viewer"])
def test_cli_options_and_defaults_match_jax(name):
    want = _options(_capture_parser(f"facebook360_dep_tpu.cli.{name}"))
    got = _options(_capture_parser(f"facebook360_dep_tpu_torch.cli.{name}"))
    assert len(want) > 3 and got == want
