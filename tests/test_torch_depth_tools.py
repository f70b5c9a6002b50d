"""The port's foreground/background depth-chain CLIs against the JAX
package's, file for file on one tiny project (4 cameras, 80x60, 3 frames,
3 pyramid levels): resize_images (colors and --threshold masks),
generate_foreground_masks, temporal_bilateral_filter, upsample_disparity
and layer_disparities, plus each CLI's options and defaults."""

import argparse
import importlib
import os

import numpy as np
import pytest

from facebook360_dep_tpu.core import camera as jcam
from facebook360_dep_tpu.core import imagetypes
from facebook360_dep_tpu.core import io as jio
from facebook360_dep_tpu.render import synthetic as jsyn
from facebook360_dep_tpu_torch.core import io as tio

from torch_parity import f32

FRAMES = ("000000", "000001", "000002")
WIDTHS = "80,56,40"  # levels 0..2 of the 80x60 frames: 80x60, 56x42, 40x30
CLIS = ["resize_images", "generate_foreground_masks", "temporal_bilateral_filter", "upsample_disparity",
        "layer_disparities"]
# the CLIs that compute on a device (the card unless the caller names another)
DEVICE_CLIS = {"generate_foreground_masks", "temporal_bilateral_filter", "upsample_disparity"}


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """Full-resolution colors of a background and of three frames with a
    textured patch moving 3 px a frame, written by the JAX package (cv2
    PNG16), a noisy disparity solve of every frame at levels 0 and 1, and
    a background solve at level 0."""
    root = str(tmp_path_factory.mktemp("torch_tools_project"))
    rig = jsyn.make_test_rig(num_cameras=4, resolution=(80, 60), ring_radius=0.3)
    colors, gt = jsyn.render_sphere_scene(rig, (80, 60), radius=5.0)
    rng = np.random.RandomState(0)
    patch = f32(rng.rand(14, 18, 3))
    for i, cam_id in enumerate(rig.ids):
        d = imagetypes.image_dir(root, "background_color", cam_id=cam_id)
        os.makedirs(d, exist_ok=True)
        jio.write_color(os.path.join(d, "000000.png"), colors[i], bit_depth=16)
        bgd = imagetypes.image_dir(root, "background_disp", cam_id=cam_id)
        os.makedirs(bgd, exist_ok=True)
        jio.write_pfm(os.path.join(bgd, "000000.pfm"), f32(np.nan_to_num(gt[i], nan=1e-4) * 0.8))
        for f, frame in enumerate(FRAMES):
            img = colors[i].copy()
            img[20:34, 25 + 3 * f:43 + 3 * f] = patch
            d = imagetypes.image_dir(root, "color", cam_id=cam_id)
            os.makedirs(d, exist_ok=True)
            jio.write_color(os.path.join(d, frame + ".png"), img, bit_depth=16)
            for level, size in ((0, (80, 60)), (1, (56, 42))):
                disp = np.nan_to_num(gt[i], nan=1e-4)
                disp = disp if level == 0 else jio.resize_image(disp, size)
                disp = f32(disp * (1 + 0.05 * rng.randn(*disp.shape)))
                disp[:2, :3] = np.nan
                d = imagetypes.image_dir(os.path.join(root, "solve"), "disparity_levels", level, cam_id)
                os.makedirs(d, exist_ok=True)
                jio.write_pfm(os.path.join(d, frame + ".pfm"), disp)
    os.makedirs(os.path.join(root, "rigs"), exist_ok=True)
    rig_path = os.path.join(root, "rigs/rig_calibrated.json")
    jcam.save_rig(rig_path, rig)
    return root, rig, rig_path


def _run_both(name, argv_for):
    """Run the JAX CLI and the port's CLI; ``argv_for(out)`` builds each argv."""
    jmod = importlib.import_module(f"facebook360_dep_tpu.cli.{name}")
    tmod = importlib.import_module(f"facebook360_dep_tpu_torch.cli.{name}")
    jmod.main(argv_for("jax"))
    tmod.main(argv_for("torch"), **({"device": "cpu"} if name in DEVICE_CLIS else {}))


def _files(root):
    out = []
    for d, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(d, n), root) for n in names]
    return sorted(out)


def _same_tree(a, b, atol=0.0):
    """Both trees hold the same files; PNGs decode to the same values
    (``atol`` in PNG units), PFMs/EXRs to the same maps within ``atol``."""
    names = _files(a)
    assert names and names == _files(b)
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if n.endswith(".png"):
            want, got = tio.read_png(pa).astype(np.int64), tio.read_png(pb).astype(np.int64)
        else:
            want, got = jio.read_disparity(pa), tio.read_disparity(pb)
        assert got.shape == want.shape, n
        np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=n)
    return names


@pytest.fixture(scope="module")
def pyramids(project):
    """Both packages' resize_images of the frames, generate_foreground_masks
    at full width, and resize_images --threshold 0.5 of the JAX package's
    masks: <root>/{jax,torch}/{color_levels,masks,mask_levels}."""
    root, rig, rig_path = project
    _run_both("resize_images", lambda out: [
        "--rig", rig_path, "--color", imagetypes.image_dir(root, "color"), "--first", "000000",
        "--last", "000002", "--widths", WIDTHS, "--output", os.path.join(root, out, "color_levels")])
    _run_both("generate_foreground_masks", lambda out: [
        "--rig", rig_path, "--background_color", imagetypes.image_dir(root, "background_color"),
        "--color", imagetypes.image_dir(root, "color"), "--foreground_masks", os.path.join(root, out, "masks"),
        "--first", "000000", "--last", "000002", "--width", "80"])
    _run_both("resize_images", lambda out: [
        "--rig", rig_path, "--color", os.path.join(root, "jax", "masks"), "--first", "000000", "--last", "000002",
        "--widths", WIDTHS, "--threshold", "0.5", "--output", os.path.join(root, out, "mask_levels")])
    return root


def test_resize_images_colors_and_masks_match_jax(pyramids):
    """Colors: cv2's INTER_AREA to each level, PNG16, identical files.
    Masks (--threshold 0.5 of the generated 8-bit masks, written as RGB
    PNG16): identical, and read_mask reads them as the JAX package does."""
    root = pyramids
    names = _same_tree(os.path.join(root, "jax", "color_levels"), os.path.join(root, "torch", "color_levels"))
    assert len(names) == 3 * 4 * 3
    names = _same_tree(os.path.join(root, "jax", "mask_levels"), os.path.join(root, "torch", "mask_levels"))
    for n in names:
        m = tio.read_mask(os.path.join(root, "torch", "mask_levels", n))
        np.testing.assert_array_equal(m, jio.read_mask(os.path.join(root, "jax", "mask_levels", n)))
    assert 0.02 < m.mean() < 0.5


def test_generate_foreground_masks_matches_jax(project):
    """Same 8-bit masks, with the frames at full width and resized to half
    width (--width 40: INTER_AREA of background and frame). A mask pixel
    may differ only where the blurred difference norm is within 1e-5 of
    the threshold; none does here."""
    root, rig, rig_path = project
    for width in ("80", "40"):
        _run_both("generate_foreground_masks", lambda out: [
            "--rig", rig_path, "--background_color", imagetypes.image_dir(root, "background_color"),
            "--color", imagetypes.image_dir(root, "color"), "--first", "000000", "--last", "000002",
            "--width", width, "--foreground_masks", os.path.join(root, out, f"masks_{width}")])
        names = _same_tree(os.path.join(root, "jax", f"masks_{width}"), os.path.join(root, "torch", f"masks_{width}"))
        assert len(names) == 12
        m = tio.read_mask(os.path.join(root, "torch", f"masks_{width}", "cam0", "000001.png"))
        assert m.shape == (int(width) * 3 // 4, int(width)) and 0.02 < m.mean() < 0.5


def test_temporal_bilateral_filter_matches_jax(project, pyramids):
    """Three frames at level 0, the window read from disk, with and without
    foreground masks: atol 1e-6 on disparities ~0.2 (as the op's test)."""
    root, rig, rig_path = project
    for use_fg in ("false", "true"):
        _run_both("temporal_bilateral_filter", lambda out: [
            "--rig", rig_path, "--input_root", root, "--output_root", os.path.join(root, out, f"tbf_{use_fg}"),
            "--color", os.path.join(root, "jax", "color_levels"), "--disparity",
            imagetypes.image_dir(os.path.join(root, "solve"), "disparity_levels"),
            "--foreground_masks", os.path.join(root, "jax", "mask_levels"), "--use_foreground_masks", use_fg,
            "--first", "000000", "--last", "000002", "--level", "0"])
        names = _same_tree(os.path.join(root, "jax", f"tbf_{use_fg}"), os.path.join(root, "torch", f"tbf_{use_fg}"),
                           atol=1e-6)
        assert len(names) == 12 and all(n.startswith("disparity_time_filtered_levels/level_0/") for n in names)


@pytest.mark.parametrize("mode", ["plain", "color", "foreground"])
def test_upsample_disparity_matches_jax(project, pyramids, mode):
    """Level 1 (56x42) to 80 px wide: Lanczos4 (plain, atol 5e-7 as the
    resize test), then the joint bilateral guided by the full-res color
    (radius (80/56)^2 + 1 = 3; rtol 2e-6 as the solver's filter test), or
    the foreground branch with masks at both levels and the background
    disparity (copies only: identical)."""
    root, rig, rig_path = project
    levels = imagetypes.image_dir(os.path.join(root, "solve"), "disparity_levels")
    argv = ["--rig", rig_path, "--disparity", os.path.join(levels, "level_1"), "--resolution", "80",
            "--first", "000000", "--last", "000001", "--output_formats", "pfm,exr"]
    if mode == "color":
        argv += ["--color", imagetypes.image_dir(root, "color")]
    if mode == "foreground":
        masks = os.path.join(root, "jax", "mask_levels")
        argv += ["--foreground_masks_in", os.path.join(masks, "level_1"),
                 "--foreground_masks_out", os.path.join(masks, "level_0"),
                 "--background_disp", imagetypes.image_dir(root, "background_disp")]
    _run_both("upsample_disparity", lambda out: argv + ["--output", os.path.join(root, out, f"up_{mode}")])
    atol = {"plain": 5e-7, "color": 2e-6, "foreground": 0.0}[mode]
    names = _same_tree(os.path.join(root, "jax", f"up_{mode}"), os.path.join(root, "torch", f"up_{mode}"), atol=atol)
    assert len(names) == 16
    up = tio.read_disparity(os.path.join(root, "torch", f"up_{mode}", "cam2", "000001.pfm"))
    assert up.shape == (60, 80) and np.isfinite(up).all()


def test_layer_disparities_matches_jax(project):
    root, rig, rig_path = project
    fg_dir = os.path.join(root, "fg_disp")
    for i, cam_id in enumerate(rig.ids):
        os.makedirs(os.path.join(fg_dir, cam_id), exist_ok=True)
        for f, frame in enumerate(FRAMES):
            d = f32(np.random.RandomState(i * 3 + f).rand(60, 80) * 0.5)
            d[d < 0.2] = 0.0
            d[:5, :5] = np.nan
            jio.write_pfm(os.path.join(fg_dir, cam_id, frame + ".pfm"), d)
    _run_both("layer_disparities", lambda out: [
        "--rig", rig_path, "--background_disp", imagetypes.image_dir(root, "background_disp"),
        "--foreground_disp", fg_dir, "--output", os.path.join(root, out, "layered"), "--first", "000000",
        "--last", "000002"])
    names = _same_tree(os.path.join(root, "jax", "layered"), os.path.join(root, "torch", "layered"))
    assert len(names) == 12


class _Captured(Exception):
    def __init__(self, parser):
        self.parser = parser


def _capture_parser(module_name):
    """Build a CLI's parser by running main() up to parse_args (as
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


@pytest.mark.parametrize("name", CLIS)
def test_cli_options_and_defaults_match_jax(name):
    def options(parser):
        return {s: (a.default, a.required, getattr(a.type, "__name__", None))
                for a in parser._actions for s in a.option_strings if s not in ("-h", "--help")}

    want = options(_capture_parser(f"facebook360_dep_tpu.cli.{name}"))
    got = options(_capture_parser(f"facebook360_dep_tpu_torch.cli.{name}"))
    assert got == want
