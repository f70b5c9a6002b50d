"""The port's depth-estimation slice end to end: facebook360_dep_tpu_torch's
derp_cli against the JAX package's on the tests/test_derp_cli.py project
(4 cameras, 80x60, 3 pyramid levels), plus the package's import isolation,
CLI surface, scene renderer and between-level upsample."""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from facebook360_dep_tpu.core import camera as jcam
from facebook360_dep_tpu.core import imagetypes
from facebook360_dep_tpu.core import io as jio
from facebook360_dep_tpu.depth import pipeline as jpipe
from facebook360_dep_tpu.render import synthetic as jsyn
from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.depth import pipeline as tpipe
from facebook360_dep_tpu_torch.render import synthetic as tsyn

from torch_parity import port_rig, tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVELS = {0: (80, 60), 1: (56, 42), 2: (40, 30)}
ARGS = ["--min_depth_m", "1.0", "--max_depth_m", "100.0", "--resolution", "80"]


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """tests/test_derp_cli.py's project, written by the JAX package (cv2 PNG16)."""
    root = tmp_path_factory.mktemp("torch_derp_project")
    rig = jsyn.make_test_rig(num_cameras=4, resolution=(80, 60), ring_radius=0.3)
    colors, gt = jsyn.render_sphere_scene(rig, (80, 60), radius=5.0)
    for level, size in LEVELS.items():
        for i, cam_id in enumerate(rig.ids):
            d = imagetypes.image_dir(root, "color_levels", level, cam_id)
            os.makedirs(d, exist_ok=True)
            img = colors[i] if size == (80, 60) else jio.resize_image(colors[i], size)
            jio.write_color(os.path.join(d, "000000.png"), img, bit_depth=16)
    os.makedirs(os.path.join(root, "rigs"), exist_ok=True)
    jcam.save_rig(os.path.join(root, "rigs/rig_calibrated.json"), rig)
    return str(root), rig, gt


def _map(root, level, cam_id):
    return jio.read_pfm(imagetypes.gen_filename(root, "disparity_levels", level, cam_id, "000000", "pfm"))


def test_derp_cli_matches_jax_map_to_map(project):
    """Without random proposals both solves are deterministic. Costs agree to
    ~1e-5 relative, so ping-pong keeps a different one of two near-equal
    candidates on a few percent of pixels, and the bilateral filter spreads
    those by <1%: identical finite sets, median difference at float32 ulps,
    >80% of pixels within 1e-4, every pixel within 3%."""
    from facebook360_dep_tpu.cli import derp_cli as jcli
    from facebook360_dep_tpu_torch.cli import derp_cli as tcli

    root, rig, gt = project
    argv = ["--input_root", root, "--random_proposals", "0"] + ARGS
    jcli.main(argv + ["--output_root", os.path.join(root, "out_jax")])
    est = tcli.main(argv + ["--output_root", os.path.join(root, "out_torch")])
    assert sorted(est.level_seconds) == [0, 1, 2]
    for level in LEVELS:
        for cam_id in rig.ids:
            want, got = _map(os.path.join(root, "out_jax"), level, cam_id), _map(os.path.join(root, "out_torch"), level, cam_id)
            assert got.shape == want.shape == LEVELS[level][::-1]
            assert np.array_equal(np.isfinite(got), np.isfinite(want))
            fin = np.isfinite(want)
            rel = np.abs(got[fin] - want[fin]) / np.abs(want[fin])
            assert np.median(rel) < 1e-6, (level, cam_id, np.median(rel))
            assert (rel < 1e-4).mean() > 0.8, (level, cam_id, (rel < 1e-4).mean())
            assert rel.max() < 0.03, (level, cam_id, rel.max())


def test_derp_cli_default_flags_meets_ground_truth_bar(project):
    """Default flags (2 random proposals from the level-seeded generator):
    the median-relative-error bar of tests/test_derp_cli.py:65, on every camera."""
    from facebook360_dep_tpu_torch.cli import derp_cli as tcli

    root, rig, gt = project
    out = os.path.join(root, "out_torch_default")
    tcli.main(["--input_root", root, "--output_root", out, "--output_formats", "pfm,png"] + ARGS)
    for i, cam_id in enumerate(rig.ids):
        disp = _map(out, 0, cam_id)
        assert os.path.exists(imagetypes.gen_filename(out, "disparity_levels", 0, cam_id, "000000", "png"))
        m = np.zeros(disp.shape, bool)
        m[6:-6, 6:-6] = True
        valid = np.isfinite(disp) & m
        rel = np.abs(disp[valid] - gt[i][valid]) / gt[i][valid]
        assert np.median(rel) < 0.05, (cam_id, np.median(rel))


def _option_defaults(parser):
    return {s: a.default for a in parser._actions for s in a.option_strings if s not in ("-h", "--help")}


def test_parser_accepts_every_jax_option():
    from facebook360_dep_tpu.cli import derp_cli as jcli
    from facebook360_dep_tpu.parallel import multihost
    from facebook360_dep_tpu_torch.cli import derp_cli as tcli

    jp, tp = argparse.ArgumentParser(), argparse.ArgumentParser()
    jcli.add_flags(jp)
    multihost.add_flags(jp)
    tcli.add_flags(tp)
    want, got = _option_defaults(jp), _option_defaults(tp)
    assert set(want) == set(got)
    assert want == got


@pytest.mark.parametrize("flag", ["--use_foreground_masks=true", "--save_debug_images=true", "--profile_dir=x",
                                  "--coordinator_address=localhost:1234"])
def test_unported_options_raise(project, tmp_path, flag):
    from facebook360_dep_tpu_torch.cli import derp_cli as tcli

    root, _, _ = project
    with pytest.raises(NotImplementedError):
        tcli.main(["--input_root", root, "--output_root", str(tmp_path), flag] + ARGS)


def test_package_never_imports_jax():
    """Importing every module of facebook360_dep_tpu_torch leaves JAX unloaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import facebook360_dep_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 15, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'facebook360_dep_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.startswith("ok"), out.stderr


def test_synthetic_scene_matches_jax():
    """The port renders the JAX package's sphere scene (same texture
    vectors). The finest octave's sine arguments reach O(100), where one
    float32 ulp is ~1e-5, so colors agree to 1e-5."""
    jrig = jsyn.make_test_rig(num_cameras=3, resolution=(40, 30), ring_radius=0.3)
    trig = tsyn.make_test_rig(num_cameras=3, resolution=(40, 30), ring_radius=0.3)
    for name in jcam.Camera._fields:
        np.testing.assert_array_equal(np.asarray(getattr(trig.cameras, name)), np.asarray(getattr(jrig.cameras, name)))
    jc, jd = jsyn.render_sphere_scene(jrig, (40, 30), radius=5.0)
    tc, td = tsyn.render_sphere_scene(trig, (40, 30), radius=5.0)
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-5)
    np.testing.assert_allclose(td.numpy(), jd, rtol=2e-6)


def test_fov_masks_and_upsample_init_match_jax():
    rig = jcam.normalize_rig(jsyn.make_ftheta_ring_rig(num_cameras=3, resolution=(40, 30)))
    np.testing.assert_array_equal(tpipe.generate_fov_masks(port_rig(tcam, rig), (30, 40)).numpy(),
                                  np.asarray(jpipe.generate_fov_masks(rig, (30, 40))))
    disp = (np.random.RandomState(0).rand(21, 28) * 0.3 + 0.1).astype(np.float32)
    disp[3:5, 4:9] = np.nan
    want = jpipe.upsample_disparity_init(disp, (40, 30))
    got = tpipe.upsample_disparity_init(tt(disp), (40, 30)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-7)
    assert torch.isfinite(torch.from_numpy(got)).all()
