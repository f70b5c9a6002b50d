"""The port's background-constrained solve (facebook360_dep_tpu_torch/depth)
against the JAX package's: the solver's foreground branches, the
foreground upsample with OpenCV's chamfer labels, and derp_cli with
--use_foreground_masks, the debug images, plotMatches and --profile_dir.

The scene is the sphere rig of the other solver tests; inside a disk of
each camera's image the sphere is the foreground, and the background
disparity elsewhere is 0.8 of the sphere's (farther away), so the solve's
``bg < d`` constraint holds where the truth lies."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from facebook360_dep_tpu.core import camera as jcam
from facebook360_dep_tpu.core import imagetypes
from facebook360_dep_tpu.core import io as jio
from facebook360_dep_tpu.depth import pipeline as jpipe
from facebook360_dep_tpu.depth import solver as js
from facebook360_dep_tpu.render import synthetic as jsyn
from facebook360_dep_tpu_torch.core import camera as tcam
from facebook360_dep_tpu_torch.core import io as tio
from facebook360_dep_tpu_torch.core import png
from facebook360_dep_tpu_torch.depth import pipeline as tpipe
from facebook360_dep_tpu_torch.depth import solver as ts

from torch_parity import f32, port_rig, rel_err, ring_rig, tt

H, W = 36, 48


def _disk_masks(n, h, w, seed=0):
    """One disk per camera, at a seeded center, covering ~30% of the image."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for _ in range(n):
        cy, cx = rng.uniform(0.35, 0.65) * h, rng.uniform(0.35, 0.65) * w
        out.append((yy - cy) ** 2 + (xx - cx) ** 2 < (0.3 * min(h, w)) ** 2)
    return np.stack(out)


@pytest.fixture(scope="module")
def contexts():
    rig = jcam.normalize_rig(ring_rig(jcam, "", n=4, resolution=(W, H), ring_radius=0.3, mixed=True))
    colors, gt = jsyn.render_sphere_scene(rig, (W, H), radius=5.0)
    colors = f32(colors)
    fg = _disk_masks(4, H, W)
    bg = f32(np.nan_to_num(gt, nan=1e-4) * 0.8)
    trig = port_rig(tcam, rig)
    jctx = js.make_level_context(rig, rig, colors, jpipe.generate_fov_masks(rig, (H, W)), dst_fg_masks=fg,
                                 dst_bg_disp=bg, full_height=60)
    tctx = ts.make_level_context(trig, trig, tt(colors), tpipe.generate_fov_masks(trig, (H, W)),
                                 dst_fg_masks=tt(fg), dst_bg_disp=tt(bg), full_height=60)
    init = f32(np.nan_to_num(gt, nan=1e-4) * (1.0 + 0.04 * np.random.RandomState(0).randn(4, H, W)))
    init = np.where(fg, init, bg)
    return jctx, tctx, init, fg, bg


def _cfgs(**kw):
    kw = dict(dict(min_depth=1.0, max_depth=100.0, level=1, num_levels=3, has_fg_masks=True), **kw)
    return js.SolverConfig(**kw), ts.SolverConfig(**kw)


def _threefry_uniforms(key, d, p):
    out = []
    for k in jax.random.split(key, d):
        out.append([np.asarray(jax.random.uniform(kk, (H, W), jnp.float32)) for kk in jax.random.split(k, p)])
    return f32(out)


def test_process_level_with_foreground_masks(contexts):
    """The solver's foreground branches (solver.py:179-200, 225-248, 275,
    314-326 of the port) with the JAX package's threefry draws injected:
    identical NaN sets, background pixels equal to the background map, and
    the foreground within the tolerance of the unmasked parity test
    (tests/test_torch_solver.py: median relative difference < 1e-6, 95% of
    pixels within 1e-3)."""
    jctx, tctx, init, fg, bg = contexts
    jc, tc = _cfgs(num_random_proposals=2)
    key = jax.random.PRNGKey(3)
    j = jax.tree.map(np.asarray, js.process_level(jctx, jc, init_disparity=jnp.asarray(init), key=key))
    t = {k: v.numpy() for k, v in ts.process_level(
        tctx, tc, init_disparity=tt(init), uniforms=tt(_threefry_uniforms(key, 4, 2))).items()}
    assert np.array_equal(np.isnan(t["disparity"]), np.isnan(j["disparity"]))
    fov = np.asarray(jctx.dst_fov_masks)
    back = fov & ~fg
    assert back.any() and np.array_equal(t["disparity"][back], bg[back])
    np.testing.assert_array_equal(t["disparity"][back], j["disparity"][back])
    front = fov & fg
    r = rel_err(t["disparity"][front], j["disparity"][front])
    assert np.median(r) < 1e-6 and (r < 1e-3).mean() > 0.95, (np.median(r), (r < 1e-3).mean())
    # the foreground solve stays in front of the background
    assert (j["disparity"][front] >= bg[front]).mean() > 0.99


def test_brute_force_with_foreground_masks(contexts):
    """The coarsest level's sweep keeps only hypotheses in front of the
    background and puts the background outside the mask (cost.py:215-225)."""
    jctx, tctx, _, fg, bg = contexts
    jc, tc = _cfgs(level=2)
    j_d, j_c, _ = map(np.asarray, js.brute_force_all(jctx, jc))
    t_d, t_c, _ = (x.numpy() for x in ts.brute_force_all(tctx, tc))
    assert np.array_equal(np.isnan(t_d), np.isnan(j_d))
    assert np.array_equal(np.isnan(t_c), np.isnan(j_c))
    assert ((t_d == j_d) | np.isnan(j_d)).mean() > 0.98
    fov = np.asarray(jctx.dst_fov_masks)
    np.testing.assert_array_equal(t_d[fov & ~fg], bg[fov & ~fg])


def _random_valid(rng, h, w, kind):
    if kind == "blobs":
        yy, xx = np.mgrid[0:h, 0:w]
        valid = np.zeros((h, w), bool)
        for _ in range(3):
            cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(2, 8)
            valid |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        return valid
    return rng.rand(h, w) < {"sparse": 0.03, "half": 0.5, "dense": 0.95}[kind]


@pytest.mark.parametrize("kind", ["sparse", "half", "dense", "blobs"])
def test_nearest_valid_index_matches_opencv_labels(kind):
    """The port's plain chamfer (two raster passes of OpenCV's 5x5 L2 mask,
    first of equal candidates kept), through pipeline._nearest_valid_index,
    against cv2.distanceTransformWithLabels through the JAX function:
    identical nearest pixels (0 differ) and identical distances, on several
    masks of several sizes."""
    rng = np.random.RandomState(len(kind))
    for h, w in ((37, 53), (60, 80), (5, 9)):
        valid = _random_valid(rng, h, w, kind)
        valid[rng.randint(h), rng.randint(w)] = True
        j_dist, (j_y, j_x) = jpipe._nearest_valid_index(valid)
        t_dist, (t_y, t_x) = tpipe._nearest_valid_index(valid)
        assert np.array_equal(t_y, j_y) and np.array_equal(t_x, j_x), (kind, h, w)
        np.testing.assert_array_equal(t_dist, j_dist)
    # a stack is labelled image by image
    stack = np.stack([_random_valid(rng, 30, 40, kind) | (np.arange(1200).reshape(30, 40) == 7) for _ in range(3)])
    _, (sy, sx) = tpipe._nearest_valid_index(stack)
    for i in range(3):
        _, (j_y, j_x) = jpipe._nearest_valid_index(stack[i])
        assert np.array_equal(sy[i], j_y) and np.array_equal(sx[i], j_x)


@pytest.mark.parametrize("src_hw,dst_wh", [((21, 28), (40, 30)), ((30, 40), (80, 60)), ((42, 56), (80, 60))])
def test_upsample_disparity_fg_matches_jax(src_hw, dst_wh):
    """Every output value is copied (disparity, nearest fill or background),
    so the maps are identical, NaN positions included; a stack of maps
    gives each map's result."""
    rng = np.random.RandomState(src_hw[0])
    h, w = src_hw
    disp = f32(rng.rand(h, w) * 0.3 + 0.1)
    disp[rng.rand(h, w) < 0.05] = np.nan
    mask = _random_valid(rng, h, w, "blobs") | (rng.rand(h, w) < 0.2)
    mask_up = jio.resize_image(mask.astype(np.uint8), dst_wh, "nearest") > 0
    mask_up ^= rng.rand(dst_wh[1], dst_wh[0]) < 0.05  # masks of two levels disagree at edges
    bg = f32(rng.rand(dst_wh[1], dst_wh[0]) * 0.1)
    bg[:2, :3] = np.nan
    want = jpipe.upsample_disparity_fg(disp, mask, mask_up, bg, dst_wh)
    got = tpipe.upsample_disparity_fg(disp, mask, mask_up, bg, dst_wh)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    both = tpipe.upsample_disparity_fg(np.stack([disp, disp[::-1]]), np.stack([mask, mask[::-1]]),
                                       np.stack([mask_up, mask_up]), np.stack([bg, bg]), dst_wh)
    np.testing.assert_array_equal(both[0], want)
    np.testing.assert_array_equal(both[1], jpipe.upsample_disparity_fg(disp[::-1], mask[::-1], mask_up, bg, dst_wh))


# ---- derp_cli end to end -----------------------------------------------------

LEVELS = {0: (80, 60), 1: (56, 42), 2: (40, 30)}
ARGS = ["--min_depth_m", "1.0", "--max_depth_m", "100.0", "--resolution", "80", "--random_proposals", "0"]


@pytest.fixture(scope="module")
def fg_project(tmp_path_factory):
    """tests/test_torch_derp_cli.py's project (4 cameras, 80x60, 3 levels)
    plus foreground masks and a background solve at every level, written by
    the JAX package."""
    root = str(tmp_path_factory.mktemp("torch_fg_project"))
    rig = jsyn.make_test_rig(num_cameras=4, resolution=(80, 60), ring_radius=0.3)
    colors, gt = jsyn.render_sphere_scene(rig, (80, 60), radius=5.0)
    masks0 = _disk_masks(4, 60, 80, seed=1)
    for level, size in LEVELS.items():
        for i, cam_id in enumerate(rig.ids):
            full = size == (80, 60)
            img = colors[i] if full else jio.resize_image(colors[i], size)
            d = imagetypes.image_dir(root, "color_levels", level, cam_id)
            os.makedirs(d, exist_ok=True)
            jio.write_color(os.path.join(d, "000000.png"), img, bit_depth=16)
            m = masks0[i].astype(np.float32)
            m = m if full else (jio.resize_image(m, size) > 0.5).astype(np.float32)
            d = imagetypes.image_dir(root, "foreground_masks_levels", level, cam_id)
            os.makedirs(d, exist_ok=True)
            jio.write_color(os.path.join(d, "000000.png"), np.repeat(m[..., None], 3, -1), bit_depth=16)
            g = np.nan_to_num(gt[i], nan=1e-4) if full else jio.resize_image(np.nan_to_num(gt[i], nan=1e-4), size)
            d = imagetypes.image_dir(root, "background_disp_levels", level, cam_id)
            os.makedirs(d, exist_ok=True)
            jio.write_pfm(os.path.join(d, "000000.pfm"), f32(g * 0.8))
    os.makedirs(os.path.join(root, "rigs"), exist_ok=True)
    jcam.save_rig(os.path.join(root, "rigs/rig_calibrated.json"), rig)
    return root, rig, gt


def _map(root, level, cam_id):
    return jio.read_pfm(imagetypes.gen_filename(root, "disparity_levels", level, cam_id, "000000", "pfm"))


def test_derp_cli_with_foreground_masks_matches_jax(fg_project):
    """derp_cli --use_foreground_masks of both packages on the same project
    (the masks are read as PNG16 RGB, the background from
    background/disparity_levels): identical finite sets and background
    pixels; in the foreground the median and 1e-4 bars of the unmasked
    map-to-map test (tests/test_torch_derp_cli.py: median < 1e-6, 80% of
    pixels within 1e-4). Near the mask's edge a ping-pong near-tie can take
    the other candidate, which the bilateral filter spreads: under 2% of a
    map's foreground beyond 1e-2, every pixel within 5% (measured: 4 of
    496 pixels beyond 1e-2 in one map, at most 3.3%)."""
    from facebook360_dep_tpu.cli import derp_cli as jcli
    from facebook360_dep_tpu_torch.cli import derp_cli as tcli

    root, rig, gt = fg_project
    argv = ["--input_root", root, "--use_foreground_masks", "true"] + ARGS
    jcli.main(argv + ["--output_root", os.path.join(root, "out_jax")])
    tcli.main(argv + ["--output_root", os.path.join(root, "out_torch")], device="cpu")
    for level in LEVELS:
        for i, cam_id in enumerate(rig.ids):
            want = _map(os.path.join(root, "out_jax"), level, cam_id)
            got = _map(os.path.join(root, "out_torch"), level, cam_id)
            assert got.shape == want.shape == LEVELS[level][::-1]
            assert np.array_equal(np.isfinite(got), np.isfinite(want))
            mask_path = imagetypes.gen_filename(root, "foreground_masks_levels", level, cam_id, "000000", "png")
            fg = tio.read_mask(mask_path)
            assert np.array_equal(fg, jio.read_mask(mask_path))
            bgd = jio.read_pfm(imagetypes.gen_filename(root, "background_disp_levels", level, cam_id, "000000", "pfm"))
            back = np.isfinite(want) & ~fg
            np.testing.assert_array_equal(got[back], want[back])
            np.testing.assert_array_equal(got[back], bgd[back])
            front = np.isfinite(want) & fg
            rel = np.abs(got[front] - want[front]) / np.abs(want[front])
            assert np.median(rel) < 1e-6, (level, cam_id, np.median(rel))
            assert (rel < 1e-4).mean() > 0.8, (level, cam_id, (rel < 1e-4).mean())
            assert (rel > 1e-2).mean() < 0.02 and rel.max() < 0.05, (level, cam_id, rel.max())
    # the foreground solve found the sphere inside the masks at level 0
    masks0 = _disk_masks(4, 60, 80, seed=1)
    for i, cam_id in enumerate(rig.ids):
        got = _map(os.path.join(root, "out_torch"), 0, cam_id)
        m = masks0[i] & np.isfinite(got)
        m[:6] = m[-6:] = False
        assert np.median(np.abs(got[m] - gt[i][m]) / gt[i][m]) < 0.05


def _decoded(path):
    with open(path, "rb") as f:
        return png.decode(f.read())


def test_debug_images_and_plot_matches_match_jax(fg_project, tmp_path):
    """save_debug_images and plot_matches of both packages on the same
    result maps: the same file names (plotMatches' ``->``/``x=``/``y=``
    parts included), each decoding to the same bytes (the JAX package
    writes BGR(A) through OpenCV, which stores RGB(A))."""
    root, rig, _ = fg_project
    opts = dict(input_root=root, min_depth_m=1.0, max_depth_m=100.0, resolution=80, debug_plot_match_dst="cam1",
                debug_plot_match_x=40, debug_plot_match_y=30, debug_plot_match_level=0)
    jest = jpipe.DepthEstimator(jpipe.DepthEstimatorOptions(
        output_root=str(tmp_path / "jax"), debug_dir=str(tmp_path / "jax_plot"), **opts))
    test = tpipe.DepthEstimator(tpipe.DepthEstimatorOptions(
        output_root=str(tmp_path / "torch"), debug_dir=str(tmp_path / "torch_plot"), **opts), device="cpu")
    rng = np.random.RandomState(4)
    shape = (4, 60, 80)
    disp = f32(rng.rand(*shape) * 0.3 + 0.1)
    disp[:, :3, :5] = np.nan
    disp[0, 10, 10] = 1.7
    cost = f32(rng.rand(*shape) * 150.0)
    cost[:, 5, :4] = (np.inf, np.nan, -np.inf, 0.0)
    conf = f32(rng.rand(*shape) * 0.02)
    conf[1, 0, :2] = (np.nan, np.inf)
    result = {"disparity": disp, "cost": cost, "confidence": conf, "mismatches": rng.rand(*shape) < 0.1}
    fov = rng.rand(*shape) < 0.9
    colors = f32(rng.rand(4, 60, 80, 3) * 1.1 - 0.05)
    for est in (jest, test):
        est.save_debug_images(0, "000000", result, fov)
        est.plot_matches(0, "000000", result, colors)
    for image_type in ("disparity_levels", "cost", "confidence", "mismatches"):
        for cam_id in rig.ids:
            j = imagetypes.gen_filename(str(tmp_path / "jax"), image_type, 0, cam_id, "000000", "png")
            t = imagetypes.gen_filename(str(tmp_path / "torch"), image_type, 0, cam_id, "000000", "png")
            want, got = _decoded(j), _decoded(t)
            assert got.dtype == want.dtype and np.array_equal(got, want), (image_type, cam_id)
    names = sorted(os.listdir(tmp_path / "jax_plot"))
    assert names and all(n.startswith("processLevel_cam1_x=40_y=30->cam") for n in names), names
    assert sorted(os.listdir(tmp_path / "torch_plot")) == names
    for n in names:
        want, got = _decoded(str(tmp_path / "jax_plot" / n)), _decoded(str(tmp_path / "torch_plot" / n))
        assert got.dtype == np.uint16 and np.array_equal(got, want), n


def test_derp_cli_debug_outputs_and_profile_dir(fg_project, tmp_path):
    """derp_cli with --save_debug_images, plotMatches flags and
    --profile_dir runs in the port: level 1, resumed from a plain run of
    level 2, writes every debug image, one plotMatches PNG per other
    camera, and a chrome trace holding the level's ``derp level 1`` range."""
    from facebook360_dep_tpu_torch.cli import derp_cli as tcli

    root, rig, _ = fg_project
    out, prof, plots = str(tmp_path / "out"), str(tmp_path / "prof"), str(tmp_path / "plots")
    tcli.main(["--input_root", root, "--output_root", out, "--level_end", "2"] + ARGS, device="cpu")
    tcli.main(["--input_root", root, "--output_root", out, "--save_debug_images", "true", "--level_start", "1",
               "--level_end", "1", "--debug_dir", plots, "--debug_plot_match_dst", "cam0",
               "--debug_plot_match_x", "28", "--debug_plot_match_y", "21", "--debug_plot_match_level", "1",
               "--profile_dir", prof] + ARGS, device="cpu")
    for image_type in ("cost", "confidence", "mismatches", "disparity_levels"):
        for cam_id in rig.ids:
            assert os.path.exists(imagetypes.gen_filename(out, image_type, 1, cam_id, "000000", "png"))
    assert len(os.listdir(plots)) == 3
    traces = glob.glob(os.path.join(prof, "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "derp level 1" in names and "derp level 2" not in names
