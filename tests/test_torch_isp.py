"""The port's software ISP (``isp/pipeline.py``) and its two CLIs,
raw_to_rgb and correct_vignetting, against the JAX package's on the CPU.

The JAX package runs its ISP in float32. tests/conftest.py turns JAX's x64
mode on, under which the vignette's float64 ramp lifts the rest of
``process`` to float64, so every JAX call here runs under
``jax.enable_x64(False)``: the JAX package as it runs in production.
Tolerances: 1e-5 for every stage and demosaic but FREQUENCY (1e-4: its DCTs
sum in another order), 1e-6 for the stuck-pixel median and the curves, and
1 LSB for the CLIs' PNGs. The DNG written by raw_to_rgb --dng is
byte-equal.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from facebook360_dep_tpu.cli import correct_vignetting as jcv
from facebook360_dep_tpu.cli import raw_to_rgb as jr2r
from facebook360_dep_tpu.core import io as jio
from facebook360_dep_tpu.core import rawio as jraw
from facebook360_dep_tpu.isp import pipeline as jisp
from facebook360_dep_tpu_torch.cli import correct_vignetting as tcv
from facebook360_dep_tpu_torch.cli import raw_to_rgb as tr2r
from facebook360_dep_tpu_torch.core import io as tio
from facebook360_dep_tpu_torch.core import rawio as traw
from facebook360_dep_tpu_torch.isp import pipeline as tisp

import torch_parity  # noqa: F401  (torch threads)

PATTERNS = ["RGGB", "GRBG", "GBRG", "BGGR"]
TOL = {"BILINEAR": 1e-5, "EDGE_AWARE": 1e-5, "FREQUENCY": 1e-4, "CHROMA_SUPPRESSED": 1e-5}
DEMOSAIC = {"BILINEAR": "demosaic_bilinear", "EDGE_AWARE": "demosaic_edge_aware",
            "FREQUENCY": "demosaic_frequency", "CHROMA_SUPPRESSED": "demosaic_chroma_suppressed"}

# tests/test_rawio_isp.py:96-113's full configuration
FULL = dict(bayer_pattern="RGGB", black_level=(0.02, 0.02, 0.02), white_balance_gain=(1.1, 1.0, 1.2),
            gamma=(0.9, 0.9, 0.9), saturation=1.1, contrast=1.05, sharpening=(0.2, 0.2, 0.2),
            stuck_pixel_radius=1, stuck_pixel_threshold=0.5, demosaic_filter="EDGE_AWARE")


def jx(fn, *args, **kwargs):
    """A JAX package call in float32, as numpy."""
    with jax.enable_x64(False):
        return np.asarray(fn(*args, **kwargs))


def mosaic_input(seed=0, shape=(48, 64)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("mode", list(DEMOSAIC))
def test_demosaic_matches_jax(mode, pattern):
    raw = mosaic_input(PATTERNS.index(pattern))
    want = jx(getattr(jisp, DEMOSAIC[mode]), raw, pattern)
    got = getattr(tisp, DEMOSAIC[mode])(torch.from_numpy(raw), pattern)
    assert got.dtype == torch.float32 and got.shape == (48, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[mode])


def test_dct_pair_matches_jax_dctn():
    """The FREQUENCY demosaic's DCT-II and its inverse (torch.fft, Makhoul's
    reordering) against jax.scipy.fft.dctn/idctn, even and odd sizes."""
    import jax.scipy.fft as jfft

    for shape in [(48, 64), (45, 63), (1, 7)]:
        a = mosaic_input(1, shape)
        want = jx(jfft.dctn, a, type=2, norm="ortho")
        got = tisp.dct2(torch.from_numpy(a))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        back = tisp.idct2(got)
        np.testing.assert_allclose(back.numpy(), jx(jfft.idctn, want, type=2, norm="ortho"), rtol=0, atol=1e-5)
        np.testing.assert_allclose(back.numpy(), a, rtol=0, atol=1e-5)


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("darkness", [0.0, 0.3])
def test_remove_stuck_pixels_matches_jax(radius, darkness):
    raw = mosaic_input(radius)
    raw[5, 7] = 1.0  # stuck sensels
    raw[20, 30] = 0.0
    want = jx(jisp.remove_stuck_pixels, raw, "GBRG", radius, 0.2, darkness)
    got = tisp.remove_stuck_pixels(torch.from_numpy(raw), "GBRG", radius, 0.2, darkness).numpy()
    assert (want != raw).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_stuck_pixel_median_of_an_even_count_is_the_midpoint():
    """8 same-color neighbors at r = 1: jnp.median averages the two middle
    values (torch.median would return the lower one)."""
    raw = np.full((12, 12), 0.5, np.float32)
    neighbors = [(4, 4), (4, 6), (4, 8), (6, 4), (6, 8), (8, 4), (8, 6), (8, 8)]
    for k, (y, x) in enumerate(neighbors):
        raw[y, x] = 0.1 * (k + 1)  # middle values 0.4 and 0.5
    raw[6, 6] = 0.95
    want = jx(jisp.remove_stuck_pixels, raw, "RGGB", 1, 0.3)
    got = tisp.remove_stuck_pixels(torch.from_numpy(raw), "RGGB", 1, 0.3).numpy()
    assert want[6, 6] == pytest.approx(0.45, abs=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert torch.from_numpy(raw[4:9:2, 4:9:2].ravel()[[0, 1, 2, 3, 5, 6, 7, 8]]).median() != got[6, 6]


def test_companding_matches_jax_at_and_between_breakpoints():
    lut = [(0.0, 0.0), (0.25, 0.5), (0.5, 0.7), (0.5, 0.75), (1.0, 1.0)]
    x = np.concatenate([np.asarray([-0.2, 0.0, 0.25, 0.5, 1.0, 1.3], np.float32),
                        np.linspace(0, 1, 101, dtype=np.float32)]).reshape(1, -1)
    want = jx(jisp.companding, x, lut)
    got = tisp.companding(torch.from_numpy(x), lut).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    same = tisp.companding(torch.from_numpy(x), [(0, 0), (1, 1)])  # the identity curve is skipped
    assert np.array_equal(same.numpy(), x)


def test_tone_curve_bezier_and_sharpen_match_jax():
    rng = np.random.RandomState(2)
    cfg = dict(gamma=(0.5, 0.8, 1.3), contrast=1.2, low_key_boost=(0.1, 0.0, -0.05),
               high_key_boost=(-0.05, 0.02, 0.0), sharpening=(0.2, 0.5, 0.0), noise_core=200.0)
    rgb = rng.rand(30, 40, 3).astype(np.float32)
    np.testing.assert_allclose(tisp.tone_curve(torch.from_numpy(rgb), tisp.IspConfig(**cfg)).numpy(),
                               jx(jisp.tone_curve, rgb, jisp.IspConfig(**cfg)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tisp.sharpen(torch.from_numpy(rgb), tisp.IspConfig(**cfg)).numpy(),
                               jx(jisp.sharpen, rgb, jisp.IspConfig(**cfg)), rtol=0, atol=1e-5)
    ctrl = rng.rand(4, 3).astype(np.float32)
    t = rng.rand(5, 7).astype(np.float32)
    np.testing.assert_allclose(tisp.bezier(torch.from_numpy(ctrl), torch.from_numpy(t)).numpy(),
                               jx(jisp.bezier, ctrl, t), rtol=0, atol=1e-6)
    rgb_img = rng.rand(8, 8, 3).astype(np.float32)
    for pattern in PATTERNS:
        np.testing.assert_array_equal(tisp.mosaic(rgb_img, pattern).numpy(), jisp.mosaic(rgb_img, pattern))


def test_isp_config_from_json_matches_jax(tmp_path):
    obj = {"CameraIsp": {
        "bitsPerPixel": 12, "width": 64, "height": 48, "bayerPattern": "rggb_x",
        "blackLevel": {"r": 0.01, "g": 0.02, "b": 0.03}, "clampMin": [0.0, 0.01, 0.0],
        "clampMax": [1.0, 0.99, 1.0], "whiteBalanceGain": [1.1, 1.0, 1.3], "gamma": [0.9, 0.9, 0.8],
        "lowKeyBoost": [0.1, 0.0, 0.0], "highKeyBoost": [0.0, 0.1, 0.0], "sharpening": [0.2, 0.2, 0.2],
        "ccm": [[1.2, -0.1, -0.1], [0.0, 1.0, 0.0], [0.0, -0.2, 1.2]],
        "vignetteRollOffH": [{"r": 0.9, "g": 0.9, "b": 0.9}, [1, 1, 1]], "vignetteRollOffV": [[1, 1, 1]],
        "compandingLut": [[0, 0], [0.5, 0.6], [1, 1]], "saturation": 1.2, "contrast": 1.1,
        "sharpeningSupport": 0.01, "noiseCore": 500.0, "stuckPixelThreshold": 0.2,
        "stuckPixelDarknessThreshold": 0.05, "stuckPixelRadius": 2}}
    path = tmp_path / "isp.json"
    path.write_text(json.dumps(obj))
    assert dataclasses.asdict(tisp.IspConfig.from_json(path)) == dataclasses.asdict(jisp.IspConfig.from_json(path))
    path.write_text(json.dumps({}))
    assert dataclasses.asdict(tisp.IspConfig.from_json(path)) == dataclasses.asdict(jisp.IspConfig())


@pytest.mark.parametrize("mode", list(DEMOSAIC))
def test_process_full_config_matches_jax(mode):
    rgb = np.random.RandomState(3).rand(24, 24, 3).astype(np.float32) * 0.5 + 0.25
    raw = jisp.mosaic(rgb, "RGGB")
    extra = dict(vignette_roll_off_h=[(0.8, 0.8, 0.8), (1, 1, 1), (0.8, 0.8, 0.8)],
                 companding_lut=[(0.0, 0.0), (0.5, 0.6), (1.0, 1.0)], ccm=((1.1, -0.1, 0.0), (0, 1, 0), (0, -0.1, 1.1)),
                 low_key_boost=(0.05, 0.0, 0.0))
    for cfg in (dict(FULL, demosaic_filter=mode), dict(FULL, demosaic_filter=mode, **extra),
                dict(FULL, demosaic_filter=mode, apply_tone_curve=False)):
        want = jx(jisp.process, raw, jisp.IspConfig(**cfg))
        got = tisp.process(torch.from_numpy(raw), tisp.IspConfig(**cfg))
        assert got.dtype == torch.float32 and got.shape == (24, 24, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[mode])


def _raw_tree(tmp_path, pattern="GBRG", bpp=16, shape=(32, 48)):
    rgb = np.random.RandomState(4).rand(*shape, 3).astype(np.float32)
    h, w = shape
    raw = jisp.mosaic(rgb, pattern)
    (tmp_path / "in").mkdir()
    for name in ("a", "b"):
        jraw.write_raw(str(tmp_path / "in" / f"{name}.raw"), np.roll(raw, len(name), 1), bpp)
    cfg = {"CameraIsp": {"bitsPerPixel": bpp, "width": w, "height": h, "bayerPattern": pattern,
                         "whiteBalanceGain": [1.2, 1.0, 1.1], "gamma": [0.8, 0.8, 0.8]}}
    (tmp_path / "isp.json").write_text(json.dumps(cfg))
    return raw


@pytest.mark.parametrize("flags", [[], ["--demosaic_filter", "EDGE_AWARE", "--output_bpp", "16"],
                                   ["--demosaic_filter", "FREQUENCY", "--apply_tone_curve", "false"],
                                   ["--black_level_offset", "0.01", "--resize", "2"]])
def test_raw_to_rgb_cli_matches_jax(tmp_path, flags):
    _raw_tree(tmp_path)
    common = ["--input_image_path", str(tmp_path / "in" / "a.raw"), "--isp_config_path", str(tmp_path / "isp.json")]
    with jax.enable_x64(False):
        jr2r.main(common + ["--output_image_path", str(tmp_path / "j.png"), *flags])
    tr2r.main(common + ["--output_image_path", str(tmp_path / "t.png"), *flags], device="cpu")
    want, got = tio.read_png(str(tmp_path / "j.png")), tio.read_png(str(tmp_path / "t.png"))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1


def test_raw_to_rgb_cli_dng_and_directory_match_jax(tmp_path):
    raw = _raw_tree(tmp_path)
    common = ["--input_image_path", str(tmp_path / "in"), "--isp_config_path", str(tmp_path / "isp.json")]
    jr2r.main(common + ["--output_image_path", str(tmp_path / "jd"), "--dng"])
    tr2r.main(common + ["--output_image_path", str(tmp_path / "td"), "--dng"], device="cpu")
    for name in ("a", "b"):
        assert (tmp_path / "jd" / f"{name}.dng").read_bytes() == (tmp_path / "td" / f"{name}.dng").read_bytes()
    back, _ = traw.read_dng(str(tmp_path / "td" / "a.dng"))
    assert np.abs(back - np.roll(raw, 1, 1)).max() <= 2.0 / 65535
    with jax.enable_x64(False):
        jr2r.main(common + ["--output_image_path", str(tmp_path / "jp")])
    tr2r.main(common + ["--output_image_path", str(tmp_path / "tp")], device="cpu")
    for name in ("a", "b"):
        want, got = tio.read_png(str(tmp_path / "jp" / f"{name}.png")), tio.read_png(str(tmp_path / "tp" / f"{name}.png"))
        assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1


def test_raw_to_rgb_reads_a_png_mosaic_and_needs_raw_dims(tmp_path):
    raw = jisp.mosaic(np.random.RandomState(6).rand(16, 20, 3).astype(np.float32), "GBRG")
    tio.write_color(str(tmp_path / "m.png"), np.repeat(raw[..., None], 3, -1), bit_depth=16)
    (tmp_path / "isp.json").write_text(json.dumps({"CameraIsp": {}}))
    argv = ["--input_image_path", str(tmp_path / "m.png"), "--isp_config_path", str(tmp_path / "isp.json")]
    with jax.enable_x64(False):
        jr2r.main(argv + ["--output_image_path", str(tmp_path / "j.png")])
    tr2r.main(argv + ["--output_image_path", str(tmp_path / "t.png")], device="cpu")
    assert np.abs(tio.read_png(str(tmp_path / "t.png")).astype(int) - tio.read_png(str(tmp_path / "j.png")).astype(int)).max() <= 1
    jraw.write_raw(str(tmp_path / "x.raw"), raw, 8)
    with pytest.raises(ValueError, match="width/height"):
        tr2r.main(["--input_image_path", str(tmp_path / "x.raw"), "--isp_config_path", str(tmp_path / "isp.json"),
                   "--output_image_path", str(tmp_path / "x.png")], device="cpu")


@pytest.mark.parametrize("principal", [None, (20.0, 14.0)])
def test_correct_vignetting_matches_jax(tmp_path, principal):
    rng = np.random.RandomState(7)
    img = (rng.rand(32, 48, 3) * 0.6 + 0.2).astype(np.float32)
    vx, vy = [0.6, 1.0, 1.0, 0.6], [0.7, 1.0, 0.95, 0.7]
    want = jx(jcv.correct_vignetting, img, vx, vy, principal)
    got = tcv.correct_vignetting(torch.from_numpy(img), vx, vy, principal)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    gray = img[..., 0]
    np.testing.assert_allclose(tcv.correct_vignetting(torch.from_numpy(gray), vx, vy, principal).numpy(),
                               jx(jcv.correct_vignetting, gray, vx, vy, principal), rtol=0, atol=1e-5)
    jio.write_color(str(tmp_path / "in.png"), img)
    argv = ["--raw", str(tmp_path / "in.png"), "--vignetting_x", ",".join(map(str, vx)),
            "--vignetting_y", ",".join(map(str, vy))]
    if principal:
        argv += ["--principal_x", str(principal[0]), "--principal_y", str(principal[1])]
    with jax.enable_x64(False):
        jcv.main(argv + ["--out", str(tmp_path / "j.png")])
    tcv.main(argv + ["--out", str(tmp_path / "t.png")], device="cpu")
    want_png, got_png = tio.read_png(str(tmp_path / "j.png")), tio.read_png(str(tmp_path / "t.png"))
    assert np.abs(got_png.astype(np.int64) - want_png.astype(np.int64)).max() <= 1
