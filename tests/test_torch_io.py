"""The port's host IO (facebook360_dep_tpu_torch/core/io.py, png.py) against
the JAX package's io and OpenCV, and its Lanczos4 resize against cv2."""

import os

import cv2
import numpy as np
import pytest
import torch

from facebook360_dep_tpu.core import exr as jexr
from facebook360_dep_tpu.core import io as jio
from facebook360_dep_tpu_torch.core import exr, imagetypes, io, png
from facebook360_dep_tpu_torch.ops import sampling

import torch_parity  # noqa: F401  (thread count)


def _image(dtype, channels, seed=0, h=37, w=53):
    """Smooth gradients plus noise, so libpng picks every row filter type."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (np.sin(x / 5.0 + y / 7.0) * 0.5 + 0.5)[..., None] * np.ones(channels)
    top = np.iinfo(dtype).max
    img = base * top * 0.9 + rng.rand(h, w, channels) * top * 0.05
    return img.astype(dtype)


def _bgr(img):
    c = img.shape[-1]
    return img[..., 0] if c == 1 else img[..., [2, 1, 0] + ([3] if c == 4 else [])]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_codec_against_cv2(tmp_path, dtype, channels):
    """The decoder reads libpng's adaptively filtered files exactly; cv2 reads
    the encoder's files exactly (gray+alpha is checked by round trip)."""
    img = _image(dtype, channels, seed=channels)
    p = str(tmp_path / "a.png")
    if channels != 2:
        cv2.imwrite(p, _bgr(img))
        assert np.array_equal(io.read_png(p), img)
    io.write_png(p, img)
    assert np.array_equal(png.decode(open(p, "rb").read()), img)
    if channels != 2:
        back = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        assert np.array_equal(back, _bgr(img))
    assert io.image_size(p) == (img.shape[1], img.shape[0])


def test_png_unsupported_kinds_raise():
    import struct

    for depth, ctype, interlace in ((8, 3, 0), (1, 0, 0), (8, 2, 1)):  # palette, 1-bit, interlaced
        ihdr = struct.pack(">IIBBBBB", 2, 2, depth, ctype, 0, 0, interlace)
        data = png._SIGNATURE + png._chunk(b"IHDR", ihdr) + png._chunk(b"IEND", b"")
        with pytest.raises(NotImplementedError):
            png.decode(data)
    with pytest.raises(TypeError):
        png.encode(np.zeros((4, 4), np.float32))


def test_pfm_byte_identical(tmp_path):
    rng = np.random.RandomState(1)
    m = rng.rand(13, 17).astype(np.float32)
    m[2, 3] = np.nan
    io.write_pfm(tmp_path / "t.pfm", m)
    jio.write_pfm(tmp_path / "j.pfm", m)
    assert (tmp_path / "t.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()
    np.testing.assert_array_equal(io.read_pfm(tmp_path / "j.pfm"), jio.read_pfm(tmp_path / "j.pfm"))
    assert io.image_size(tmp_path / "t.pfm") == (17, 13)


def test_disparity_png_and_color_match_jax_io(tmp_path):
    rng = np.random.RandomState(2)
    d = (rng.rand(11, 19) * 1.2 - 0.1).astype(np.float32)
    d[0, 0] = np.nan
    io.write_disparity(str(tmp_path / "t.png"), d)
    jio.write_disparity(str(tmp_path / "j.png"), d)
    np.testing.assert_array_equal(io.read_disparity(str(tmp_path / "t.png")), jio.read_disparity(str(tmp_path / "j.png")))
    np.testing.assert_array_equal(io.read_disparity(str(tmp_path / "j.png")), jio.read_disparity(str(tmp_path / "t.png")))
    for bits in (8, 16):
        c = rng.rand(9, 14, 3).astype(np.float32)
        io.write_color(str(tmp_path / f"t{bits}.png"), c, bit_depth=bits)
        jio.write_color(str(tmp_path / f"j{bits}.png"), c, bit_depth=bits)
        np.testing.assert_array_equal(io.read_color(str(tmp_path / f"j{bits}.png")), jio.read_color(str(tmp_path / f"j{bits}.png")))
        np.testing.assert_array_equal(io.read_color(str(tmp_path / f"t{bits}.png")), jio.read_color(str(tmp_path / f"t{bits}.png")))
    gray = (rng.rand(5, 6) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "g.png"), gray)
    np.testing.assert_array_equal(io.read_color(str(tmp_path / "g.png")), jio.read_color(str(tmp_path / "g.png")))


def test_exr_not_ported(tmp_path):
    """EXR disparity IO is ported with PIZ compression (the native codec): a
    .exr map round-trips, and a PIZ map written by either package reads
    back equal in the other (tests/test_torch_exr.py holds the codec against
    the JAX package's)."""
    d = np.arange(6, dtype=np.float32).reshape(2, 3)
    io.write_disparity(str(tmp_path / "d.exr"), d)
    np.testing.assert_array_equal(io.read_disparity(str(tmp_path / "d.exr")), d)
    rng = np.random.RandomState(4)
    m = (rng.rand(45, 37) * 2).astype(np.float32)
    m[3, 4] = np.nan
    exr.write_exr(str(tmp_path / "p.exr"), m, compression="piz")
    np.testing.assert_array_equal(jio.read_disparity(str(tmp_path / "p.exr")), m)
    jexr.write_exr(str(tmp_path / "j.exr"), m, compression="piz")
    np.testing.assert_array_equal(io.read_disparity(str(tmp_path / "j.exr")), m)


@pytest.mark.parametrize("ext,dtype,channels", [(".jpg", np.uint8, 3), (".jpeg", np.uint8, 1),
                                                (".tif", np.uint16, 3), (".tiff", np.uint8, 4),
                                                (".tif", np.uint16, 1), (".TIF", np.uint8, 3)])
def test_jpeg_and_tiff_read_as_jax_reads_them(tmp_path, ext, dtype, channels):
    """read_color and image_size of JPEG and TIFF (through OpenCV) give the
    JAX io's arrays and sizes exactly."""
    img = _image(dtype, channels, seed=channels)
    p = str(tmp_path / f"a{ext}")
    assert cv2.imwrite(p, _bgr(img))
    got = io.read_color(p)
    assert got.dtype == np.float32 and got.shape == img.shape[:2] + (max(channels, 3),)
    np.testing.assert_array_equal(got, jio.read_color(p))
    assert io.image_size(p) == jio.image_size(p) == (img.shape[1], img.shape[0])


def test_jpeg_tree_level_sizes_and_missing_cv2(tmp_path, monkeypatch):
    """get_pyramid_level_sizes on a JPEG tree; where OpenCV is missing the
    JPEG branch raises naming the format, and PNG needs no OpenCV."""
    for level, (w, h) in {0: (48, 36), 1: (24, 18)}.items():
        d = imagetypes.image_dir(tmp_path, "color_levels", level, "cam0")
        os.makedirs(d)
        cv2.imwrite(os.path.join(d, "000000.jpg"), np.full((h, w, 3), 128, np.uint8))
    root = imagetypes.image_dir(tmp_path, "color_levels")
    assert io.get_pyramid_level_sizes(root) == jio.get_pyramid_level_sizes(root) == {0: (48, 36), 1: (24, 18)}
    io.write_color(str(tmp_path / "a.png"), np.zeros((4, 5, 3), np.float32))
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    with pytest.raises(RuntimeError, match=r"reading \.jpg images needs OpenCV"):
        io.read_color(os.path.join(root, "level_0", "cam0", "000000.jpg"))
    with pytest.raises(RuntimeError, match=r"\.jpg"):
        io.get_pyramid_level_sizes(root)
    assert io.read_color(str(tmp_path / "a.png")).shape == (4, 5, 3)
    with pytest.raises(NotImplementedError, match="PNG, JPEG or TIFF"):
        io.read_color(str(tmp_path / "a.bmp"))


def test_pyramid_level_sizes_and_first_image(tmp_path):
    for level, (w, h) in {0: (40, 30), 1: (20, 15)}.items():
        d = imagetypes.image_dir(tmp_path, "color_levels", level, "cam0")
        os.makedirs(d)
        io.write_color(os.path.join(d, "000000.png"), np.zeros((h, w, 3), np.float32))
        open(os.path.join(d, ".hidden.png"), "w").close()
    root = imagetypes.image_dir(tmp_path, "color_levels")
    assert io.get_pyramid_level_sizes(root) == jio.get_pyramid_level_sizes(root) == {0: (40, 30), 1: (20, 15)}
    d0 = imagetypes.image_dir(tmp_path, "color_levels", 0, "cam0")
    assert io.first_image_in(d0) == jio.first_image_in(d0)
    assert io.first_image_in(tmp_path / "missing") is None


@pytest.mark.parametrize("src_hw,dst_wh", [((30, 40), (56, 42)), ((42, 56), (80, 60)), ((38, 50), (60, 45)),
                                           ((60, 80), (40, 30)), ((5, 7), (13, 9))])
def test_lanczos4_resize_matches_cv2(src_hw, dst_wh):
    """cv2 sums the 8 taps in float32 with SIMD/FMA in places; values are
    O(0.1-1), so 5e-7 absolute is a few ulps."""
    d = (np.random.RandomState(3).rand(*src_hw) * 0.3 + 0.1).astype(np.float32)
    want = cv2.resize(d, dst_wh, interpolation=cv2.INTER_LANCZOS4)
    got = sampling.resize_lanczos4(torch.from_numpy(d), dst_wh).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-7, rtol=0)


@pytest.mark.parametrize("src_hw,dst_wh,channels", [((60, 80), (40, 30), 3), ((48, 64), (16, 12), 3),
                                                    ((36, 48), (48, 12), 1), ((30, 40), (40, 30), 0)])
def test_resize_image_area_integer_factors_matches_jax(src_hw, dst_wh, channels):
    """INTER_AREA by integer factors is a box mean, summed in cv2's order
    (four at a time; 2x2 boxes of one or four channels in its SIMD order):
    identical to cv2."""
    shape = src_hw + ((channels,) if channels else ())
    img = np.random.RandomState(channels).rand(*shape).astype(np.float32)
    want = jio.resize_image(img, dst_wh)
    got = io.resize_image(img, dst_wh)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size_wh,mode,dtype", [((40, 30), "cubic", np.float32), ((40, 30), "linear", np.float32),
                                                ((160, 120), "area", np.float32), ((40, 30), "area", np.uint8),
                                                ((40, 30), "lanczos", np.uint16)])
def test_resize_image_other_cases_raise(size_wh, mode, dtype):
    img = np.zeros((60, 80, 3), dtype)
    with pytest.raises(NotImplementedError, match=f"{mode!r}.*80x60 to {size_wh[0]}x{size_wh[1]}"):
        io.resize_image(img, size_wh, mode)


def _pyramid_sizes(w0, h0):
    """cli/resize_images.level_sizes of a (w0, h0) frame at the ten reference widths scaled by w0 / 2048."""
    sizes = []
    for w in imagetypes.PYRAMID_WIDTHS:
        w = w * w0 // 2048
        h = int(round(h0 * w / w0))
        sizes.append((w, h + h % 2))
    return sizes


@pytest.mark.parametrize("size_wh", _pyramid_sizes(410, 308) + [(30, 20)])
@pytest.mark.parametrize("channels", [0, 3])
def test_resize_image_area_matches_cv2(size_wh, channels):
    """INTER_AREA at the ten pyramid sizes of a reduced 410x308 frame
    (factors 1, 2 and eight non-integer ones: 410 -> 40 is 10.25) and
    60x40 -> 30x20: cv2's area tables and summation order, identical."""
    w0, h0 = (60, 40) if size_wh == (30, 20) else (410, 308)
    shape = (h0, w0) + ((channels,) if channels else ())
    img = np.random.RandomState(channels + size_wh[0]).rand(*shape).astype(np.float32)
    want = jio.resize_image(img, size_wh)
    got = io.resize_image(img, size_wh)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src_wh,dst_wh", [((56, 42), (80, 60)), ((80, 60), (56, 42)), ((30, 20), (31, 47)),
                                           ((7, 5), (3, 2))])
def test_resize_image_nearest_and_lanczos_match_cv2(src_wh, dst_wh):
    """INTER_NEAREST picks cv2's pixels (identical, any dtype); INTER_LANCZOS4
    of a 3-channel image within the 5e-7 of the Lanczos4 test above."""
    rng = np.random.RandomState(src_wh[0])
    img = rng.rand(src_wh[1], src_wh[0], 3).astype(np.float32)
    np.testing.assert_array_equal(io.resize_image(img, dst_wh, "nearest"), jio.resize_image(img, dst_wh, "nearest"))
    mask = rng.rand(src_wh[1], src_wh[0]) > 0.5
    np.testing.assert_array_equal(io.resize_image(mask, dst_wh, "nearest"),
                                  jio.resize_image(mask.astype(np.uint8), dst_wh, "nearest") > 0)
    np.testing.assert_allclose(io.resize_image(img, dst_wh, "lanczos"), jio.resize_image(img, dst_wh, "lanczos"),
                               atol=5e-7, rtol=0)


def _mask_image(kind, rng):
    """Values near the gray threshold: for PNG16 around 256, for PNG8 around 1."""
    if kind == "png8":
        return (rng.rand(40, 50) < 0.5).astype(np.uint8) * rng.randint(1, 256, (40, 50)).astype(np.uint8)
    if kind == "png16":
        return rng.randint(0, 600, (40, 50)).astype(np.uint16)
    c = 4 if kind.startswith("rgba") else 3
    top = 3 if kind.endswith("8") else 600
    return rng.randint(0, top, (40, 50, c)).astype(np.uint8 if kind.endswith("8") else np.uint16)


@pytest.mark.parametrize("kind", ["png8", "png16", "rgb8", "rgb16", "rgba16"])
def test_read_mask_matches_cv2_grayscale(tmp_path, kind):
    """read_mask is cv2.imread(IMREAD_GRAYSCALE) > 0 (the JAX package's
    read_mask): PNG16 keeps the high byte, so 1..255 read false; RGB
    becomes libpng's gray (truncated at 8 bits, rounded at 16). Files from
    cv2 and from the port's encoder, identical booleans."""
    img = _mask_image(kind, np.random.RandomState(len(kind)))
    p = str(tmp_path / "m.png")
    cv2.imwrite(p, _bgr(img) if img.ndim == 3 else img)
    want = jio.read_mask(p)
    assert 0.05 < want.mean() < 0.95
    np.testing.assert_array_equal(io.read_mask(p), want)
    io.write_png(p, img)
    np.testing.assert_array_equal(io.read_mask(p), jio.read_mask(p))


def test_write_mask_matches_jax(tmp_path):
    m = np.random.RandomState(3).rand(9, 13) > 0.4
    io.write_mask(str(tmp_path / "t.png"), m)
    jio.write_mask(str(tmp_path / "j.png"), m)
    assert np.array_equal(io.read_png(str(tmp_path / "t.png")), io.read_png(str(tmp_path / "j.png")))
    np.testing.assert_array_equal(jio.read_mask(str(tmp_path / "t.png")), m)
