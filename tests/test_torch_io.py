"""The port's host IO (facebook360_dep_tpu_torch/core/io.py, png.py) against
the JAX package's io and OpenCV, and its Lanczos4 resize against cv2."""

import os

import cv2
import numpy as np
import pytest
import torch

from facebook360_dep_tpu.core import io as jio
from facebook360_dep_tpu_torch.core import imagetypes, io, png
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
    with pytest.raises(NotImplementedError):
        io.write_disparity(str(tmp_path / "d.exr"), np.zeros((2, 2), np.float32))
    with pytest.raises(NotImplementedError):
        io.read_disparity(str(tmp_path / "d.exr"))


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
