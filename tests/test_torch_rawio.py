"""The port's RAW and DNG containers (``core/rawio.py``) against the JAX
package's: the files are a byte contract, so every file the port writes
must equal the JAX package's byte for byte, and the readers must return the
same arrays (exactly) and tags."""

import numpy as np
import pytest

from facebook360_dep_tpu.core import rawio as jraw
from facebook360_dep_tpu_torch.core import rawio as traw

import torch_parity  # noqa: F401  (torch threads)


def _mosaic(seed, shape=(24, 32)):
    rng = np.random.RandomState(seed)
    m = rng.rand(*shape).astype(np.float32)
    m[0, :4] = [0.0, 1.0, -0.5, 1.5]  # the clip at both ends
    return m


@pytest.mark.parametrize("bpp", [8, 10, 12, 16])
def test_write_raw_bytes_and_read_raw_match_jax(tmp_path, bpp):
    m = _mosaic(bpp)
    jpath, tpath = tmp_path / "j.raw", tmp_path / "t.raw"
    jraw.write_raw(str(jpath), m, bpp)
    traw.write_raw(str(tpath), m, bpp)
    assert jpath.read_bytes() == tpath.read_bytes()
    h, w = m.shape
    got, want = traw.read_raw(str(tpath), w, h, bpp), jraw.read_raw(str(jpath), w, h, bpp)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pattern", ["RGGB", "GRBG", "GBRG", "BGGR"])
@pytest.mark.parametrize("bpp", [8, 16])
def test_write_dng_bytes_and_read_dng_match_jax(tmp_path, pattern, bpp):
    m = _mosaic(3, (20, 28))
    kwargs = dict(bayer_pattern=pattern.lower(), bits_per_pixel=bpp, black_level=0.0625,
                  ccm=((1.2, -0.1, -0.1), (-0.15, 1.3, -0.15), (0.0, -0.25, 1.25)),
                  white_balance_gain=(1.1, 1.0, 1.7), software="RawToRgb test")
    jpath, tpath = tmp_path / "j.dng", tmp_path / "sub" / "t.dng"
    jraw.write_dng(str(jpath), m, **kwargs)
    traw.write_dng(str(tpath), m, **kwargs)
    assert jpath.read_bytes() == tpath.read_bytes()
    got, got_tags = traw.read_dng(str(tpath))
    want, want_tags = jraw.read_dng(str(jpath))
    np.testing.assert_array_equal(got, want)
    assert got_tags == want_tags
    assert got_tags[traw.TAG_CFA_PATTERN][2][:4] == traw.CFA_PATTERN_BYTES[pattern]
    assert np.abs(got - np.clip(m, 0, 1)).max() <= 1.0 / ((1 << bpp) - 1)


def test_dng_defaults_match_jax(tmp_path):
    m = _mosaic(4, (16, 16))
    jraw.write_dng(str(tmp_path / "j.dng"), m)
    traw.write_dng(str(tmp_path / "t.dng"), m)
    assert (tmp_path / "j.dng").read_bytes() == (tmp_path / "t.dng").read_bytes()


def test_truncated_raw_and_unknown_pattern_raise(tmp_path):
    p = str(tmp_path / "short.raw")
    np.zeros(10, np.uint8).tofile(p)
    with pytest.raises(IOError, match="unexpected end of file"):
        traw.read_raw(p, 32, 24, 8)
    np.zeros(24 * 32 - 1, np.uint16).tofile(p)  # one 16-bit sample short
    with pytest.raises(IOError, match="767 of 768"):
        traw.read_raw(p, 32, 24, 16)
    with pytest.raises(ValueError, match="unknown bayer pattern"):
        traw.write_dng(str(tmp_path / "x.dng"), _mosaic(5), "RGBG")
