"""The port's PNG decode (facebook360_dep_tpu_torch/core/png.py), whose row
reconstruction runs in native code (stream/_native/png_unfilter.cpp): every
filter type at 8 and 16 bits with 1-4 channels decodes to the source; the
native rows equal the per-byte loop of PNG spec 9.2 kept here as the oracle;
files written by PIL and by OpenCV (Paeth, Average, adaptive) decode as
``cv2.imread`` reads them. Tolerance: exact."""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from facebook360_dep_tpu_torch.core import io, png

import torch_parity  # noqa: F401  (thread count)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def unfilter_loop(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """PNG spec 9.2 byte by byte: the oracle of the native unfilter."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = [0] * stride
    for y in range(h):
        ftype, f = int(rows[y, 0]), rows[y, 1:].tolist()
        cur = [0] * stride
        for i in range(stride):
            left = cur[i - bpp] if i >= bpp else 0
            diag = prior[i - bpp] if i >= bpp else 0
            pred = [0, left, prior[i], (left + prior[i]) >> 1, _paeth(left, prior[i], diag)][ftype]
            cur[i] = (f[i] + pred) & 0xFF
        out[y] = cur
        prior = cur
    return out


def filter_rows(rows: np.ndarray, ftypes, bpp: int) -> np.ndarray:
    """(H, stride) uint8 -> (H, 1 + stride) filtered rows, row y with filter
    ``ftypes[y]`` (spec 9.2-9.4, from the known unfiltered bytes)."""
    r = rows.astype(np.int16)
    a = np.zeros_like(r)
    a[:, bpp:] = r[:, :-bpp]
    b = np.zeros_like(r)
    b[1:] = r[:-1]
    c = np.zeros_like(r)
    c[1:, bpp:] = r[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = [np.zeros_like(r), a, b, (a + b) >> 1, paeth]
    out = np.empty((rows.shape[0], rows.shape[1] + 1), np.uint8)
    out[:, 0] = ftypes
    for y, t in enumerate(ftypes):
        out[y, 1:] = (r[y] - preds[t][y]).astype(np.uint8)
    return out


def _png_bytes(img: np.ndarray, ftypes) -> bytes:
    h, w, c = img.shape
    nbytes = img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))).view(np.uint8).reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8 * nbytes, png._COLOR_TYPE[c], 0, 0, 0)
    idat = zlib.compress(filter_rows(rows, ftypes, c * nbytes).tobytes())
    return png._SIGNATURE + png._chunk(b"IHDR", ihdr) + png._chunk(b"IDAT", idat) + png._chunk(b"IEND", b"")


def _image(dtype, channels, seed=0, h=23, w=31):
    """Smooth gradients plus noise across the whole range of the dtype."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    top = np.iinfo(dtype).max
    base = (np.sin(x / 5.0 + y / 7.0) * 0.45 + 0.5)[..., None] * np.ones(channels) * top
    return np.clip(base + rng.rand(h, w, channels) * top * 0.1, 0, top).astype(dtype)


def _bgr(img):
    c = img.shape[-1]
    return img[..., 0] if c == 1 else img[..., [2, 1, 0] + ([3] if c == 4 else [])]


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_every_filter_type_decodes_to_the_source(ftype, dtype, channels):
    img = _image(dtype, channels, seed=10 * ftype + channels)
    data = _png_bytes(img, [ftype] * img.shape[0])
    np.testing.assert_array_equal(png.decode(data), img)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_native_unfilter_equals_the_loop(bpp):
    """Random bytes under a random filter a row (the first row too, where
    Up, Average and Paeth see a zero row above)."""
    rng = np.random.RandomState(bpp)
    h, stride = 9, bpp * 7
    raw = rng.randint(0, 256, (h, stride + 1)).astype(np.uint8)
    raw[:, 0] = rng.randint(0, 5, h)
    np.testing.assert_array_equal(png._unfilter(raw.reshape(-1), h, stride, bpp),
                                  unfilter_loop(raw.reshape(-1), h, stride, bpp))


def test_bad_filter_type_and_truncated_data_raise():
    raw = np.zeros((3, 7), np.uint8)
    raw[2, 0] = 5
    with pytest.raises(ValueError, match="filter type 5 in row 2"):
        png._unfilter(raw.reshape(-1), 3, 6, 3)
    with pytest.raises(ValueError, match="truncated"):
        png._unfilter(raw.reshape(-1)[:-1], 3, 6, 3)


@pytest.mark.parametrize("flag", ["FILTER_PAETH", "FILTER_AVG", "ALL_FILTERS"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_cv2_written_files_read_as_cv2_reads_them(tmp_path, flag, dtype, channels):
    img = _image(dtype, channels, seed=channels, h=37, w=53)
    p = str(tmp_path / "c.png")
    cv2.imwrite(p, _bgr(img), [cv2.IMWRITE_PNG_FILTER, getattr(cv2, f"IMWRITE_PNG_{flag}")])
    got = io.read_png(p)
    np.testing.assert_array_equal(_bgr(got), cv2.imread(p, cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("mode,channels,dtype", [("L", 1, np.uint8), ("LA", 2, np.uint8), ("RGB", 3, np.uint8),
                                                 ("RGBA", 4, np.uint8), ("I;16", 1, np.uint16)])
def test_pil_written_files_read_as_cv2_reads_them(tmp_path, mode, channels, dtype):
    """PIL writes Paeth on most rows (adaptive filtering)."""
    img = _image(dtype, channels, seed=20 + channels, h=41, w=59)
    p = str(tmp_path / "p.png")
    pil = Image.fromarray(img[..., 0] if channels == 1 else img)
    assert pil.mode == mode
    pil.save(p)
    data = open(p, "rb").read()
    w, h, depth, c = png.read_header(data)
    raw = np.frombuffer(zlib.decompress(b"".join(b for k, b in png._chunks(data) if k == b"IDAT")), np.uint8)
    assert (raw.reshape(h, -1)[:, 0] == 4).any()  # the file holds Paeth rows
    got = io.read_png(p)
    np.testing.assert_array_equal(got, img)
    if channels != 2:  # cv2 reads gray+alpha as BGRA
        np.testing.assert_array_equal(_bgr(got), cv2.imread(p, cv2.IMREAD_UNCHANGED))
