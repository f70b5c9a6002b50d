"""The port's PNG decode (facebook360_dep_tpu_torch/core/png.py), whose row
reconstruction runs in native code (stream/_native/png_unfilter.cpp): every
filter type at 8 and 16 bits with 1-4 channels decodes to the source; the
native rows equal the per-byte loop of PNG spec 9.2 kept here as the oracle;
files written by PIL and by OpenCV (Paeth, Average, adaptive) decode as
``cv2.imread`` reads them; hand-built palette, 1/2/4-bit, Adam7 and tRNS
files read through io.read_color and io.read_mask as the JAX package's
readers (cv2's IMREAD_UNCHANGED and IMREAD_GRAYSCALE) read them.
Tolerance: exact."""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from facebook360_dep_tpu.core import io as jio
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


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples -> (h, stride) unfiltered row bytes at ``depth``
    bits (big-endian at 16, MSB first below 8, rows padded to a byte)."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.int64)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    stride = -(-flat.shape[1] // per)
    padded = np.zeros((h, stride * per), np.int64)
    padded[:, :flat.shape[1]] = flat
    shifts = 8 - depth * (np.arange(per) + 1)
    return (padded.reshape(h, stride, per) << shifts).sum(-1).astype(np.uint8)


def _build_png(samples, depth, ctype, interlace=0, plte=None, trns=None, seed=0) -> bytes:
    """A PNG of ``samples`` (h, w, c) with a random filter type on each row
    (of each Adam7 pass when ``interlace``)."""
    rng = np.random.RandomState(seed)
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    passes = png._ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            rows = _pack(sub, depth)
            raw += filter_rows(rows, rng.randint(0, 5, rows.shape[0]), bpp).tobytes()
    out = png._SIGNATURE + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        out += png._chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        out += png._chunk(b"tRNS", trns)
    return out + png._chunk(b"IDAT", zlib.compress(raw)) + png._chunk(b"IEND", b"")


def _reads_as_jax(tmp_path, data: bytes) -> np.ndarray:
    """io.read_color and io.read_mask of the file equal the JAX readers'."""
    p = str(tmp_path / "h.png")
    with open(p, "wb") as f:
        f.write(data)
    got, want = io.read_color(p), jio.read_color(p)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(io.read_mask(p), jio.read_mask(p))
    return got


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("with_trns", [False, True])
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_palette_png_reads_as_jax(tmp_path, depth, with_trns, interlace):
    """Palette -> RGB, or RGBA where tRNS gives alpha (255 past its end)."""
    rng = np.random.RandomState(depth + 10 * interlace)
    entries = min(1 << depth, 40)
    plte = rng.randint(0, 256, (entries, 3))
    plte[0], plte[1] = (255, 0, 0), (0, 0, 255)  # luminance 76 and 29 for read_mask
    idx = rng.randint(0, entries, (9, 13, 1))
    trns = bytes([0, 128, 255][:entries]) if with_trns else None
    got = _reads_as_jax(tmp_path, _build_png(idx, depth, 3, interlace, plte.reshape(-1), trns, seed=depth))
    assert got.shape[-1] == (4 if with_trns else 3)


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_low_bit_gray_png_reads_as_jax(tmp_path, depth, interlace):
    """Gray at 1, 2 and 4 bits scales by 255 / (2^d - 1)."""
    samples = np.random.RandomState(depth).randint(0, 1 << depth, (11, 21, 1))
    got = _reads_as_jax(tmp_path, _build_png(samples, depth, 0, interlace, seed=depth))
    assert set(np.unique(got * 255).round().astype(int)) <= set(range(0, 256, 255 // ((1 << depth) - 1)))


@pytest.mark.parametrize("hw", [(1, 1), (3, 5), (9, 9), (33, 17)])
@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
@pytest.mark.parametrize("depth", [8, 16])
def test_adam7_png_reads_as_jax(tmp_path, depth, ctype, hw):
    """Each pass unfiltered alone, then scattered; images smaller than a pass
    step have empty passes."""
    samples = np.random.RandomState(hw[0] + ctype).randint(0, 1 << depth, hw + (png._CHANNELS[ctype],))
    _reads_as_jax(tmp_path, _build_png(samples, depth, ctype, 1, seed=ctype))
    assert np.array_equal(png.decode(_build_png(samples, depth, ctype, 1, seed=ctype)), samples)


@pytest.mark.parametrize("ctype", [0, 2])
@pytest.mark.parametrize("depth", [8, 16])
def test_trns_key_png_reads_as_jax(tmp_path, depth, ctype):
    """A tRNS key on RGB adds alpha (0 on the key, the maximum elsewhere); on
    gray libpng drops it, so the image stays gray."""
    c = png._CHANNELS[ctype]
    samples = np.random.RandomState(depth + ctype).randint(0, 3, (6, 7, c))
    key = struct.pack(">HHH", 1, 2, 0) if ctype == 2 else struct.pack(">H", 2)
    samples[0, 0] = (1, 2, 0)[:c]
    got = _reads_as_jax(tmp_path, _build_png(samples, depth, ctype, trns=key, seed=depth))
    assert got.shape[-1] == (4 if ctype == 2 else 3)
    if ctype == 2:
        assert got[0, 0, 3] == 0 and got[..., 3].max() == 1.0
