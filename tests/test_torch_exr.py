"""The port's EXR codec (facebook360_dep_tpu_torch/core/exr.py) against the
JAX package's: files written by either package read back exactly by the
other, HALF and tiled files built from the OpenEXR spec read alike by
both, and PIZ files, FLOAT and HALF, written by either read back by the
other. Tolerance: exact (float32 and float16 values are stored bit for
bit)."""

import struct
import zlib

import numpy as np
import pytest

from facebook360_dep_tpu.core import exr as jexr
from facebook360_dep_tpu.core import io as jio
from facebook360_dep_tpu.stream import native as jnative
from facebook360_dep_tpu_torch.core import exr as texr
from facebook360_dep_tpu_torch.core import io as tio
from facebook360_dep_tpu_torch.stream import native as tnative

import torch_parity  # noqa: F401  (thread count)

COMPRESSIONS = ["none", "zips", "zip"]
COMP_CODE = {"none": 0, "zips": 2, "zip": 3}


def _image(channels, seed=0, h=37, w=29):
    """Smooth rows (ZIP shrinks them) plus noise, NaN and inf, as disparity maps hold."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = (np.sin(x / 4.0 + y / 9.0)[..., None] * np.ones(channels or 1) * 2.0
           + rng.rand(h, w, channels or 1) * 0.01).astype(np.float32)
    img[3, 4] = np.nan
    img[5, 6] = np.inf
    return img[..., 0] if not channels else img


@pytest.mark.parametrize("compression", COMPRESSIONS)
@pytest.mark.parametrize("channels", [0, 3])
def test_port_writes_jax_reads(tmp_path, compression, channels):
    """The port's files are the JAX writer's bytes and read back exactly."""
    img = _image(channels, seed=channels)
    t, j = str(tmp_path / "t.exr"), str(tmp_path / "j.exr")
    texr.write_exr(t, img, compression=compression)
    jexr.write_exr(j, img, compression=compression)
    assert open(t, "rb").read() == open(j, "rb").read()
    np.testing.assert_array_equal(jexr.read_exr(t), img)


@pytest.mark.parametrize("compression", COMPRESSIONS)
@pytest.mark.parametrize("channels", [0, 3])
def test_jax_writes_port_reads(tmp_path, compression, channels):
    img = _image(channels, seed=10 + channels, h=33, w=18)
    p = str(tmp_path / "j.exr")
    jexr.write_exr(p, img, compression=compression)
    got = texr.read_exr(p)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, img)


def _header(chlist: bytes, comp: int, w: int, h: int, tiles=None) -> bytes:
    def attr(n, t, p):
        return n.encode() + b"\x00" + t.encode() + b"\x00" + struct.pack("<i", len(p)) + p

    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    hdr = (attr("channels", "chlist", chlist) + attr("compression", "compression", bytes([comp]))
           + attr("dataWindow", "box2i", box) + attr("displayWindow", "box2i", box)
           + attr("lineOrder", "lineOrder", b"\x00") + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
           + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
           + attr("screenWindowWidth", "float", struct.pack("<f", 1.0)))
    if tiles is not None:
        hdr += attr("tiles", "tiledesc", struct.pack("<iiB", *tiles))
    return struct.pack("<ii", 20000630, 2 | (0x200 if tiles is not None else 0)) + hdr + b"\x00"


def _chlist(names_types) -> bytes:
    return b"".join(n.encode() + b"\x00" + struct.pack("<iBBBBii", t, 0, 0, 0, 0, 1, 1)
                    for n, t in names_types) + b"\x00"


def _zip(raw: bytes) -> bytes:
    """The OpenEXR ZIP filter written out from the spec, independent of both codecs."""
    b = np.frombuffer(raw, np.uint8)
    half = (b.size + 1) // 2
    inter = np.empty(b.size, np.uint8)
    inter[:half], inter[half:] = b[0::2], b[1::2]
    delta = inter.astype(np.int16)
    delta[1:] = np.diff(inter.astype(np.int16)) + 128
    z = zlib.compress(delta.astype(np.uint8).tobytes())
    return z if len(z) < len(raw) else raw


def _write_chunks(path, pre, chunks):
    """Offset table, then (y | dx, dy, lx, ly) + size + payload per chunk."""
    with open(path, "wb") as f:
        f.write(pre)
        pos = len(pre) + 8 * len(chunks)
        for key, data in chunks:
            f.write(struct.pack("<Q", pos))
            pos += 4 * len(key) + 4 + len(data)
        for key, data in chunks:
            f.write(struct.pack("<" + "i" * (len(key) + 1), *key, len(data)) + data)


@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_half_channels_read_alike(tmp_path, compression):
    """HALF R/G/B (OpenCV's IMWRITE_EXR_TYPE_HALF; neither writer makes
    them) and a HALF + FLOAT mix decode to the same float32 in both."""
    rng = np.random.RandomState(COMP_CODE[compression])
    h, w = 21, 13
    rgb = (rng.rand(h, w, 3) * 4 - 1).astype(np.float16)
    lines = {"none": 1, "zips": 1, "zip": 16}[compression]
    for names_types, planes in (
        ((("B", 1), ("G", 1), ("R", 1)), [rgb[..., 2], rgb[..., 1], rgb[..., 0]]),
        ((("Y", 1), ("Z", 2)), [rgb[..., 0], rgb[..., 1].astype(np.float32)]),
    ):
        pre = _header(_chlist(names_types), COMP_CODE[compression], w, h)
        chunks = []
        for y0 in range(0, h, lines):
            raw = b"".join(np.ascontiguousarray(p[y]).tobytes() for y in range(y0, min(y0 + lines, h)) for p in planes)
            chunks.append(((y0,), raw if compression == "none" else _zip(raw)))
        p = str(tmp_path / "half.exr")
        _write_chunks(p, pre, chunks)
        want, got = jexr.read_exr(p), texr.read_exr(p)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[..., 0], planes[-1] if names_types[0][0] == "B" else planes[0])


@pytest.mark.parametrize("compression", ["none", "zip"])
def test_tiled_read_alike(tmp_path, compression):
    """ONE_LEVEL tiled files with partial edge tiles decode alike; a MIPMAP
    tiled file raises."""
    rng = np.random.RandomState(11)
    img = (rng.rand(45, 70) * 3).astype(np.float32)
    h, w = img.shape
    tx, ty = 32, 16
    chlist = _chlist((("Y", 2),))
    pre = _header(chlist, COMP_CODE[compression], w, h, tiles=(tx, ty, 0))
    chunks = []
    for dy in range((h + ty - 1) // ty):
        for dx in range((w + tx - 1) // tx):
            raw = np.ascontiguousarray(img[dy * ty:(dy + 1) * ty, dx * tx:(dx + 1) * tx]).tobytes()
            chunks.append(((dx, dy, 0, 0), raw if compression == "none" else _zip(raw)))
    p = str(tmp_path / "tiled.exr")
    _write_chunks(p, pre, chunks)
    np.testing.assert_array_equal(texr.read_exr(p), img)
    np.testing.assert_array_equal(texr.read_exr(p), jexr.read_exr(p))
    mip = str(tmp_path / "mip.exr")
    with open(mip, "wb") as f:
        f.write(_header(chlist, COMP_CODE[compression], w, h, tiles=(tx, ty, 1)))
    with pytest.raises(NotImplementedError, match="ONE_LEVEL"):
        texr.read_exr(mip)


def _piz_half_file(path, planes, compress):
    """A PIZ scanline file of HALF (and FLOAT) channels, 32 lines a chunk,
    each chunk's channel-major planes compressed by ``compress`` (one of
    the two packages' native codecs); raw where PIZ does not shrink it."""
    names_types = tuple((n, 1 if p.dtype == np.float16 else 2) for n, p in planes)
    h, w = planes[0][1].shape
    chunks = []
    for y0 in range(0, h, 32):
        rows = [np.ascontiguousarray(p[y0:y0 + 32]) for _, p in planes]
        ny = rows[0].shape[0]
        raw = b"".join(r[y].tobytes() for y in range(ny) for r in rows)
        z = compress(np.concatenate([r.view(np.uint16).ravel() for r in rows]), w, ny,
                     [t for _, t in names_types])
        chunks.append(((y0,), z if len(z) < len(raw) else raw))
    _write_chunks(path, _header(_chlist(names_types), 4, w, h), chunks)


def test_piz_raises(tmp_path):
    """PIZ (wavelet + Huffman, the native codec): FLOAT Y and RGB files the
    port writes are the JAX writer's bytes and read back in both packages;
    HALF and HALF + FLOAT files compressed by either package's codec read
    alike in both; through io.read_disparity too."""
    for channels in (0, 3):
        img = _image(channels, seed=20 + channels, h=75, w=41)
        t, j = str(tmp_path / f"t{channels}.exr"), str(tmp_path / f"j{channels}.exr")
        texr.write_exr(t, img, compression="piz")
        jexr.write_exr(j, img, compression="piz")
        assert open(t, "rb").read() == open(j, "rb").read()
        np.testing.assert_array_equal(jexr.read_exr(t), img)
        np.testing.assert_array_equal(texr.read_exr(j), img)
    rng = np.random.RandomState(3)
    y, x = np.mgrid[0:70, 0:45]
    smooth = (np.sin(x / 6.0 + y / 9.0) * 2.0).astype(np.float16)
    for planes in ((("B", smooth), ("G", (smooth * 0.5).astype(np.float16)), ("R", -smooth)),
                   (("Y", smooth), ("Z", (rng.rand(70, 45) * 4).astype(np.float32)))):
        for name, compress in (("port", tnative.piz_compress), ("jax", jnative.piz_compress)):
            p = str(tmp_path / f"half_{name}_{planes[0][0]}.exr")
            _piz_half_file(p, planes, compress)
            want, got = jexr.read_exr(p), texr.read_exr(p)
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
            first = dict(planes)["R" if planes[0][0] == "B" else "Y"]
            np.testing.assert_array_equal(got[..., 0], first.astype(np.float32))
    d = _image(0, seed=30, h=40, w=33)
    jexr.write_exr(str(tmp_path / "d.exr"), d, compression="piz")
    np.testing.assert_array_equal(tio.read_disparity(str(tmp_path / "d.exr")), d)


def test_disparity_exr_through_io(tmp_path):
    """read_disparity/write_disparity by extension: the port's .exr is the
    JAX package's, both ways, NaN included."""
    d = _image(0, seed=5, h=11, w=19)
    tio.write_disparity(str(tmp_path / "t.exr"), d)
    jio.write_disparity(str(tmp_path / "j.exr"), d)
    np.testing.assert_array_equal(jio.read_disparity(str(tmp_path / "t.exr")), d)
    np.testing.assert_array_equal(tio.read_disparity(str(tmp_path / "j.exr")), d)
    rgb = _image(3, seed=6, h=7, w=8)
    jexr.write_exr(str(tmp_path / "rgb.exr"), rgb, compression="zip")
    np.testing.assert_array_equal(tio.read_disparity(str(tmp_path / "rgb.exr")), rgb[..., 0])
