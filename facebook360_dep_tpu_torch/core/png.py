"""A small PNG codec on numpy and the standard library's zlib.

The port's host IO must not depend on OpenCV (the GPU machine has none), so
8/16-bit gray, gray+alpha, RGB and RGBA PNGs are encoded and decoded here.
The writer emits filter type 0 (None) on every row; the reader undoes all
five filter types, so files from libpng/OpenCV read back identically.
Palette and interlaced files are not supported.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels (PNG spec 11.2.2); 3 (palette) is not supported
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode(img: np.ndarray, level: int = 1) -> bytes:
    """(H, W) or (H, W, C) uint8/uint16 array (channels in gray/RGB/RGBA
    order) -> PNG bytes. ``level`` is the zlib compression level."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"PNG encode wants uint8/uint16, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"PNG encode: unsupported channel count {c}")
    depth = 8 * img.dtype.itemsize
    raw = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))).view(np.uint8)
    rows = np.zeros((h, 1 + w * c * img.dtype.itemsize), np.uint8)  # filter byte 0
    rows[:, 1:] = raw.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def read_header(data: bytes):
    """(width, height, bit depth, channels) from the IHDR chunk."""
    kind, ihdr = next(_chunks(data))
    if kind != b"IHDR":
        raise ValueError("PNG without leading IHDR")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    if ctype not in _CHANNELS:
        raise NotImplementedError(f"PNG color type {ctype} (palette) is not supported")
    if depth not in (8, 16):
        raise NotImplementedError(f"PNG bit depth {depth} is not supported")
    if interlace:
        raise NotImplementedError("interlaced PNG is not supported")
    return w, h, depth, _CHANNELS[ctype]


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec 9.2) -> (H, stride) uint8."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: running sum per byte lane, mod 256
            cur = np.empty(stride, np.uint8)
            for lane in range(bpp):
                cur[lane::bpp] = np.cumsum(line[lane::bpp], dtype=np.uint8)
        elif ftype == 2:  # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average / Paeth: sequential along the row
            f, up, cur_l = line.tolist(), prior.tolist(), [0] * stride
            for i in range(stride):
                left = cur_l[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur_l[i] = (f[i] + pred) & 0xFF
            cur = np.asarray(cur_l, np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8/uint16 array, channels as stored."""
    w, h, depth, c = read_header(data)
    idat = b"".join(body for kind, body in _chunks(data) if kind == b"IDAT")
    nbytes = depth // 8
    bpp = c * nbytes
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    pix = _unfilter(raw, h, w * bpp, bpp)
    dtype = np.dtype(">u2") if nbytes == 2 else np.dtype(np.uint8)
    return pix.view(dtype).reshape(h, w, c).astype(dtype.newbyteorder("="))
