"""A small PNG codec on numpy and the standard library's zlib.

The port's host IO does not depend on OpenCV, so PNGs are encoded and
decoded here. The writer emits 8/16-bit gray, gray+alpha, RGB and RGBA with
filter type 0 (None) on every row. The reader undoes all five filter types
in native code (:func:`..stream.native.png_unfilter`, built with g++ at
first use) and reads every PNG as OpenCV's ``IMREAD_UNCHANGED`` reads it
through libpng (in stored channel order, not BGR):

- palette images (any bit depth) expand to RGB, or to RGBA where a ``tRNS``
  chunk gives the entries' alpha (255 past its end);
- gray at 1, 2 and 4 bits expands to 8 bits, scaled by 255 / (2^d - 1);
- a ``tRNS`` key on an RGB image adds an alpha channel, 0 where a pixel
  equals the key at the file's bit depth and the maximum elsewhere; on a
  gray image libpng drops the key, so the image stays one channel;
- Adam7-interlaced images: each pass is unfiltered alone, then scattered.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..stream import native

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> samples a pixel as stored (PNG spec 11.2.2); 3 is a palette index
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> color type of the writer
# color type -> the bit depths the spec allows
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy) (PNG spec 8.2)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


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


def _ihdr(data: bytes):
    """(width, height, bit depth, color type, interlace) from the IHDR chunk."""
    kind, ihdr = next(_chunks(data))
    if kind != b"IHDR":
        raise ValueError("PNG without leading IHDR")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    if depth not in _DEPTHS.get(ctype, ()):
        raise ValueError(f"invalid PNG: bit depth {depth} with color type {ctype}")
    if interlace not in (0, 1):
        raise ValueError(f"invalid PNG interlace method {interlace}")
    return w, h, depth, ctype, interlace


def read_header(data: bytes):
    """(width, height, bit depth, samples a pixel as stored) from the IHDR chunk."""
    w, h, depth, ctype, _ = _ihdr(data)
    return w, h, depth, _CHANNELS[ctype]


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec 9.2) -> (H, stride) uint8, in
    native code: Average and Paeth rows are sequential along the row."""
    return native.png_unfilter(raw, h, stride, bpp)


def _samples(raw: np.ndarray, h: int, w: int, c: int, depth: int) -> np.ndarray:
    """One (sub)image's filtered rows -> (h, w, c) samples, uint16 at 16
    bits, else uint8 (1, 2 and 4 bits unpacked, MSB first, each row padded
    to a whole byte)."""
    nbytes = max(depth // 8, 1)
    stride = (w * c * depth + 7) // 8
    pix = _unfilter(raw, h, stride, c * nbytes)
    if depth >= 8:
        dtype = np.dtype(">u2") if nbytes == 2 else np.dtype(np.uint8)
        return pix.view(dtype).reshape(h, w, c).astype(dtype.newbyteorder("="))
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    unpacked = (pix[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return unpacked.reshape(h, -1)[:, :w * c].reshape(h, w, c)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8/uint16 array as ``cv2.imread(...,
    IMREAD_UNCHANGED)`` gives it, with the channels in stored (gray/RGB/RGBA)
    order; see the module docstring."""
    w, h, depth, ctype, interlace = _ihdr(data)
    c = _CHANNELS[ctype]
    idat, plte, trns = [], None, None
    for kind, body in _chunks(data):
        if kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if not interlace:
        img = _samples(raw, h, w, c, depth)
    else:
        img = np.zeros((h, w, c), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
            if pw == 0 or ph == 0:
                continue  # an empty pass has no rows, not even filter bytes
            size = ph * (1 + (pw * c * depth + 7) // 8)
            img[y0::dy, x0::dx] = _samples(raw[pos:pos + size], ph, pw, c, depth)
            pos += size
    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG without a PLTE chunk")
        table = np.zeros((256, 4), np.uint8)
        colors = np.frombuffer(plte, np.uint8)[:len(plte) // 3 * 3].reshape(-1, 3)[:256]
        table[:len(colors), :3] = colors
        table[:, 3] = 255
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            table[:len(alpha), 3] = alpha
        return table[img[..., 0]][..., :4 if trns is not None else 3]
    if depth < 8:
        return img * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 2 and trns is not None and len(trns) >= 6:
        key = np.array(struct.unpack(">HHH", trns[:6]), np.int64) & ((1 << depth) - 1)
        top = np.iinfo(img.dtype).max
        alpha = np.where((img == key).all(axis=-1), 0, top).astype(img.dtype)
        return np.concatenate([img, alpha[..., None]], axis=-1)
    return img
