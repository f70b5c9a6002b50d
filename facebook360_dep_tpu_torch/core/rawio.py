"""RAW sensor-dump and DNG container IO.

Reference: ``util/RawUtil.cpp`` — a ``.raw`` file is a headerless sensor dump
(width x height samples, uint8 or uint16 little-endian, dimensions and
precision from the ISP config; ``readRawImage``, RawUtil.cpp:31-40), and
``writeDng`` (RawUtil.cpp:140-440) emits an uncompressed little-endian
TIFF 6.0 + DNG 1.3 file with the CFA pattern, black/white level, and color
matrix tags so standard RAW developers can open rig captures.
"""

from __future__ import annotations

import os
import struct

import numpy as np

# TIFF/DNG tag ids (isp/DngTags.h)
TAG_NEW_SUBFILE_TYPE = 254
TAG_IMAGE_WIDTH = 256
TAG_IMAGE_LENGTH = 257
TAG_BITS_PER_SAMPLE = 258
TAG_COMPRESSION = 259
TAG_PHOTOMETRIC = 262
TAG_STRIP_OFFSETS = 273
TAG_ORIENTATION = 274
TAG_SAMPLES_PER_PIXEL = 277
TAG_ROWS_PER_STRIP = 278
TAG_STRIP_BYTE_COUNTS = 279
TAG_PLANAR_CONFIG = 284
TAG_SOFTWARE = 305
TAG_CFA_REPEAT_PATTERN_DIM = 33421
TAG_CFA_PATTERN = 33422
TAG_DNG_VERSION = 50706
TAG_DNG_BACKWARD_VERSION = 50707
TAG_CFA_PLANE_COLOR = 50710
TAG_CFA_LAYOUT = 50711
TAG_BLACK_LEVEL_REPEAT_DIM = 50713
TAG_BLACK_LEVEL = 50714
TAG_WHITE_LEVEL = 50717
TAG_COLOR_MATRIX_1 = 50721
TAG_AS_SHOT_NEUTRAL = 50728
TAG_CALIBRATION_ILLUMINANT_1 = 50778

TYPE_BYTE, TYPE_ASCII, TYPE_SHORT, TYPE_LONG, TYPE_RATIONAL = 1, 2, 3, 4, 5
TYPE_SRATIONAL = 10
_TYPE_SIZE = {TYPE_BYTE: 1, TYPE_ASCII: 1, TYPE_SHORT: 2, TYPE_LONG: 4, TYPE_RATIONAL: 8, TYPE_SRATIONAL: 8}

# DNG CFAPattern bytes: 0=R 1=G 2=B, row-major over the 2x2 tile
CFA_PATTERN_BYTES = {
    "RGGB": b"\x00\x01\x01\x02",
    "GRBG": b"\x01\x00\x02\x01",
    "GBRG": b"\x01\x02\x00\x01",
    "BGGR": b"\x02\x01\x01\x00",
}


def read_raw(path, width: int, height: int, bits_per_pixel: int = 8) -> np.ndarray:
    """Headerless sensor dump -> float mosaic in [0, 1] (readRawImage)."""
    dtype = np.uint8 if bits_per_pixel <= 8 else np.uint16
    count = width * height
    data = np.fromfile(path, dtype=dtype, count=count)
    if data.size != count:
        raise IOError(f"unexpected end of file: {path} ({data.size} of {count} samples)")
    scale = float((1 << bits_per_pixel) - 1)
    return data.reshape(height, width).astype(np.float32) / scale


def write_raw(path, mosaic01: np.ndarray, bits_per_pixel: int = 8) -> None:
    """Float mosaic in [0, 1] -> headerless sensor dump (simulator output)."""
    scale = float((1 << bits_per_pixel) - 1)
    dtype = np.uint8 if bits_per_pixel <= 8 else np.uint16
    q = np.clip(np.round(np.asarray(mosaic01, np.float64) * scale), 0, scale).astype(dtype)
    q.tofile(path)


def _rational(v: float, den: int = 10000):
    return (int(round(v * den)), den)


def write_dng(
    path,
    mosaic01: np.ndarray,
    bayer_pattern: str = "GBRG",
    bits_per_pixel: int = 16,
    black_level: float = 0.0,
    ccm=((1, 0, 0), (0, 1, 0), (0, 0, 1)),
    white_balance_gain=(1.0, 1.0, 1.0),
    software: str = "RawToRgb",
) -> None:
    """Write an uncompressed single-IFD DNG (TIFF 6.0 + DNG 1.3 tags).

    Matches the reference writer's content (RawUtil.cpp:140-440): CFA
    photometric interpretation, 2x2 repeat pattern, black/white level, the
    ISP's CCM as ColorMatrix1 and white balance as AsShotNeutral.
    """
    mosaic01 = np.asarray(mosaic01)
    height, width = mosaic01.shape
    max_val = (1 << bits_per_pixel) - 1
    dtype = np.uint8 if bits_per_pixel <= 8 else np.uint16
    data = np.clip(np.round(mosaic01.astype(np.float64) * max_val), 0, max_val).astype(dtype)
    if dtype == np.uint16:
        data = data.astype("<u2")

    pattern = bayer_pattern.upper()[:4]
    if pattern not in CFA_PATTERN_BYTES:
        raise ValueError(f"unknown bayer pattern {bayer_pattern}")

    entries = []  # (tag, type, count, payload bytes or inline int)

    def add(tag, typ, values):
        if isinstance(values, (bytes, bytearray)):
            payload = bytes(values)
            count = len(payload) // _TYPE_SIZE[typ] if typ != TYPE_ASCII else len(payload)
        else:
            seq = values if isinstance(values, (list, tuple)) else [values]
            count = len(seq)
            if typ == TYPE_SHORT:
                payload = b"".join(struct.pack("<H", int(v)) for v in seq)
            elif typ == TYPE_LONG:
                payload = b"".join(struct.pack("<I", int(v)) for v in seq)
            elif typ == TYPE_BYTE:
                payload = bytes(int(v) & 0xFF for v in seq)
            elif typ in (TYPE_RATIONAL, TYPE_SRATIONAL):
                fmt = "<II" if typ == TYPE_RATIONAL else "<ii"
                payload = b"".join(struct.pack(fmt, *v) for v in seq)
            else:
                raise ValueError(typ)
        entries.append([tag, typ, count, payload])

    sw = software.encode() + b"\x00"
    wb = tuple(1.0 / max(g, 1e-6) for g in white_balance_gain)

    add(TAG_NEW_SUBFILE_TYPE, TYPE_LONG, 0)
    add(TAG_IMAGE_WIDTH, TYPE_LONG, width)
    add(TAG_IMAGE_LENGTH, TYPE_LONG, height)
    add(TAG_BITS_PER_SAMPLE, TYPE_SHORT, bits_per_pixel)
    add(TAG_COMPRESSION, TYPE_SHORT, 1)
    add(TAG_PHOTOMETRIC, TYPE_SHORT, 32803)  # CFA
    add(TAG_STRIP_OFFSETS, TYPE_LONG, 0)  # patched below
    add(TAG_ORIENTATION, TYPE_SHORT, 1)
    add(TAG_SAMPLES_PER_PIXEL, TYPE_SHORT, 1)
    add(TAG_ROWS_PER_STRIP, TYPE_LONG, height)  # single strip
    add(TAG_STRIP_BYTE_COUNTS, TYPE_LONG, data.nbytes)
    add(TAG_PLANAR_CONFIG, TYPE_SHORT, 1)
    add(TAG_SOFTWARE, TYPE_ASCII, sw)
    add(TAG_CFA_REPEAT_PATTERN_DIM, TYPE_SHORT, (2, 2))
    add(TAG_CFA_PATTERN, TYPE_BYTE, CFA_PATTERN_BYTES[pattern])
    add(TAG_DNG_VERSION, TYPE_BYTE, (1, 3, 0, 0))
    add(TAG_DNG_BACKWARD_VERSION, TYPE_BYTE, (1, 1, 0, 0))
    add(TAG_CFA_PLANE_COLOR, TYPE_BYTE, (0, 1, 2))
    add(TAG_CFA_LAYOUT, TYPE_SHORT, 1)
    add(TAG_BLACK_LEVEL_REPEAT_DIM, TYPE_SHORT, (2, 2))
    add(TAG_BLACK_LEVEL, TYPE_SHORT, [int(round(black_level * max_val))] * 4)
    add(TAG_WHITE_LEVEL, TYPE_LONG, max_val)
    # DNG ColorMatrix1 is XYZ->camera; the reference writes the ISP CCM here
    add(TAG_COLOR_MATRIX_1, TYPE_SRATIONAL, [_rational(v) for row in ccm for v in row])
    add(TAG_AS_SHOT_NEUTRAL, TYPE_RATIONAL, [_rational(v) for v in wb])
    add(TAG_CALIBRATION_ILLUMINANT_1, TYPE_SHORT, 23)  # D50

    entries.sort(key=lambda e: e[0])  # TIFF requires ascending tag order

    header = struct.pack("<2sHI", b"II", 42, 8)
    ifd_size = 2 + len(entries) * 12 + 4
    data_offset = 8 + ifd_size  # out-of-line tag payloads start here

    # lay out payloads > 4 bytes
    blobs = []
    for e in entries:
        if len(e[3]) > 4:
            blobs.append((e, data_offset))
            data_offset += len(e[3]) + (len(e[3]) & 1)
    strip_offset = data_offset
    for e in entries:
        if e[0] == TAG_STRIP_OFFSETS:
            e[3] = struct.pack("<I", strip_offset)

    out = bytearray(header)
    out += struct.pack("<H", len(entries))
    blob_at = {id(e): off for e, off in blobs}
    for e in entries:
        tag, typ, count, payload = e
        if len(payload) > 4 and tag != TAG_STRIP_OFFSETS:
            out += struct.pack("<HHII", tag, typ, count, blob_at[id(e)])
        else:
            out += struct.pack("<HHI", tag, typ, count) + payload.ljust(4, b"\x00")[:4]
    out += struct.pack("<I", 0)  # next IFD
    for e, _ in blobs:
        out += e[3]
        if len(e[3]) & 1:
            out += b"\x00"
    assert len(out) == strip_offset, (len(out), strip_offset)
    out += data.tobytes()

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(out)


def read_dng(path) -> tuple[np.ndarray, dict]:
    """Parse our single-IFD DNG back to (float mosaic [0,1], tag dict)."""
    with open(path, "rb") as f:
        buf = f.read()
    order, version, ifd_off = struct.unpack_from("<2sHI", buf, 0)
    assert order == b"II" and version == 42, "not a little-endian TIFF"
    (n,) = struct.unpack_from("<H", buf, ifd_off)
    tags = {}
    for i in range(n):
        tag, typ, count, val = struct.unpack_from("<HHII", buf, ifd_off + 2 + 12 * i)
        size = _TYPE_SIZE[typ] * count
        raw = (
            buf[val : val + size]
            if size > 4
            else buf[ifd_off + 2 + 12 * i + 8 : ifd_off + 2 + 12 * i + 8 + min(size, 4)]
        )
        tags[tag] = (typ, count, raw)

    def scalar(tag):
        typ, count, raw = tags[tag]
        fmt = {TYPE_SHORT: "<H", TYPE_LONG: "<I", TYPE_BYTE: "<B"}[typ]
        return struct.unpack_from(fmt, raw, 0)[0]

    width, height = scalar(TAG_IMAGE_WIDTH), scalar(TAG_IMAGE_LENGTH)
    bps = scalar(TAG_BITS_PER_SAMPLE)
    off = scalar(TAG_STRIP_OFFSETS)
    dtype = np.uint8 if bps <= 8 else "<u2"
    data = np.frombuffer(buf, dtype=dtype, count=width * height, offset=off)
    mosaic = data.reshape(height, width).astype(np.float32) / ((1 << bps) - 1)
    return mosaic, tags
