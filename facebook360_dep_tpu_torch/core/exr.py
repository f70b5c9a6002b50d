"""A small OpenEXR 2.0 codec on numpy and zlib: the port of ``core/exr.py``.

Scanline and single-level (ONE_LEVEL) tiled files, NONE / ZIPS / ZIP / PIZ
compression, FLOAT and HALF channels. The reference writes EXR disparity
maps through OpenCV (``util/CvUtil.cpp:31-35``), whose encoder emits ZIP
scanline blocks; capture tooling commonly writes PIZ (wavelet + Huffman, 32
scanlines a chunk), which goes through the native codec
(``stream/_native/piz.cpp``). The writer emits single-part scanline images
with FLOAT channels in INCREASING_Y order.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..stream import native

MAGIC = 20000630
VERSION = 2
_TILED_BIT = 0x200

# compression enum (OpenEXR ImfCompression.h)
NO_COMPRESSION = 0
ZIPS_COMPRESSION = 2  # 1 scanline per chunk
ZIP_COMPRESSION = 3  # 16 scanlines per chunk
PIZ_COMPRESSION = 4  # 32 scanlines per chunk

_LINES_PER_CHUNK = {NO_COMPRESSION: 1, ZIPS_COMPRESSION: 1, ZIP_COMPRESSION: 16, PIZ_COMPRESSION: 32}
# channel pixel types (ImfPixelType.h): 0=UINT, 1=HALF, 2=FLOAT
_PIXEL_DTYPE = {1: np.float16, 2: np.float32}


def _attr(name: str, type_name: str, payload: bytes) -> bytes:
    return name.encode() + b"\x00" + type_name.encode() + b"\x00" + struct.pack("<i", len(payload)) + payload


def _channel_list(names) -> bytes:
    out = b""
    for n in sorted(names):  # the spec sorts channels by name
        # pixel type 2 = FLOAT; pLinear 0; sampling 1,1
        out += n.encode() + b"\x00" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1)
    return out + b"\x00"


def _zip_predict_interleave(raw: bytes) -> bytes:
    """OpenEXR ZIP pre-filter (ImfZip::compress): split the bytes into even
    and odd halves, then delta-encode with bias 128."""
    d = np.frombuffer(raw, np.uint8)
    half = (d.size + 1) // 2
    t = np.empty(d.size, np.uint8)
    t[:half] = d[0::2]
    t[half:] = d[1::2]
    out = t.astype(np.int16)
    out[1:] = np.diff(t.astype(np.int16)) + 128
    return out.astype(np.uint8).tobytes()


def _zip_unpredict_deinterleave(filt: bytes, n: int) -> bytes:
    """Inverse of :func:`_zip_predict_interleave` (ImfZip::uncompress)."""
    t = np.frombuffer(filt, np.uint8, n).astype(np.int64)
    t[1:] -= 128
    t = np.cumsum(t).astype(np.uint8)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def _piz_sizes(channels):
    """u16 units a pixel for each channel (HALF=1, FLOAT=2)."""
    return [np.dtype(dt).itemsize // 2 for _, dt in channels]


def write_exr(path, img: np.ndarray, compression: str = "none") -> None:
    """Write (H, W) or (H, W, 3) float32 as a scanline EXR with FLOAT
    channels (Y, or R/G/B). ``compression``: "none", "zip" (OpenCV's
    default), "zips" or "piz"."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        channels = {"Y": img}
    elif img.ndim == 3 and img.shape[2] == 3:
        channels = {"R": img[..., 0], "G": img[..., 1], "B": img[..., 2]}
    else:
        raise ValueError(f"unsupported shape {img.shape}")
    h, w = img.shape[:2]
    names = sorted(channels)
    comp = {"none": NO_COMPRESSION, "zip": ZIP_COMPRESSION, "zips": ZIPS_COMPRESSION,
            "piz": PIZ_COMPRESSION}[compression]
    lines_per_chunk = _LINES_PER_CHUNK[comp]

    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (
        _attr("channels", "chlist", _channel_list(names))
        + _attr("compression", "compression", bytes([comp]))
        + _attr("dataWindow", "box2i", box)
        + _attr("displayWindow", "box2i", box)
        + _attr("lineOrder", "lineOrder", b"\x00")  # INCREASING_Y
        + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
        + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\x00"
    )
    preamble = struct.pack("<ii", MAGIC, VERSION) + header
    num_chunks = (h + lines_per_chunk - 1) // lines_per_chunk

    chunks = []
    for c in range(num_chunks):
        y0 = c * lines_per_chunk
        ny = min(lines_per_chunk, h - y0)
        raw = b"".join(np.ascontiguousarray(channels[n][y]).tobytes()
                       for y in range(y0, y0 + ny) for n in names)
        data = raw
        if comp == PIZ_COMPRESSION:  # channel-major planes of the chunk's rows
            planes = np.concatenate([np.ascontiguousarray(channels[n][y0:y0 + ny]).view(np.uint16).ravel()
                                     for n in names])
            z = native.piz_compress(planes, w, ny, _piz_sizes([(n, np.float32) for n in names]))
            data = z if len(z) < len(raw) else raw  # OpenEXR stores raw if not smaller
        elif comp != NO_COMPRESSION:
            z = zlib.compress(_zip_predict_interleave(raw))
            data = z if len(z) < len(raw) else raw  # OpenEXR stores raw if not smaller
        chunks.append((y0, data))

    with open(path, "wb") as f:
        f.write(preamble)
        pos = len(preamble) + 8 * num_chunks
        for _, data in chunks:
            f.write(struct.pack("<Q", pos))
            pos += 8 + len(data)
        for y0, data in chunks:
            f.write(struct.pack("<ii", y0, len(data)))
            f.write(data)


def _fill_chunk(planes, channels, compression, data, x0, y0, w, ny):
    """Decode one chunk's payload into the channel planes; ``(x0, y0)`` is
    its top-left, ``w`` its width in pixels, ``ny`` its scanline count."""
    raw_size = ny * w * sum(np.dtype(dt).itemsize for _, dt in channels)
    if len(data) < raw_size:  # compressed (OpenEXR stores raw when not smaller)
        if compression == PIZ_COMPRESSION:  # channel-major planes
            sizes = _piz_sizes(channels)
            planes16 = native.piz_uncompress(data, w, ny, sizes)
            off = 0
            for (n, dt), sz in zip(channels, sizes):
                cnt = ny * w * sz
                planes[n][y0:y0 + ny, x0:x0 + w] = planes16[off:off + cnt].view(dt).reshape(ny, w)
                off += cnt
            return
        data = _zip_unpredict_deinterleave(zlib.decompress(data), raw_size)
    # per scanline, each channel's row in order
    dp = 0
    for dy in range(ny):
        for n, dt in channels:
            planes[n][y0 + dy, x0:x0 + w] = np.frombuffer(data, dt, w, dp).astype(np.float32)
            dp += w * np.dtype(dt).itemsize


def read_exr(path) -> np.ndarray:
    """Read a FLOAT/HALF EXR -> (H, W) or (H, W, 3) float32.

    Single-part scanline and ONE_LEVEL tiled images with none/ZIP/ZIPS/PIZ
    compression."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    if version & ~(0xFF | _TILED_BIT):
        raise NotImplementedError(
            "multi-part / deep EXRs not supported (single-part scanline or ONE_LEVEL tiled only)")
    tiled = bool(version & _TILED_BIT)
    pos = 8
    channels = []  # (name, dtype)
    data_window = compression = tile_desc = None
    while buf[pos] != 0:
        name_end = buf.index(b"\x00", pos)
        name = buf[pos:name_end].decode()
        pos = buf.index(b"\x00", name_end + 1) + 1  # skip the type name
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        payload = buf[pos:pos + size]
        pos += size
        if name == "channels":
            cp = 0
            while payload[cp] != 0:
                ce = payload.index(b"\x00", cp)
                (ptype,) = struct.unpack_from("<i", payload, ce + 1)
                if ptype not in _PIXEL_DTYPE:
                    raise NotImplementedError(f"unsupported pixel type {ptype}")
                channels.append((payload[cp:ce].decode(), _PIXEL_DTYPE[ptype]))
                cp = ce + 1 + 16
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", payload)
        elif name == "compression":
            compression = payload[0]
        elif name == "tiles":
            tile_desc = struct.unpack_from("<iiB", payload, 0)
    pos += 1  # header terminator
    if compression not in _LINES_PER_CHUNK:
        raise NotImplementedError(f"unsupported compression {compression} (supported: none=0, ZIPS=2, ZIP=3, PIZ=4)")
    x0, y0, x1, y1 = data_window
    w, h = x1 - x0 + 1, y1 - y0 + 1
    channels.sort(key=lambda c: c[0])
    planes = {n: np.empty((h, w), np.float32) for n, _ in channels}

    if tiled:
        if tile_desc is None:
            raise ValueError("tiled EXR without a tiles attribute")
        tx, ty, mode = tile_desc
        if mode & 0x0F != 0:  # level mode: 0 = ONE_LEVEL
            raise NotImplementedError("only ONE_LEVEL tiled EXRs supported")
        ntx, nty = (w + tx - 1) // tx, (h + ty - 1) // ty
        pos += 8 * ntx * nty  # offset table
        for _ in range(ntx * nty):
            dx, dy, _lx, _ly, size = struct.unpack_from("<iiiii", buf, pos)
            pos += 20
            cx, cy = dx * tx, dy * ty
            _fill_chunk(planes, channels, compression, buf[pos:pos + size], cx, cy, min(tx, w - cx), min(ty, h - cy))
            pos += size
    else:
        lines_per_chunk = _LINES_PER_CHUNK[compression]
        num_chunks = (h + lines_per_chunk - 1) // lines_per_chunk
        pos += 8 * num_chunks  # offset table
        for _ in range(num_chunks):
            y, size = struct.unpack_from("<ii", buf, pos)
            pos += 8
            _fill_chunk(planes, channels, compression, buf[pos:pos + size], 0, y - y0, w, min(lines_per_chunk, y1 - y + 1))
            pos += size

    names = [n for n, _ in channels]
    if names == ["Y"]:
        return planes["Y"]
    if set(names) >= {"R", "G", "B"}:
        return np.stack([planes["R"], planes["G"], planes["B"]], axis=-1)
    return np.stack([planes[n] for n in names], axis=-1)
