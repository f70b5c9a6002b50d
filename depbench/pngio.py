"""The files of a project tree: 16-bit PNG colors and 8-bit grey masks and
PFM maps written, PFM maps read.

The PNG writers are frozen copies of ``facebook360_dep_tpu_torch/core/png.py::encode``
(filter type 0 on every row, zlib level 1), the files the program's own
resize stage writes: ``encode_rgb16`` at commit
73fe11c54864db6ce32ac485256a11aec4484c40, ``encode_gray8`` (with
``core/io.py::write_mask``'s 255 for set) at commit
a4d7dce0f808aafcd6ca53506aa3edda7f58608e. ``write_pfm`` is a frozen copy of
``core/io.py::write_pfm`` (util/CvUtil.cpp:39-49) at that commit; the PFM
reader follows ``core/io.py::read_pfm`` (util/CvUtil.cpp:51-73).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def encode_rgb16(img: np.ndarray, level: int = 1) -> bytes:
    """(H, W, 3) uint16 RGB -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint16 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_rgb16 wants (H, W, 3) uint16, got {img.shape} {img.dtype}")
    h, w, _ = img.shape
    rows = np.zeros((h, 1 + w * 6), np.uint8)
    rows[:, 1:] = np.ascontiguousarray(img.astype(">u2")).view(np.uint8).reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_rgb16(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_rgb16(img))


def encode_gray8(mask: np.ndarray, level: int = 1) -> bytes:
    """(H, W) bool mask -> 8-bit grey PNG bytes, 255 where set and 0 elsewhere."""
    mask = np.asarray(mask)
    if mask.dtype != np.bool_ or mask.ndim != 2:
        raise ValueError(f"encode_gray8 wants an (H, W) bool mask, got {mask.shape} {mask.dtype}")
    h, w = mask.shape
    rows = np.zeros((h, 1 + w), np.uint8)
    rows[:, 1:] = mask.astype(np.uint8) * np.uint8(255)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_gray8(path: str, mask: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_gray8(mask))


def write_pfm(path: str, m: np.ndarray) -> None:
    """An (H, W) map as the program writes it: top-down rows, little-endian, scale -1.0."""
    m = np.ascontiguousarray(np.asarray(m, np.float32))
    if m.ndim != 2:
        raise ValueError(f"PFM expects a 2D float map, got {m.shape}")
    height, width = m.shape
    with open(path, "wb") as f:
        f.write(b"Pf\n" + f"{width} {height}\n".encode() + b"-1.0\n" + m.astype("<f4").tobytes())


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        if f.readline().strip() != b"Pf":
            raise ValueError(f"expected a 'Pf' header in {path}")
        width, height = (int(v) for v in f.readline().split())
        scale = float(f.readline().strip())
        data = np.frombuffer(f.read(width * height * 4), dtype="<f4" if scale <= 0 else ">f4")
    return data.reshape(height, width).astype(np.float32)
