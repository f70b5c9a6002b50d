"""Image and disparity-map IO: the port of ``facebook360_dep_tpu/core/io.py``.

- PFM float maps: ``Pf\\n{w} {h}\\n-1.0\\n`` then raw little-endian float32
  rows with row 0 = the TOP row (the reference's cv::Mat order,
  ``util/CvUtil.cpp:39-73``), byte-identical to the JAX package's writer.
- PNG16 disparity: clamp [0,1] -> uint16 full range (``PyramidLevel.h:442-451``).
- PNG colors through :mod:`.png` (no OpenCV); float32 RGB(A) in [0,1].
- EXR is not supported yet.
"""

from __future__ import annotations

import os
import re

import numpy as np

from . import png


def write_pfm(path, m: np.ndarray) -> None:
    """util/CvUtil.cpp:39-49 (top-down row order, scale -1.0)."""
    m = np.ascontiguousarray(np.asarray(m, np.float32))
    if m.ndim != 2:
        raise ValueError(f"PFM expects a 2D float map, got {m.shape}")
    height, width = m.shape
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{width} {height}\n".encode())
        f.write(b"-1.0\n")
        f.write(m.astype("<f4").tobytes())


def read_pfm(path) -> np.ndarray:
    """util/CvUtil.cpp:51-73."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header != b"Pf":
            raise ValueError(f"expected 'Pf' header in {path}")
        dims = f.readline().split()
        width, height = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        data = np.frombuffer(f.read(width * height * 4), dtype="<f4" if scale <= 0 else ">f4")
    return data.reshape(height, width).astype(np.float32)


def _no_exr(path):
    raise NotImplementedError(f"EXR IO is not ported yet: {path}")


def write_png(path, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png.encode(img))


def read_png(path) -> np.ndarray:
    """(H, W, C) uint8/uint16 in stored channel order (gray/RGB/RGBA)."""
    with open(path, "rb") as f:
        return png.decode(f.read())


def write_disparity(path, disparity: np.ndarray) -> None:
    """Write by extension: .pfm (bit-compatible) or .png (uint16).

    PNG conversion clamps to [0,1] and maps NaN to 0 (PyramidLevel.h:442-451).
    """
    path = str(path)
    disparity = np.asarray(disparity, np.float32)
    if path.endswith(".pfm"):
        write_pfm(path, disparity)
    elif path.endswith(".exr"):
        _no_exr(path)
    elif path.endswith(".png"):
        d = np.nan_to_num(disparity, nan=0.0)
        d16 = np.clip(d, 0.0, 1.0) * np.float32(65535.0)
        write_png(path, (d16 + 0.5).astype(np.uint16))
    else:
        raise ValueError(f"unsupported disparity format: {path}")


def read_disparity(path) -> np.ndarray:
    path = str(path)
    if path.endswith(".pfm"):
        return read_pfm(path)
    if path.endswith(".exr"):
        _no_exr(path)
    img = read_png(path)[..., 0]
    if img.dtype == np.uint16:
        return img.astype(np.float32) / np.float32(65535.0)
    return img.astype(np.float32) / np.float32(255.0)


def read_color(path) -> np.ndarray:
    """Load a color image as float32 RGB(A) in [0,1], shape (H, W, C)."""
    path = str(path)
    if not path.endswith(".png"):
        raise NotImplementedError(f"only PNG color images are supported: {path}")
    img = read_png(path)
    scale = np.float32(65535.0 if img.dtype == np.uint16 else 255.0)
    img = img.astype(np.float32) / scale
    if img.shape[-1] in (1, 2):  # gray(+alpha) -> RGB(A)
        img = np.concatenate([np.repeat(img[..., :1], 3, axis=-1), img[..., 1:]], axis=-1)
    return np.ascontiguousarray(img)


def write_color(path, img: np.ndarray, bit_depth: int = 8) -> None:
    """Save a float [0,1] RGB(A) image as an 8- or 16-bit PNG."""
    img = np.asarray(img, np.float32)
    scale = 255.0 if bit_depth == 8 else 65535.0
    out = np.clip(img, 0.0, 1.0) * np.float32(scale) + 0.5
    write_png(path, out.astype(np.uint8 if bit_depth == 8 else np.uint16))


def frame_name(frame: int, pad: int = 6) -> str:
    """Zero-padded frame naming (image_util::intToStringZeroPad)."""
    return str(int(frame)).zfill(pad)


_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".exr", ".pfm")


def first_image_in(directory) -> str | None:
    try:
        entries = sorted(os.listdir(directory))
    except FileNotFoundError:
        return None
    for e in entries:
        if e.startswith("."):
            continue
        if os.path.splitext(e)[1].lower() in _IMAGE_EXTS:
            return os.path.join(directory, e)
    return None


def image_size(path) -> tuple[int, int]:
    """(width, height) from the PFM or PNG header, without decoding."""
    path = str(path)
    with open(path, "rb") as f:
        if path.endswith(".pfm"):
            f.readline()
            dims = f.readline().split()
            return int(dims[0]), int(dims[1])
        if path.endswith(".png"):
            w, h, _, _ = png.read_header(f.read(33))
            return w, h
    raise NotImplementedError(f"image_size: unsupported format {path}")


def get_pyramid_level_sizes(image_dir) -> dict[int, tuple[int, int]]:
    """Probe ``level_N`` subdirs for per-level (width, height). Derp.cpp:72-99."""
    sizes: dict[int, tuple[int, int]] = {}
    if not os.path.isdir(image_dir):
        return sizes
    for entry in os.listdir(image_dir):
        m = re.fullmatch(r"level_(\d+)", entry)
        if not m:
            continue
        level_dir = os.path.join(image_dir, entry)
        # images live one more level down, per-camera
        probe = None
        for cam_entry in sorted(os.listdir(level_dir)):
            sub = os.path.join(level_dir, cam_entry)
            probe = first_image_in(sub) if os.path.isdir(sub) else None
            if probe:
                break
        if probe:
            sizes[int(m.group(1))] = image_size(probe)
    return sizes
