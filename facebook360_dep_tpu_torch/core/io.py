"""Image and disparity-map IO: the port of ``facebook360_dep_tpu/core/io.py``.

- PFM float maps: ``Pf\\n{w} {h}\\n-1.0\\n`` then raw little-endian float32
  rows with row 0 = the TOP row (the reference's cv::Mat order,
  ``util/CvUtil.cpp:39-73``), byte-identical to the JAX package's writer.
- PNG16 disparity: clamp [0,1] -> uint16 full range (``PyramidLevel.h:442-451``).
- PNG colors through :mod:`.png` (no OpenCV); float32 RGB(A) in [0,1].
  JPEG and TIFF colors through OpenCV, imported only where such a file is
  read.
- Boolean masks with OpenCV's ``IMREAD_GRAYSCALE`` semantics.
- EXR float maps through :mod:`.exr` (numpy + zlib; PIZ through the native codec).
- Host resizes with ``cv2.resize`` semantics: INTER_AREA downscales (box
  means at integer factors, area-weighted tables otherwise), INTER_NEAREST
  and INTER_LANCZOS4.
"""

from __future__ import annotations

import math
import os
import re

import numpy as np
import torch

from . import exr, png


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


def write_png(path, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png.encode(img))


def read_png(path) -> np.ndarray:
    """(H, W, C) uint8/uint16 in stored channel order (gray/RGB/RGBA)."""
    with open(path, "rb") as f:
        return png.decode(f.read())


def write_disparity(path, disparity: np.ndarray) -> None:
    """Write by extension: .pfm (bit-compatible), .exr (float) or .png (uint16).

    PNG conversion clamps to [0,1] and maps NaN to 0 (PyramidLevel.h:442-451).
    """
    path = str(path)
    disparity = np.asarray(disparity, np.float32)
    if path.endswith(".pfm"):
        write_pfm(path, disparity)
    elif path.endswith(".exr"):
        exr.write_exr(path, disparity)
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
        img = exr.read_exr(path)
        return img[..., 0] if img.ndim == 3 else img
    img = read_png(path)[..., 0]
    if img.dtype == np.uint16:
        return img.astype(np.float32) / np.float32(65535.0)
    return img.astype(np.float32) / np.float32(255.0)


_CV2_EXTS = (".jpg", ".jpeg", ".tif", ".tiff")


def _cv2_imread(path: str) -> np.ndarray:
    """``cv2.imread(path, IMREAD_UNCHANGED)`` of a JPEG or TIFF: the formats
    the port reads through OpenCV, which it imports only here."""
    ext = os.path.splitext(path)[1].lower()
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f"reading {ext} images needs OpenCV (cv2), which is not installed: {path}") from e
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError(f"cannot load {path}")
    return img


def read_color(path) -> np.ndarray:
    """Load a color image as float32 RGB(A) in [0,1], shape (H, W, C): PNG
    through :mod:`.png`; JPEG and TIFF through OpenCV as the JAX package
    reads them (BGR(A) -> RGB(A), integers scaled by the dtype's maximum)."""
    path = str(path)
    if os.path.splitext(path)[1].lower() in _CV2_EXTS:
        img = _cv2_imread(path)
        if img.dtype in (np.uint8, np.uint16):
            img = img.astype(np.float32) / np.float32(np.iinfo(img.dtype).max)
        else:
            img = img.astype(np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        if img.shape[-1] >= 3:
            img = img[..., [2, 1, 0] + ([3] if img.shape[-1] == 4 else [])]
        return np.ascontiguousarray(img)
    if not path.endswith(".png"):
        raise NotImplementedError(f"color images are read from PNG, JPEG or TIFF: {path}")
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


def read_mask(path) -> np.ndarray:
    """``cv2.imread(path, IMREAD_GRAYSCALE) > 0`` of a PNG mask.

    OpenCV lets libpng make the gray image: RGB(A) becomes gray with
    libpng's coefficients 9797, 19234, 3737 (/ 32768; 0.299 and 0.587
    truncated), truncated at 8 bits and rounded at 16 bits, and a 16-bit
    gray value then keeps its high byte. So a PNG16 value below 256 reads
    as false. Alpha is dropped."""
    img = read_png(path)
    deep = img.dtype == np.uint16
    v = img.astype(np.int64)
    if v.shape[-1] >= 3:
        s = 9797 * v[..., 0] + 19234 * v[..., 1] + 3737 * v[..., 2]
        gray = (s + 16384) >> 15 if deep else s >> 15
    else:
        gray = v[..., 0]
    return (gray >> 8 if deep else gray) > 0


def write_mask(path, mask: np.ndarray) -> None:
    """8-bit gray PNG, 255 where the mask is set."""
    write_png(path, (np.asarray(mask) > 0).astype(np.uint8) * np.uint8(255))


def nearest_index(src: int, dst: int) -> np.ndarray:
    """Source index of each output index under cv2 INTER_NEAREST
    (cv::resizeNN): ``min(floor(d * (1 / (dst / src))), src - 1)``, with the
    scale inverted in double precision as OpenCV inverts it."""
    return np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src))).astype(np.int64), src - 1)


def _area_taps(src: int, dst: int, scale: float):
    """cv::resize INTER_AREA tables along one axis (imgproc/resize.cpp,
    computeResizeAreaTab): each output index's source indices and float32
    weights, in table order. Returns (dst, T) int64 indices and float32
    weights, zero-padded to the longest run, and each run's length."""
    runs = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        run = []
        if s1 - f1 > 1e-3:
            run.append((s1 - 1, (s1 - f1) / cell))
        run += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            run.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        runs.append(run)
    taps = max(len(r) for r in runs)
    idx = np.zeros((dst, taps), np.int64)
    wts = np.zeros((dst, taps), np.float32)
    for d, run in enumerate(runs):
        for t, (s, a) in enumerate(run):
            idx[d, t], wts[d, t] = s, np.float32(a)
    count = np.array([len(r) for r in runs])
    return idx, wts, count


def _resize_area_boxes(img: np.ndarray, fx: int, fy: int, w_out: int, h_out: int) -> np.ndarray:
    """cv2's INTER_AREA at integer factors (resizeAreaFast_) in float32:
    each box summed in row-major order four samples at a time,
    ``sum += ((a + b) + c) + d``, times ``1.f / area``; 2x2 boxes of one or
    four channels take OpenCV's SIMD order ``((a + b) + (c + d)) * 0.25``
    (one channel: in blocks of four outputs, the remainder of a row as
    above)."""
    b = img.reshape((h_out, fy, w_out, fx) + img.shape[2:])
    taps = [b[:, y, :, x] for y in range(fy) for x in range(fx)]
    area = fx * fy
    out = np.zeros_like(taps[0])
    k = 0
    while k <= area - 4:
        out = out + (((taps[k] + taps[k + 1]) + taps[k + 2]) + taps[k + 3])
        k += 4
    for t in taps[k:]:
        out = out + t
    out = out * np.float32(1.0 / area)
    channels = img.shape[2] if img.ndim == 3 else 1
    if fx == fy == 2 and channels in (1, 4):
        simd = ((taps[0] + taps[1]) + (taps[2] + taps[3])) * np.float32(0.25)
        n = w_out if channels == 4 else w_out - w_out % 4
        out[:, :n] = simd[:, :n]
    return out


def _resize_area_tables(img: np.ndarray, w_out: int, h_out: int, sx: float, sy: float) -> np.ndarray:
    """cv2's general INTER_AREA path (ResizeArea_Invoker) in float32: each
    source row is reduced along x into a row buffer, ``buf += S * alpha``
    tap by tap, then the buffers of each output row are summed,
    ``sum += beta * buf``, in table order. Every product and sum rounds to
    float32 as OpenCV's baseline (non-FMA) build rounds it. Each pass
    gathers along the leading axis, so a tap reads whole rows."""
    xi, xw, xn = _area_taps(img.shape[1], w_out, sx)
    yi, yw, yn = _area_taps(img.shape[0], h_out, sy)
    chan = (1,) * (img.ndim - 1)

    def reduce(src, idx, wts, count):
        wts = wts.reshape(wts.shape + chan)
        out = src[idx[:, 0]] * wts[:, 0]
        for t in range(1, idx.shape[1]):
            r = np.nonzero(count > t)[0]
            out[r] = out[r] + src[idx[r, t]] * wts[r, t]
        return out

    cols = reduce(np.ascontiguousarray(np.moveaxis(img, 1, 0)), xi, xw, xn)  # (W_out, H, ...)
    return reduce(np.ascontiguousarray(np.moveaxis(cols, 0, 1)), yi, yw, yn)


def resize_image(img: np.ndarray, size_wh, interpolation: str = "area") -> np.ndarray:
    """``cv2.resize(img, size_wh, interpolation=...)`` on the host.

    - ``"area"`` (INTER_AREA) shrinks a float image (H, W) or (H, W, C):
      at integer factors on both axes the mean of each box (cv2's fast
      path, :func:`_resize_area_boxes`), else cv2's area-weighted tables
      (:func:`_resize_area_tables`).
    - ``"nearest"`` (INTER_NEAREST), any dtype:
      ``src = min(floor(dst * (1 / (dst_size / src_size))), src_size - 1)``.
    - ``"lanczos"`` (INTER_LANCZOS4) of a float image, through
      :func:`..ops.sampling.resize_lanczos4`.

    Any other mode, an enlarging ``"area"`` and non-float ``"area"`` or
    ``"lanczos"`` raise NotImplementedError.
    """
    img = np.asarray(img)
    w_out, h_out = (int(v) for v in size_wh)
    h, w = img.shape[:2]
    if interpolation == "nearest":
        out = img[nearest_index(h, h_out)][:, nearest_index(w, w_out)]
    elif interpolation == "lanczos" and img.dtype.kind == "f":
        from ..ops import sampling

        out = sampling.resize_lanczos4(torch.from_numpy(np.ascontiguousarray(img)), (w_out, h_out)).numpy()
    elif interpolation == "area" and img.dtype.kind == "f" and 0 < w_out <= w and 0 < h_out <= h:
        sx, sy = 1.0 / (w_out / w), 1.0 / (h_out / h)
        fx, fy = int(np.rint(sx)), int(np.rint(sy))
        eps = np.finfo(np.float64).eps
        src = img.astype(np.float32)
        if abs(sx - fx) < eps and abs(sy - fy) < eps:
            out = _resize_area_boxes(src, fx, fy, w_out, h_out)
        else:
            out = _resize_area_tables(src, w_out, h_out, sx, sy)
        out = out.astype(img.dtype)
    else:
        raise NotImplementedError(
            f"resize_image: mode {interpolation!r} ({img.dtype}) from {w}x{h} to {w_out}x{h_out}; "
            "ported: 'area' shrinking a float image, 'nearest', 'lanczos' on a float image")
    return out[..., 0] if out.ndim == 3 and out.shape[2] == 1 else out  # cv2 drops a single channel


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


def frame_path(directory, frame: str) -> str:
    """``<directory>/<frame><ext>``, with the extension of the directory's
    first image: every frame of a camera shares one format."""
    probe = first_image_in(directory)
    if not probe:
        raise FileNotFoundError(f"no images in {directory}")
    return os.path.join(str(directory), frame + os.path.splitext(probe)[1])


def image_size(path) -> tuple[int, int]:
    """(width, height) from the PFM or PNG header, without decoding; of a
    JPEG or TIFF through OpenCV."""
    path = str(path)
    if os.path.splitext(path)[1].lower() in _CV2_EXTS:
        img = _cv2_imread(path)
        return img.shape[1], img.shape[0]
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
