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


def _rgb_samples(path) -> np.ndarray:
    """A color image's samples, before the scale to [0,1], in the channel
    order :func:`read_color` returns: (H, W, C) RGB(A), gray(+alpha)
    expanded to RGB(A). PNG through :mod:`.png`; JPEG and TIFF through
    OpenCV, BGR(A) reordered and a gray (H, W) image expanded."""
    path = str(path)
    if os.path.splitext(path)[1].lower() in _CV2_EXTS:
        img = _cv2_imread(path)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        if img.shape[-1] >= 3:
            img = img[..., [2, 1, 0] + ([3] if img.shape[-1] == 4 else [])]
        return img
    if not path.endswith(".png"):
        raise NotImplementedError(f"color images are read from PNG, JPEG or TIFF: {path}")
    img = read_png(path)
    if img.shape[-1] in (1, 2):  # gray(+alpha) -> RGB(A)
        img = np.concatenate([np.repeat(img[..., :1], 3, axis=-1), img[..., 1:]], axis=-1)
    return img


def _unit_scale(dtype):
    """The float32 divisor that maps integer samples to [0,1]; None for float samples."""
    return np.float32(np.iinfo(dtype).max) if dtype in (np.uint8, np.uint16) else None


def read_color(path) -> np.ndarray:
    """Load a color image as float32 RGB(A) in [0,1], shape (H, W, C): PNG
    through :mod:`.png`; JPEG and TIFF through OpenCV as the JAX package
    reads them (BGR(A) -> RGB(A), integers scaled by the dtype's maximum)."""
    img = _rgb_samples(path)
    scale = _unit_scale(img.dtype)
    out = img.astype(np.float32)
    return np.ascontiguousarray(out if scale is None else out / scale)


def read_color_into(path, out: np.ndarray) -> None:
    """Write ``read_color(path)[..., :3]``, bit for bit, into ``out``: a
    float32 (H, W, 3) array, such as one camera's slot of a level's stack.
    Integer samples are cast and divided straight into ``out``, with no
    float copy of the image between. Raises ValueError, naming the path,
    where the image's size is not ``out``'s."""
    img = _rgb_samples(path)[..., :3]
    if img.shape != out.shape:
        raise ValueError(f"{path}: {img.shape[1]}x{img.shape[0]} with {img.shape[2]} color channels, "
                         f"where the level's {out.shape[1]}x{out.shape[0]} RGB is expected")
    scale = _unit_scale(img.dtype)
    if scale is None:
        out[...] = img
    else:
        np.divide(img, scale, out=out, dtype=np.float32)


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


def _resize_area_boxes_int(img: np.ndarray, fx: int, fy: int, w_out: int, h_out: int) -> np.ndarray:
    """cv2's INTER_AREA at integer factors (resizeAreaFast_) of an integer
    image: 2x2 boxes of one, three or four channels take OpenCV's vector
    rounding ``(a + b + c + d + 2) >> 2``; other boxes
    ``cvRound(float(sum) * (1.f / area))``, half to even."""
    total = img.reshape((h_out, fy, w_out, fx) + img.shape[2:]).astype(np.int64).sum(axis=(1, 3))
    channels = img.shape[2] if img.ndim == 3 else 1
    if fx == fy == 2 and channels in (1, 3, 4):
        return (total + 2) >> 2
    return np.rint(total.astype(np.float32) * np.float32(1.0 / (fx * fy)))


def _cubic_coeffs(f: np.ndarray) -> np.ndarray:
    """imgproc/resize.cpp interpolateCubic (A = -0.75) in float32."""
    a, one = np.float32(-0.75), np.float32(1.0)
    x1, g = f + one, one - f
    c0 = ((a * x1 - np.float32(5) * a) * x1 + np.float32(8) * a) * x1 - np.float32(4) * a
    c1 = ((a + np.float32(2)) * f - (a + np.float32(3))) * f * f + one
    c2 = ((a + np.float32(2)) * g - (a + np.float32(3))) * g * g + one
    return np.stack([c0, c1, c2, one - c0 - c1 - c2], -1)


_KSIZE = {"area": 2, "linear": 2, "cubic": 4, "lanczos": 8}


def _resize_taps(src: int, dst: int, mode: str, is_x: bool, exact_coords: bool = False):
    """cv::resize's taps along one axis (hal::resize, the generic path):
    each output index's source indices, clamped to the image (replicated
    border), and its float32 coefficients. ``"area"`` here is INTER_AREA
    where an axis enlarges: source ``s = floor(d * src / dst)`` with weight
    ``frac((d + 1) - (s + 1) * dst / src)`` (0 where that is <= 0) on
    ``s + 1``. The other modes sample at half-pixel centers, the coordinate
    rounded to float32 unless ``exact_coords`` (OpenCV 5's INTER_LINEAR of
    a non-8-bit image keeps it in double). Along x, linear and area clamp
    the first source index into the image with weight 0 on its neighbour."""
    if mode == "lanczos":
        from ..ops import sampling

        return sampling._lanczos4_taps(src, dst)
    inv = dst / src
    scale = 1.0 / inv
    d = np.arange(dst)
    if mode == "area":
        s = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (s + 1) * inv).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f))
    else:
        f = (d + 0.5) * scale - 0.5
        if not exact_coords:
            f = f.astype(np.float32)
        s = np.floor(f).astype(np.int64)
        f = f - s
    k = _KSIZE[mode]
    if k == 2:
        if is_x:
            edge = (s < 0) | (s >= src - 1)
            f = np.where(edge, 0.0, f)
            s = np.clip(s, 0, src - 1)
        coeffs = np.stack([1.0 - f, f], -1)
    else:
        coeffs = _cubic_coeffs(f.astype(np.float32))
    idx = np.clip(s[:, None] - k // 2 + 1 + np.arange(k), 0, src - 1)
    return idx, coeffs


def _resize_separable(img: np.ndarray, w_out: int, h_out: int, mode: str) -> np.ndarray:
    """cv::resize's generic separable path (resizeGeneric_): a horizontal
    pass into row buffers, then a vertical pass over 2 (linear, enlarging
    area), 4 (cubic) or 8 (Lanczos4) rows, at cv2's arithmetic for each
    depth:

    - 8-bit: 11-bit fixed-point coefficients, integer row sums; the linear
      rows combine as OpenCV's vector code does,
      ``((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16) + 2 >> 2``, the
      others ``(sum + 2**21) >> 22``.
    - OpenCV 5's INTER_LINEAR of 16-bit and float images: coordinates in
      double and each pass ``a + (b - a) * f`` rounded once (a fused
      multiply-add) to float32, float64 for float64 images.
    - Otherwise float32 (float64 for float64 images) sums in tap order.

    Integer results round half to even and saturate."""
    h, w = img.shape[:2]
    chan = (1,) * (img.ndim - 2)
    if img.dtype == np.uint8:
        (xi, xw), (yi, yw) = _resize_taps(w, w_out, mode, True), _resize_taps(h, h_out, mode, False)
        xa, ya = (np.rint(c.astype(np.float32) * np.float32(2048)).astype(np.int64) for c in (xw, yw))
        src = img.astype(np.int64)
        rows = src[:, xi[:, 0]] * xa[:, 0].reshape((-1,) + chan)
        for t in range(1, xi.shape[1]):
            rows = rows + src[:, xi[:, t]] * xa[:, t].reshape((-1,) + chan)
        b = [ya[:, t].reshape((-1, 1) + chan) for t in range(yi.shape[1])]
        if len(b) == 2:
            out = ((((rows[yi[:, 0]] >> 4) * b[0]) >> 16) + (((rows[yi[:, 1]] >> 4) * b[1]) >> 16) + 2) >> 2
        else:
            out = rows[yi[:, 0]] * b[0]
            for t in range(1, len(b)):
                out = out + rows[yi[:, t]] * b[t]
            out = (out + (1 << 21)) >> 22
        return np.clip(out, 0, 255).astype(np.uint8)
    wt = np.float64 if img.dtype == np.float64 else np.float32
    src = img.astype(wt)
    if mode == "linear":
        xi, xw = _resize_taps(w, w_out, mode, True, exact_coords=True)
        yi, yw = _resize_taps(h, h_out, mode, False, exact_coords=True)

        def lerp(a, b, f):
            if wt is np.float64:
                return a + (b - a) * f
            return (a.astype(np.float64) + (b - a).astype(np.float64) * f.astype(np.float32)).astype(np.float32)

        rows = lerp(src[:, xi[:, 0]], src[:, xi[:, 1]], xw[:, 1].reshape((-1,) + chan))
        out = lerp(rows[yi[:, 0]], rows[yi[:, 1]], yw[:, 1].reshape((-1, 1) + chan))
    else:
        (xi, xw), (yi, yw) = _resize_taps(w, w_out, mode, True), _resize_taps(h, h_out, mode, False)
        xw, yw = xw.astype(np.float32), yw.astype(np.float32)
        rows = src[:, xi[:, 0]] * xw[:, 0].reshape((-1,) + chan)
        for t in range(1, xi.shape[1]):
            rows = rows + src[:, xi[:, t]] * xw[:, t].reshape((-1,) + chan)
        out = rows[yi[:, 0]] * yw[:, 0].reshape((-1, 1) + chan)
        for t in range(1, yi.shape[1]):
            out = out + rows[yi[:, t]] * yw[:, t].reshape((-1, 1) + chan)
    if img.dtype.kind == "f":
        return out.astype(img.dtype)
    info = np.iinfo(img.dtype)
    return np.clip(np.rint(out), info.min, info.max).astype(img.dtype)


_INTERPOLATIONS = ("area", "linear", "nearest", "cubic", "lanczos")
# the depths cv2.resize interpolates (8U, 16U, 16S, 32F, 64F); INTER_NEAREST takes any
_RESIZE_DTYPES = (np.uint8, np.uint16, np.int16, np.float32, np.float64)


def resize_image(img: np.ndarray, size_wh, interpolation: str = "area") -> np.ndarray:
    """``cv2.resize(img, size_wh, interpolation=...)`` on the host, for an
    (H, W) or (H, W, C) image of uint8, uint16, int16, float32 or float64
    (``"nearest"``: any dtype).

    - The same size is a copy.
    - ``"area"`` (INTER_AREA) shrinking both axes: at integer factors the
      box means of cv2's fast path (:func:`_resize_area_boxes`,
      :func:`_resize_area_boxes_int`), else its area-weighted tables
      (:func:`_resize_area_tables`). Where either axis enlarges, cv2's
      area-weighted linear interpolation (:func:`_resize_separable`).
    - ``"nearest"`` (INTER_NEAREST):
      ``src = min(floor(dst * (1 / (dst_size / src_size))), src_size - 1)``.
    - ``"linear"``, ``"cubic"`` (A = -0.75) and ``"lanczos"``
      (INTER_LANCZOS4): :func:`_resize_separable`; ``"linear"`` of a uint8
      image at exactly half size on both axes is cv2's 2x2 area mean, as
      cv2 turns it.

    Another mode raises ValueError and another dtype TypeError, as cv2
    rejects them.
    """
    img = np.asarray(img)
    w_out, h_out = (int(v) for v in size_wh)
    h, w = img.shape[:2]
    if interpolation not in _INTERPOLATIONS:
        raise ValueError(f"resize_image: unknown interpolation {interpolation!r}; one of {_INTERPOLATIONS}")
    if interpolation == "nearest":
        out = img[nearest_index(h, h_out)][:, nearest_index(w, w_out)]
    elif img.dtype not in _RESIZE_DTYPES:
        raise TypeError(f"resize_image: cv2.resize does not interpolate {img.dtype} images ({interpolation!r})")
    elif (w_out, h_out) == (w, h):
        out = img.copy()
    else:
        sx, sy = 1.0 / (w_out / w), 1.0 / (h_out / h)
        fx, fy = int(np.rint(sx)), int(np.rint(sy))
        eps = np.finfo(np.float64).eps
        integer = abs(sx - fx) < eps and abs(sy - fy) < eps
        if interpolation == "linear" and integer and fx == fy == 2 and img.dtype == np.uint8:
            interpolation = "area"
        if interpolation == "area" and sx >= 1 and sy >= 1:
            src = img.astype(np.float32)
            if img.dtype.kind == "f":
                out = (_resize_area_boxes(src, fx, fy, w_out, h_out) if integer
                       else _resize_area_tables(src, w_out, h_out, sx, sy)).astype(img.dtype)
            else:
                out = (_resize_area_boxes_int(img, fx, fy, w_out, h_out) if integer
                       else np.rint(_resize_area_tables(src, w_out, h_out, sx, sy)))
                info = np.iinfo(img.dtype)
                out = np.clip(out, info.min, info.max).astype(img.dtype)
        else:
            out = _resize_separable(img, w_out, h_out, interpolation)
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
