"""ctypes bindings for the native (C++) host codecs of the publish path.

``_native/*.cpp`` are serial, branchy host-side codecs, native in the
reference too (MeshSimplifier C++, ispc_texcomp ISPC): torn-quad and
adaptive-LOD face emission, QEM simplification, BC7, the z-buffer mesh
raster, OpenEXR PIZ and PNG row reconstruction. They build with one
``g++ -O3 -std=c++17 -shared -fPIC`` (the flags the JAX package builds the
same sources with, so the outputs are byte-identical to its library's) at
first use, into ``_native/_build/<hash of sources and flags>/`` (git-ignored):
a fresh checkout builds on its first call and an edited source never loads a
stale library. The build writes into a temporary directory and renames the
library into place, so processes building at once never see a partial file.

There is no fallback: where g++ is missing or the build fails, the first
call raises with the reason. ctypes releases the GIL for the length of each
call, and the sources keep no mutable global state, so threads may call
these functions concurrently.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

NATIVE = Path(__file__).resolve().parent / "_native"
SOURCES = ("adaptive_native.cpp", "bc7.cpp", "mesh_faces.cpp", "piz.cpp", "png_unfilter.cpp", "raster.cpp",
           "simplify.cpp")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_u8 = ctypes.POINTER(ctypes.c_uint8)
_u16 = ctypes.POINTER(ctypes.c_uint16)
_u32 = ctypes.POINTER(ctypes.c_uint32)
_i32 = ctypes.POINTER(ctypes.c_int)
_f32 = ctypes.POINTER(ctypes.c_float)
_I, _F = ctypes.c_int, ctypes.c_float
# C entry points: (argtypes, restype)
_SIGNATURES = {
    "simplify_mesh": ((_f32, _I, _u32, _I, _I, _F, _I, _f32, _i32, _u32, _i32), _I),
    "compress_bc7": ((_u8, _I, _I, _u8), None),
    "decompress_bc7_mode6": ((_u8, _I, _I, _u8), None),
    "rasterize_mesh": ((_f32, _I, _u32, _I, _I, _I, _F, _F, _f32), None),
    "build_faces": ((_f32, _I, _I, _F, _u32), _I),
    "build_adaptive_faces": ((_f32, _I, _I, _F, _F, _u32, _i32), _I),
    "piz_compress": ((_u16, _I, _I, _I, _i32, _u8, _i32), _I),
    "piz_uncompress": ((_u8, _I, _I, _I, _I, _i32, _u16), _I),
    "png_unfilter": ((_u8, _I, _I, _I, _u8), _I),
}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library unless the one for these sources exists; returns its path."""
    out = NATIVE / "_build" / _digest() / "libfdt_native.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native host codecs (PNG unfilter, PIZ, BC7, mesh) "
                           f"build with g++ from {NATIVE} at first use")
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib = os.path.join(tmp, out.name)
        cmd = [gxx, *FLAGS, "-o", lib, *(str(NATIVE / s) for s in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                               + (proc.stdout + proc.stderr)[-4000:])
        os.replace(lib, out)
    return out


def load() -> ctypes.CDLL:
    """The library, built on first use and loaded once per process."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _LIB = lib
        return _LIB


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _check_faces(faces: np.ndarray, num_vertexes: int) -> None:
    if faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"faces must be (F, 3), got {faces.shape}")
    if len(faces) and int(faces.max()) >= num_vertexes:
        raise ValueError(f"face index {int(faces.max())} out of range for {num_vertexes} vertices")


def png_unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (spec 9.2) of ``height`` rows of ``1 +
    stride`` bytes, ``bpp`` bytes a pixel -> (height, stride) uint8."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size < height * (stride + 1):
        raise ValueError(f"truncated PNG image data: {raw.size} bytes for {height} rows of {stride + 1}")
    out = np.empty((height, stride), np.uint8)
    rc = load().png_unfilter(_ptr(raw, _u8), int(height), int(stride), int(bpp), _ptr(out, _u8))
    if rc:
        row = -rc - 1
        raise ValueError(f"bad PNG filter type {int(raw[row * (stride + 1)])} in row {row}")
    return out


def build_faces(proxy: np.ndarray, tear_ratio: float) -> np.ndarray:
    """Torn-quad face emission from an (H, W) depth-proxy plane: the native
    form of mesh.get_triangle_masks + the face gather (MeshUtil.h:170-296).
    Returns (F, 3) uint32 in row-major quad / triangle-0..3 order."""
    proxy = np.ascontiguousarray(proxy, np.float32)
    h, w = proxy.shape
    out = np.empty((max((h - 1) * (w - 1) * 4, 1), 3), np.uint32)
    n = load().build_faces(_ptr(proxy, _f32), h, w, float(tear_ratio), _ptr(out, _u32))
    return out[:n].copy()  # release the worst-case allocation


def build_adaptive_faces(proxy: np.ndarray, tear_ratio: float, tol_rel: float, want_step: bool = False):
    """Adaptive-grid LOD face emission from an (H, W) equi-error plane with
    NaN at invalid vertices (stream/adaptive.py semantics in one native
    pass). Returns (F, 3) uint32 faces, or (faces, step_map) with want_step."""
    proxy = np.ascontiguousarray(proxy, np.float32)
    h, w = proxy.shape
    out = np.empty((max((h - 1) * (w - 1) * 4, 1), 3), np.uint32)
    nty, ntx = (h - 1) // 16, (w - 1) // 16
    step = np.zeros((max(nty, 1), max(ntx, 1)), np.int32)
    n = load().build_adaptive_faces(_ptr(proxy, _f32), h, w, float(tear_ratio), float(tol_rel), _ptr(out, _u32),
                                    _ptr(step, _i32))
    faces = out[:n].copy()
    return (faces, step[:nty, :ntx]) if want_step else faces


def simplify_mesh(vertexes: np.ndarray, faces: np.ndarray, target_faces: int, strictness: float = 0.2,
                  remove_boundary: bool = False):
    """QEM edge-collapse decimation to <= target_faces triangles
    (render/MeshSimplifier::simplify; 150k triangles, strictness 0.2 in
    ConvertToBinary.cpp:200-216). Where convergence stalls the mesh stays
    valid but over budget, and a warning names the count reached."""
    v = np.ascontiguousarray(vertexes, np.float32)
    f = np.ascontiguousarray(faces, np.uint32)
    _check_faces(f, len(v))
    out_v = np.empty_like(v)
    out_f = np.empty_like(f)
    out_nv, out_nf = ctypes.c_int(0), ctypes.c_int(0)
    rc = load().simplify_mesh(_ptr(v, _f32), len(v), _ptr(f, _u32), len(f), int(target_faces), float(strictness),
                              int(remove_boundary), _ptr(out_v, _f32), ctypes.byref(out_nv), _ptr(out_f, _u32),
                              ctypes.byref(out_nf))
    if rc == 1:
        logging.getLogger("stream").warning("simplify_mesh: budget not reached: %d faces (target %d)",
                                            out_nf.value, int(target_faces))
    elif rc != 0:
        raise RuntimeError(f"simplify_mesh failed: {rc}")
    return out_v[: out_nv.value].copy(), out_f[: out_nf.value].copy()


def compress_bc7(rgba: np.ndarray) -> np.ndarray:
    """RGBA8 (H, W, 4) -> BC7 blocks (16 bytes per 4x4 texel block)."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w = rgba.shape[:2]
    if rgba.shape[2:] != (4,) or h % 4 or w % 4:
        raise ValueError(f"BC7 wants (H, W, 4) with H and W multiples of 4, got {rgba.shape}")
    out = np.empty(h * w, np.uint8)  # 16 B per 16 texels = 1 B/texel
    load().compress_bc7(_ptr(rgba, _u8), w, h, _ptr(out, _u8))
    return out


def decompress_bc7(blocks: np.ndarray, width: int, height: int) -> np.ndarray:
    """BC7 mode-6 blocks -> RGBA8 (height, width, 4)."""
    blocks = np.ascontiguousarray(blocks, np.uint8)
    if width % 4 or height % 4 or blocks.size < width * height:
        raise ValueError(f"{blocks.size} BC7 bytes for a {width}x{height} image")
    out = np.empty((height, width, 4), np.uint8)
    load().decompress_bc7_mode6(_ptr(blocks, _u8), width, height, _ptr(out, _u8))
    return out


def rasterize_mesh(vertexes: np.ndarray, faces: np.ndarray, width: int, height: int, scale_x: float = 1.0,
                   scale_y: float = 1.0) -> np.ndarray:
    """Z-buffer rasterize (x, y, z) triangles into an (H, W) z map (NaN where
    uncovered); max-z wins (equi-error z grows toward the camera)."""
    v = np.ascontiguousarray(vertexes, np.float32)
    f = np.ascontiguousarray(faces, np.uint32)
    _check_faces(f, len(v))
    out = np.empty((height, width), np.float32)
    load().rasterize_mesh(_ptr(v, _f32), len(v), _ptr(f, _u32), len(f), width, height, float(scale_x),
                          float(scale_y), _ptr(out, _f32))
    return out


def piz_compress(planes: np.ndarray, nx: int, ny: int, sizes) -> bytes:
    """PIZ-compress channel-major u16 planes (OpenEXR wavelet + Huffman).

    ``planes``: concatenated per-channel (ny, nx*size) u16 planes in file
    channel order; ``sizes``: u16 units a pixel a channel (HALF=1, FLOAT=2).
    Returns the PIZ chunk payload."""
    planes = np.ascontiguousarray(planes, np.uint16).ravel()
    sz = np.ascontiguousarray(sizes, np.int32)
    if planes.size != int(nx) * int(ny) * int(sz.sum()):
        raise ValueError(f"{planes.size} u16 values for {nx}x{ny} pixels of sizes {sz.tolist()}")
    out = np.empty(planes.nbytes + 16384, np.uint8)
    out_len = ctypes.c_int(0)
    rc = load().piz_compress(_ptr(planes, _u16), int(nx), int(ny), len(sz), _ptr(sz, _i32), _ptr(out, _u8),
                             ctypes.byref(out_len))
    if rc != 0:
        raise RuntimeError(f"piz_compress failed: {rc}")
    return out[: out_len.value].tobytes()


def piz_uncompress(data: bytes, nx: int, ny: int, sizes) -> np.ndarray:
    """Inverse of :func:`piz_compress`: PIZ payload -> concatenated
    channel-major u16 planes. Raises ValueError on malformed input."""
    buf = np.frombuffer(data, np.uint8)
    sz = np.ascontiguousarray(sizes, np.int32)
    out = np.empty(int(nx) * int(ny) * int(sz.sum()), np.uint16)
    rc = load().piz_uncompress(_ptr(buf, _u8), len(buf), int(nx), int(ny), len(sz), _ptr(sz, _i32), _ptr(out, _u16))
    if rc != 0:
        raise ValueError(f"malformed PIZ chunk (error {rc})")
    return out
