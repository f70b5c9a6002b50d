"""Build and load the CUDA kernels of ``csrc/`` (nvcc -> shared library -> ctypes).

The sources have a plain C interface and include no PyTorch header, so one
``nvcc`` call builds them in seconds. The library lands in
``csrc/_build/<hash of sources and flags>/`` at first use (that directory is
git-ignored), so a fresh checkout builds on its first kernel launch and a
rebuilt source never loads a stale library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("project_sample.cu", "ssd_combine.cu", "cost_fused.cu", "warp_sample.cu")
HEADERS = ("common.cuh",)
# -fmad=false: products round where PyTorch rounds them (see common.cuh)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: (argtypes); each returns a cudaError_t as int
_SIGNATURES = {
    "fdt_project_sample": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P),
    "fdt_ssd_combine": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    "fdt_cost_fused": (_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P),
    "fdt_warp_sample": (_P, _I, _I, _I, _I, _P, _I, _I, _P, _P, _P),
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    The compiler's report (registers, spills) is kept in build.log beside it."""
    out = CSRC / "_build" / _digest() / "libfdt_kernels.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
