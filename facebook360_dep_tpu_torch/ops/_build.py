"""Build and load the CUDA kernels of ``csrc/`` (nvcc -> shared library -> ctypes).

The sources have a plain C interface and include no PyTorch header, so
``nvcc`` builds each in seconds: one ``nvcc -c`` per source, all started
together, then one link. The library lands in
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
SOURCES = ("project_sample.cu", "ssd_combine.cu", "cost_fused.cu", "warp_sample.cu", "tile_windows.cu",
           "joint_bilateral.cu", "chamfer.cu")
HEADERS = ("common.cuh",)
# -fmad=false: products round where PyTorch rounds them (see common.cuh)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: (argtypes); each returns a cudaError_t as int
_SIGNATURES = {
    "fdt_project_sample": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P),
    "fdt_ssd_combine": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    "fdt_cost_fused": (_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P),
    "fdt_warp_sample": (_P, _I, _I, _I, _I, _P, _I, _I, _P, _P, _P),
    "fdt_tile_windows": (_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    "fdt_project_sample_tpu": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _P, _P, _P, _P),
    "fdt_cost_fused_tpu": (_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _P, _P, _P),
    "fdt_joint_bilateral": (_P, _I, _I, _I, _P, _I, _P, _P, _I, _P, _P),
    "fdt_chamfer_labels": (_P, _I, _I, _I, _P, _P, _P),
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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, s + ".o") for s in SOURCES]
        lib = os.path.join(tmp, "lib.so")
        # one nvcc per source, all started together, each with its own log
        jobs = []
        for s, o in zip(SOURCES, objs):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)]
            f = open(o + ".log", "w+")
            jobs.append((cmd, f, subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)))
        report, failed = [], []
        for cmd, f, proc in jobs:
            code = proc.wait()
            f.seek(0)
            report.append(" ".join(cmd) + "\n" + f.read())
            f.close()
            if code:
                failed.append(report[-1])
        if not failed:
            cmd = [nvcc, "-shared", "-o", lib, *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            report.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode:
                failed.append(report[-1])
        (out.parent / "build.log").write_text("".join(report))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "".join(failed)[-4000:])
        os.replace(lib, out)
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
