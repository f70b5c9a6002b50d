#!/usr/bin/env python3
"""Time the PyTorch port's PNG decode of a frame whose every row is Paeth-filtered.

    python3 tools/time_torch_png_decode.py [--width 2048 --height 1536 --reps 5]

Writes a W x H 8-bit RGB PNG (smooth gradients plus noise) with filter type
4 (Paeth) on every row, then prints one JSON line: the median seconds of
``facebook360_dep_tpu_torch.core.png.decode`` over ``--reps`` runs (the
first call, which may build the native library, is left out), the same for
``cv2.imread`` where OpenCV is installed, and whether the two decodes agree.
It times the host's CPU: no device is involved.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import struct
import sys
import tempfile
import time
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from facebook360_dep_tpu_torch.core import png  # noqa: E402


def paeth_filter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(H, stride) uint8 -> (H, 1 + stride) rows with filter type 4 (PNG spec 9.4)."""
    a = np.zeros_like(rows, np.int16)
    a[:, bpp:] = rows[:, :-bpp]
    b = np.zeros_like(rows, np.int16)
    b[1:] = rows[:-1]
    c = np.zeros_like(rows, np.int16)
    c[1:, bpp:] = rows[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    out = np.empty((rows.shape[0], rows.shape[1] + 1), np.uint8)
    out[:, 0] = 4
    out[:, 1:] = (rows.astype(np.int16) - pred).astype(np.uint8)
    return out


def paeth_png(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of ``img`` (H, W, 3) uint8 with every row Paeth-filtered."""
    h, w, c = img.shape
    filtered = paeth_filter(img.reshape(h, w * c), c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (png._SIGNATURE + png._chunk(b"IHDR", ihdr) + png._chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6))
            + png._chunk(b"IEND", b""))


def median_seconds(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return sorted(times)[len(times) // 2]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--height", type=int, default=1536)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args()
    rng = np.random.RandomState(0)
    y, x = np.mgrid[0:args.height, 0:args.width]
    base = (np.sin(x / 50.0 + y / 70.0) * 0.4 + 0.5)[..., None] * np.array([255.0, 200.0, 150.0])
    img = np.clip(base + rng.rand(args.height, args.width, 3) * 20, 0, 255).astype(np.uint8)
    data = paeth_png(img)
    decoded = png.decode(data)  # builds the native library on a fresh checkout
    result = dict(host=platform.processor() or platform.machine(), cpus=os.cpu_count(),
                  shape=[args.height, args.width, 3], filter="paeth", decode_equals_source=bool(np.array_equal(decoded, img)),
                  port_s=median_seconds(lambda: png.decode(data), args.reps))
    try:
        import cv2
    except ImportError:
        result["cv2_s"] = None
    else:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "paeth.png")
            with open(path, "wb") as f:
                f.write(data)
            result["cv2_s"] = median_seconds(lambda: cv2.imread(path, cv2.IMREAD_UNCHANGED), args.reps)
    print(json.dumps(result))
    return 0 if result["decode_equals_source"] else 1


if __name__ == "__main__":
    sys.exit(main())
