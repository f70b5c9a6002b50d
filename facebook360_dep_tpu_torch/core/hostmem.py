"""Host allocator tuning for image-sized numpy pipelines.

glibc malloc hands allocations over M_MMAP_THRESHOLD (128 KB default)
straight to mmap and unmaps them on free, so every large numpy temp in the
host-side pipelines (publish mesh build, fusion, ISP, IO) re-pays
first-touch page faults on each call, which cost most under virtualized
memory. Raising the mmap and trim thresholds keeps big buffers in the main
arena, where pages stay resident and get reused across calls.
``tools/chip_smoke_without_tune_malloc.py`` measures what it is worth.

The reference's C++ binaries get this for free: long-lived cv::Mat pools
and glibc's sbrk heap keep their working set mapped (util/SystemUtil.cpp
does no allocator work because it never needed to).
"""

from __future__ import annotations

import ctypes

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_done = False


def tune_malloc(threshold_bytes: int = 1 << 30) -> bool:
    """Keep allocations below ``threshold_bytes`` in the glibc arena.

    Idempotent; returns True when the tuning applied (glibc present).
    """
    global _done
    if _done:
        return True
    try:
        libc = ctypes.CDLL("libc.so.6")
        ok = bool(libc.mallopt(_M_MMAP_THRESHOLD, threshold_bytes)) and bool(
            libc.mallopt(_M_TRIM_THRESHOLD, threshold_bytes)
        )
    except OSError:  # non-glibc platform: default allocator behavior
        return False
    _done = ok
    return ok
