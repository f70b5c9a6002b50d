"""Helpers of the kernel readers: K1-K3 by the names of their __global__
functions (both template modes), and their roofline share."""

from __future__ import annotations

import re

from depbench import coverage, roofline

_PATTERNS = {
    "k1": re.compile(r"\bproject_sample_kernel<\s*(\d+)\s*,\s*(true|false)\s*>"),
    "k2": re.compile(r"\bssd_combine_kernel<\s*(\d+)\s*>"),
    "k3": re.compile(r"\bcost_fused_kernel<\s*(true|false)\s*>"),
}


def which(name: str):
    """("k1" | "k2" | "k3", the template match) of a kernel name, or None."""
    for k, pat in _PATTERNS.items():
        m = pat.search(name)
        if m:
            return k, m
    return None


def _work(t, k, m, level):
    w, h = t.level_sizes[level]
    if k == "k1":
        return coverage.k1_work(t.needs[level], int(m.group(1)))
    if k == "k2":
        return roofline.k2_work(t.cameras, int(m.group(1)), h, w)
    return coverage.k3_work(t.needs[level])


def roofline_pct(t, kernel: str):
    """100 x sum(bound) / sum(device time) over the kernel's launches inside
    a level's range; None where it never ran there. K1's and K3's bounds
    count what the level's geometry needs (``coverage.py``, ``t.needs``)."""
    bound = took = 0.0
    for name, start, dur in t.kernels:
        hit = which(name)
        if hit is None or hit[0] != kernel:
            continue
        level = t.level_at(start)
        if level is None:
            continue
        bound += roofline.bound_s(*_work(t, kernel, hit[1], level))
        took += dur / 1e9
    return 100.0 * bound / took if took > 0 else None
