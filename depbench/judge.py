"""The comparison that decides ``correct``: the program's disparity maps
against the plain reference's, map for map.

A pixel is off where one side is finite and the other is not, or where both
are finite and differ by more than ``rel_tol`` of the reference's value. A
level's number is the share of off pixels among those finite on either
side. Limits on those shares are set per cell (``cells/<name>.json``,
``compare.limits``) from what sound runs and the control read; PERF.md gives
the readings.
"""

from __future__ import annotations

import os

import numpy as np

from depbench import pngio


def off_stats(prog: np.ndarray, ref: np.ndarray, rel_tol: float) -> dict:
    """off_share, and the median and 99th percentile of the relative gap where both are finite."""
    pf, rf = np.isfinite(prog), np.isfinite(ref)
    domain = pf | rf
    both = pf & rf
    gap = np.zeros(prog.shape, np.float64)
    gap[both] = np.abs(prog[both].astype(np.float64) - ref[both]) / np.maximum(np.abs(ref[both]), 1e-30)
    off = (pf != rf) | (both & (gap > rel_tol))
    g = gap[both]
    return dict(off_share=float(off.sum() / max(int(domain.sum()), 1)),
                median_rel=float(np.median(g)) if g.size else float("inf"),
                p99_rel=float(np.quantile(g, 0.99)) if g.size else float("inf"))


def read_maps(output_root: str, level: int, cam_ids, frame: str, shape) -> np.ndarray:
    """A job's (D, H, W) maps of one level; a map the job did not write reads as all NaN."""
    maps = []
    for c in cam_ids:
        path = os.path.join(output_root, "disparity_levels", f"level_{level}", c, f"{frame}.pfm")
        maps.append(pngio.read_pfm(path) if os.path.exists(path) else np.full(shape, np.nan, np.float32))
    return np.stack(maps)


def interior_median_rel_error(maps: np.ndarray, truth: np.ndarray, border: int = 6) -> float:
    """Median relative error against the rendered truth over finite interior pixels (a quality reading)."""
    ok = np.isfinite(maps)
    m = np.zeros(maps.shape, bool)
    m[..., border:-border, border:-border] = True
    v = ok & m
    return float(np.median(np.abs(maps[v] - truth[v]) / truth[v])) if v.any() else float("inf")
