"""Adaptive-grid pre-decimation for the publish path: the port of
``facebook360_dep_tpu/stream/adaptive.py``.

The reference feeds the FULL-resolution disparity grid (6.3M faces at 2K)
into QEM decimation (render/MeshSimplifier.cpp), which is inherently serial
— the one publish stage with no hardware-parallel story on this host.
The mesh, however, comes from a regular grid, so the bulk of the decimation
can be done data-parallel: a tiled level-of-detail mesh that keeps the full
grid only near depth tears / mask edges and drops to coarse steps where a
coarse bilinear patch reproduces the surface within a relative error bound.
The output feeds the same QEM simplifier, whose input shrinks ~10-100x.

Scheme (chunked-LOD stitching, crack-free by construction):
- The (H-1, W-1) cell grid is split into TILE x TILE tiles (TILE=16).
- Per tile, the step s in {16, 8, 4, 2} is the largest whose s-subsampled
  bilinear upsample reproduces every tile vertex within tol_rel * |z|;
  tiles containing a tear quad (reference ratio test, MeshUtil.h:170-216),
  an invalid vertex, or a partial tile at the image border run at step 1.
- Step-1 tiles emit exactly the reference's per-quad torn triangulation
  (mesh.get_triangle_masks semantics) over valid quads.
- Coarse tiles emit 2-triangle quads of size s; cells along a tile side
  whose neighbor runs finer (edge step se = min(s_self, s_nbr) < s) become
  triangle fans around the cell-center grid vertex, with the shared side
  subdivided at se — both sides of every tile boundary therefore emit the
  identical vertex set, so the mesh is watertight across LOD changes.

The publish path runs the native single-pass builder
(``_native/adaptive_native.cpp``); :func:`build_adaptive_faces_numpy` is its
executable spec, vectorized numpy over the full grid with emission grouped by
(step, cell-class, edge-step pattern) template, which the tests hold the
native builder to.
"""

from __future__ import annotations

import numpy as np

from . import mesh as mesh_mod
from . import native

TILE = 16
STEPS = (16, 8, 4, 2)  # coarse -> fine candidate steps (divisors of TILE)

# plain-quad triangle patterns, scaled by step: (0=tl, 1=tr, 2=bl, 3=br)
# in the reference's order (mesh._TRIANGLES); anti = {0,3}, diag = {1,2}
_CORNERS = {"tl": (0, 0), "tr": (0, 1), "bl": (1, 0), "br": (1, 1)}
_TRI_PATTERNS = [
    ("bl", "tr", "tl"),  # 0 (anti)
    ("tl", "br", "tr"),  # 1 (diag)
    ("br", "tl", "bl"),  # 2 (diag)
    ("tr", "bl", "br"),  # 3 (anti)
]


def _upsample_error(z: np.ndarray, s: int) -> np.ndarray:
    """|z - bilinear(z[::s, ::s])| on the region covered by complete s-cells,
    0 elsewhere (uncovered vertices belong to partial tiles, which are
    forced fine anyway). NaNs propagate -> +inf error."""
    h, w = z.shape
    zs = z[::s, ::s]
    ny, nx = zs.shape
    if ny < 2 or nx < 2:
        return np.zeros_like(z)
    wgt = (np.arange(s, dtype=np.float32) / s)[None, :, None]
    # rows: (ny-1, s, nx) linear blend between consecutive subsampled rows
    rows = zs[:-1, None, :] * (1 - wgt) + zs[1:, None, :] * wgt
    rows = rows.reshape((ny - 1) * s, nx)
    wgt2 = (np.arange(s, dtype=np.float32) / s)[None, None, :]
    up = rows[:, :-1, None] * (1 - wgt2) + rows[:, 1:, None] * wgt2
    up = up.reshape((ny - 1) * s, (nx - 1) * s)
    err = np.zeros((h, w), np.float32)
    hh, ww = up.shape
    d = z[:hh, :ww] - up
    np.abs(d, out=d)
    err[:hh, :ww] = np.where(np.isfinite(d), d, np.inf)
    # subsample points themselves are exact, but NaN there must still poison
    err[:hh:s, :ww:s] = np.where(np.isfinite(z[:hh:s, :ww:s]), 0.0, np.inf)
    return err


def _tile_max(a: np.ndarray, nty: int, ntx: int) -> np.ndarray:
    """Max over TILE x TILE blocks of a (covering complete tiles only)."""
    return (
        a[: nty * TILE, : ntx * TILE]
        .reshape(nty, TILE, ntx, TILE)
        .max(axis=(1, 3))
    )


def _tile_any(a: np.ndarray, nty: int, ntx: int) -> np.ndarray:
    return (
        a[: nty * TILE, : ntx * TILE]
        .reshape(nty, TILE, ntx, TILE)
        .any(axis=(1, 3))
    )


def compute_step_map(
    z: np.ndarray, valid: np.ndarray, tear_ratio: float, tol_rel: float
) -> np.ndarray:
    """(nty, ntx) per-tile step in {1, 2, 4, 8, 16} over COMPLETE tiles;
    the partial right/bottom remainder is handled by the emitter at step 1.
    z is the equi-error height (focal * disparity); valid marks vertices
    that may appear in the mesh (finite & unmasked)."""
    h, w = z.shape
    nty, ntx = (h - 1) // TILE, (w - 1) // TILE
    if nty == 0 or ntx == 0:
        return np.zeros((0, 0), np.int32)

    zq = np.where(valid, z, np.nan).astype(np.float32)

    # per-quad "must stay fine": any invalid corner or a tear
    # (min/max ratio <= tear_ratio, the all_close test of MeshUtil.h:170)
    c0, c1 = zq[:-1, :-1], zq[:-1, 1:]
    c2, c3 = zq[1:, :-1], zq[1:, 1:]
    vmin = np.minimum(np.minimum(c0, c1), np.minimum(c2, c3))
    vmax = np.maximum(np.maximum(c0, c1), np.maximum(c2, c3))
    with np.errstate(divide="ignore", invalid="ignore"):
        bad = ~(vmin / vmax > tear_ratio)  # NaN -> True
    tile_bad = _tile_any(bad, nty, ntx)

    # tolerance scale: per-tile mean |z| (relative error bound)
    zmean = np.abs(
        np.nan_to_num(zq[: nty * TILE, : ntx * TILE], nan=0.0)
    ).reshape(nty, TILE, ntx, TILE).mean(axis=(1, 3))
    tol = tol_rel * np.maximum(zmean, 1e-30)

    step = np.ones((nty, ntx), np.int32)
    ok_prev = ~tile_bad
    # finer steps subsume coarser ones: a tile failing s=2 fails all
    for s in (2, 4, 8, 16):
        err = _tile_max(_upsample_error(zq, s), nty, ntx)
        ok_prev = ok_prev & (err <= tol)
        step = np.where(ok_prev, s, step)
    return step


def _fan_template(s: int, se: tuple[int, int, int, int]) -> np.ndarray:
    """(ntri, 3, 2) (dy, dx) triangle offsets for an s-cell fanned around
    its center, with side k subdivided at se[k] (top, right, bottom, left).
    Orientation matches the reference quad patterns."""
    pts: list[tuple[int, int]] = []
    for k in range(0, s, se[0]):
        pts.append((0, k))
    for k in range(0, s, se[1]):
        pts.append((k, s))
    for k in range(s, 0, -se[2]):
        pts.append((s, k))
    for k in range(s, 0, -se[3]):
        pts.append((k, 0))
    c = (s // 2, s // 2)
    n = len(pts)
    # (c, p_{i+1}, p_i): same winding as the reference triangles
    return np.asarray(
        [[c, pts[(i + 1) % n], pts[i]] for i in range(n)], np.int64
    )


def _quad_template(s: int, anti: bool) -> np.ndarray:
    """(2, 3, 2) offsets for a plain s-quad split along the chosen diagonal."""
    idx = (0, 3) if anti else (1, 2)
    return np.asarray(
        [[[_CORNERS[name][0] * s, _CORNERS[name][1] * s] for name in _TRI_PATTERNS[i]] for i in idx],
        np.int64,
    )


def build_adaptive_faces(
    z: np.ndarray,
    valid: np.ndarray,
    tear_ratio: float = 0.95,
    tol_rel: float = 1e-3,
) -> np.ndarray:
    """(F, 3) uint32 faces over the (H, W) vertex grid: full-resolution torn
    triangulation (reference semantics) near tears/mask edges, coarse
    crack-free LOD tiles elsewhere. See module docstring.

    Default tol_rel = 1e-3: SOLVED maps carry per-pixel noise at the solver's
    refinement quantum (~1e-3 rel — proposal/ping-pong step floor), and a
    tighter tolerance keeps noisy-but-flat tiles at full resolution, feeding
    QEM 15x the faces for no visible gain (measured on a real 2K solve:
    2.39M faces in at 2e-4 vs 154k at 1e-3, a knee that plateaus at 135k by
    5e-3; simplify 2.8 s -> 0.15 s). The 150k-triangle viewer budget's own
    QEM error dwarfs a 0.1% depth deviation.

    Runs the native single-pass builder (_native/adaptive_native.cpp), which
    emits the face set of :func:`build_adaptive_faces_numpy`."""
    zf = np.where(valid, z, np.nan).astype(np.float32)
    return native.build_adaptive_faces(zf, tear_ratio, tol_rel)


def build_adaptive_faces_numpy(
    z: np.ndarray,
    valid: np.ndarray,
    tear_ratio: float = 0.95,
    tol_rel: float = 1e-3,
) -> np.ndarray:
    """Vectorized-numpy executable spec of :func:`build_adaptive_faces`."""
    h, w = z.shape
    step = compute_step_map(z, valid, tear_ratio, tol_rel)
    nty, ntx = step.shape

    zf = np.where(valid, z, np.nan).astype(np.float32)
    out_faces: list[np.ndarray] = []

    # ---- fine region: all quads not inside a complete coarse tile --------
    fine_quad = np.ones((h - 1, w - 1), bool)
    if nty and ntx:
        coarse_tile = step > 1
        fine_quad[: nty * TILE, : ntx * TILE] = ~np.repeat(
            np.repeat(coarse_tile, TILE, 0), TILE, 1
        )
    fq = np.flatnonzero(fine_quad.reshape(-1))
    if len(fq):
        qy, qx = fq // (w - 1), fq % (w - 1)
        base = (qy * w + qx).astype(np.uint32)
        corners = np.stack(
            [zf[qy, qx], zf[qy, qx + 1], zf[qy + 1, qx], zf[qy + 1, qx + 1]], -1
        )
        finite4 = np.isfinite(corners).all(-1)
        base, corners = base[finite4], corners[finite4]
        if len(base):
            masks = mesh_mod.get_triangle_masks(corners, tear_ratio)
            offsets = {"tl": 0, "tr": 1, "bl": w, "br": w + 1}
            pat = np.asarray(
                [[offsets[p] for p in _TRI_PATTERNS[t]] for t in range(4)],
                np.uint32,
            )
            emit = np.flatnonzero(masks.reshape(-1))
            out_faces.append(base[emit >> 2][:, None] + pat[emit & 3])

    if nty and ntx:
        # per-side edge steps: min(self, neighbor); image border -> self
        def nbr(axis: int, direction: int) -> np.ndarray:
            # outside the tiled region means image border or partial strip;
            # partial strips are step 1 (fine), true image borders need no
            # stitching -> treat as self
            s = step
            out = np.empty_like(s)
            if axis == 0:
                if direction < 0:
                    out[1:], out[0] = s[:-1], s[0]
                else:
                    out[:-1], out[-1] = s[1:], s[-1]
                # bottom partial strip exists if (h-1) % TILE: neighbors fine
                if direction > 0 and (h - 1) % TILE:
                    out[-1] = 1
            else:
                if direction < 0:
                    out[:, 1:], out[:, 0] = s[:, :-1], s[:, 0]
                else:
                    out[:, :-1], out[:, -1] = s[:, 1:], s[:, -1]
                if direction > 0 and (w - 1) % TILE:
                    out[:, -1] = 1
            return out

        se_top = np.minimum(step, nbr(0, -1))
        se_bottom = np.minimum(step, nbr(0, +1))
        se_left = np.minimum(step, nbr(1, -1))
        se_right = np.minimum(step, nbr(1, +1))

        ty, tx = np.mgrid[0:nty, 0:ntx]
        groups: dict[tuple, list[np.ndarray]] = {}

        for s in STEPS:
            sel = step == s
            if not sel.any():
                continue
            n = TILE // s  # cells per tile side
            oy = (ty[sel] * TILE).astype(np.int64)
            ox = (tx[sel] * TILE).astype(np.int64)
            et, eb = se_top[sel], se_bottom[sel]
            el, er = se_left[sel], se_right[sel]
            # cell grid offsets within the tile
            cy, cx = np.mgrid[0:n, 0:n] * s
            for iy in range(n):
                for ix in range(n):
                    # which sides of THIS cell lie on a finer tile edge
                    top = (iy == 0) * et
                    bot = (iy == n - 1) * eb
                    lef = (ix == 0) * el
                    rig = (ix == n - 1) * er
                    # cells where every touching edge step == s are plain
                    sides = np.stack(
                        [
                            np.where(top > 0, top, s),
                            np.where(rig > 0, rig, s),
                            np.where(bot > 0, bot, s),
                            np.where(lef > 0, lef, s),
                        ],
                        -1,
                    )
                    plain = (sides == s).all(-1)
                    oyc = oy + cy[iy, ix]
                    oxc = ox + cx[iy, ix]
                    if plain.any():
                        key = ("plain", s)
                        groups.setdefault(key, []).append(
                            np.stack([oyc[plain], oxc[plain]], -1)
                        )
                    np_plain = ~plain
                    if np_plain.any():
                        sv = sides[np_plain]
                        oyf, oxf = oyc[np_plain], oxc[np_plain]
                        # group by the concrete 4-tuple of side steps
                        uniq, inv = np.unique(sv, axis=0, return_inverse=True)
                        for u_i, u in enumerate(uniq):
                            m = inv == u_i
                            key = ("fan", s, tuple(int(v) for v in u))
                            groups.setdefault(key, []).append(
                                np.stack([oyf[m], oxf[m]], -1)
                            )

        for key, origin_list in groups.items():
            origins = np.concatenate(origin_list, 0)  # (C, 2)
            if key[0] == "plain":
                s = key[1]
                # diagonal per the reference all_close rule:
                # |c0 - c3| < |c1 - c2| -> diag split, else anti
                y0, x0 = origins[:, 0], origins[:, 1]
                d_diag = np.abs(zf[y0, x0] - zf[y0 + s, x0 + s])
                d_anti = np.abs(zf[y0, x0 + s] - zf[y0 + s, x0])
                anti_sel = ~(d_diag < d_anti)
                for anti in (False, True):
                    m = anti_sel == anti
                    if not m.any():
                        continue
                    tpl = _quad_template(s, anti)  # (2, 3, 2)
                    vidx = (origins[m, 0, None, None] + tpl[None, :, :, 0]) * w + (
                        origins[m, 1, None, None] + tpl[None, :, :, 1]
                    )
                    out_faces.append(vidx.reshape(-1, 3).astype(np.uint32))
            else:
                _, s, se = key
                tpl = _fan_template(s, se)  # (ntri, 3, 2)
                vidx = (origins[:, 0, None, None] + tpl[None, :, :, 0]) * w + (
                    origins[:, 1, None, None] + tpl[None, :, :, 1]
                )
                out_faces.append(vidx.reshape(-1, 3).astype(np.uint32))

    if not out_faces:
        return np.zeros((0, 3), np.uint32)
    return np.concatenate(out_faces, 0)
