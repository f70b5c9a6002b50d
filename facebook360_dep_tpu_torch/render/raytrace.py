"""Triangle-mesh raytracing with a BVH: the port of ``render/raytrace.py``.

Ground-truth scenes beyond the analytic sphere and box: the reference
accelerates ray-triangle tests with a bounding-volume hierarchy
(``render/BoundingVolumeHierarchy.h:24-118``), Moller-Trumbore intersection
(``render/RaytracingPrimitives.h:57-113``) and Perlin noise textures
(``render/PerlinNoise.h``), feeding RigSimulator's synthetic ground truth
(``rig/RigSimulator.cpp:37-64``).

The BVH is built on the host (numpy median-split AABB tree, the JAX
package's arrays) and flattened in preorder with an escape pointer per node,
so traversal is stackless: every ray carries one node index. The traversal
here is vectorised over rays: each step gathers the active rays' nodes,
tests their boxes, tests the 8-triangle block of each hit leaf, and moves
each ray to ``node + 1`` (internal hit) or ``escape[node]``; it ends when
every ray has escaped, after at most ``len(escape)`` steps. Brute force
(every ray against every triangle, chunked by rows) renders meshes of at
most 512 triangles, as in the JAX package.

Both paths give the closest hit with ties to the lowest triangle index (as
``argmin`` gives them), and the BVH's box tests are padded so that float32
rounding never drops a triangle a ray hits: inside the port the BVH equals
brute force exactly. The JAX BVH keeps the first of equal hits it visits,
so the two packages can name different triangles at a shared edge.

The barycentric tests accept BARY_EPS beyond a triangle's edges. The JAX
package tests them exactly, so a ray along the shared diagonal of a wall's
two triangles can fail both in float32 and escape the closed room (NaN
truth): 12 rays of 8 cameras at 160x120 in the occluder room.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

LEAF_SIZE = 8  # triangles tested per leaf visit (padded)
BRUTE_FORCE_MAX_TRIANGLES = 512  # render_mesh_scene's switch to the BVH
# rays x triangles values of one brute-force chunk's temporaries (64 MB
# each in float32): a chunk holds at most this many, so the peak stays
# ~1.5 GB however wide the image
BRUTE_CHUNK_ELEMENTS = 1 << 24
BVH_CHUNK_RAYS = 1 << 20
# barycentric slack of ray_triangle (dimensionless: 0.1 mm on a 12 m wall)
BARY_EPS = 1e-5
# relative and absolute padding of the traversal's boxes: above float32
# rounding of the slab and triangle distances, and above BARY_EPS times any
# edge of a triangle inside the box
_BOX_PAD_REL = 1e-4
_BOX_PAD_ABS = 1e-6


class TriangleMesh(NamedTuple):
    """Triangle soup: vertices (T, 3, 3) float32, per-triangle RGB (T, 3)."""

    vertices: torch.Tensor
    colors: torch.Tensor

    def to(self, device) -> "TriangleMesh":
        return TriangleMesh(self.vertices.to(device), self.colors.to(device))


class FlatBVH(NamedTuple):
    """Preorder-flattened AABB tree with escape pointers (all (N,) or (N, 3)).

    ``tri_start[i] >= 0`` marks a leaf owning triangles
    ``order[tri_start[i] : tri_start[i] + LEAF_SIZE]`` (padded with -1).
    """

    box_min: torch.Tensor
    box_max: torch.Tensor
    escape: torch.Tensor  # next preorder node skipping this subtree (N = done)
    tri_start: torch.Tensor  # -1 for internal nodes
    order: torch.Tensor  # leaf-contiguous triangle indices, -1 padding

    def to(self, device) -> "FlatBVH":
        return FlatBVH(*(f.to(device) for f in self))


def build_bvh(vertices, leaf_size: int = LEAF_SIZE) -> FlatBVH:
    """Host-side median-split AABB build -> flat escape-pointer arrays (CPU tensors)."""
    if isinstance(vertices, torch.Tensor):
        vertices = vertices.detach().cpu().numpy()
    v = np.asarray(vertices, np.float32)
    centroids = v.mean(axis=1)
    n = v.shape[0]

    box_min, box_max, escape, tri_start = [], [], [], []
    order: list[int] = []

    def emit(tris: np.ndarray) -> int:
        idx = len(box_min)
        tv = v[tris].reshape(-1, 3)
        box_min.append(tv.min(axis=0))
        box_max.append(tv.max(axis=0))
        escape.append(-1)  # patched after the subtree is emitted
        tri_start.append(-1)
        if len(tris) <= leaf_size:
            tri_start[idx] = len(order)
            order.extend(tris.tolist())
            order.extend([-1] * (leaf_size - len(tris)))
        else:
            c = centroids[tris]
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            half = len(tris) // 2
            part = tris[np.argsort(c[:, axis], kind="stable")]
            emit(part[:half])
            emit(part[half:])
        escape[idx] = len(box_min)
        return idx

    emit(np.arange(n))  # median split: recursion depth is O(log n)

    return FlatBVH(
        box_min=torch.from_numpy(np.stack(box_min)),
        box_max=torch.from_numpy(np.stack(box_max)),
        escape=torch.from_numpy(np.asarray(escape, np.int32)),
        tri_start=torch.from_numpy(np.asarray(tri_start, np.int32)),
        order=torch.from_numpy(np.asarray(order, np.int32)),
    )


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b as separate products and differences: no fused multiply-add,
    so every broadcast shape gives the same bits."""
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def ray_triangle(origin, direction, v0, e1, e2, eps=1e-9, bary_eps=BARY_EPS):
    """Moller-Trumbore (RaytracingPrimitives.h:57-83), broadcast over rays
    and triangles: (..., 3) each; a hit may lie ``bary_eps`` (barycentric)
    beyond an edge, so no ray slips between two triangles that share it.
    Returns t with +inf misses."""
    q = _cross(direction, e2)
    a = _dot(e1, q)
    s = origin - v0
    r = _cross(s, e1)
    b0 = _dot(s, q)
    b1 = _dot(direction, r)
    degenerate = a.abs() < eps
    inv_a = torch.where(degenerate, 0.0, 1.0 / torch.where(degenerate, 1.0, a))
    u = b0 * inv_a
    w = b1 * inv_a
    t = _dot(e2, r) * inv_a
    ok = ~degenerate & (u >= -bary_eps) & (w >= -bary_eps) & (u + w <= 1 + bary_eps) & (t > eps)
    return torch.where(ok, t, torch.inf)


def _edges(mesh: TriangleMesh, pad: bool):
    """(v0, e1, e2), each (T, 3), with a never-hit degenerate triangle
    appended at index T when ``pad`` (the leaves' -1 slots)."""
    v = mesh.vertices.to(torch.float32)
    v0, e1, e2 = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    if pad:
        z = torch.zeros((1, 3), dtype=v.dtype, device=v.device)
        v0, e1, e2 = torch.cat([v0, z]), torch.cat([e1, z]), torch.cat([e2, z])
    return v0, e1, e2


def _closest(ts: torch.Tensor, tri: torch.Tensor):
    """Per row of ``ts`` (R, K) the smallest t, ties to the smallest index
    in ``tri`` (R, K) (-1 slots never win: their t is inf)."""
    t_min = ts.min(dim=1).values
    big = torch.iinfo(torch.int64).max
    cand = torch.where((ts == t_min[:, None]) & torch.isfinite(ts), tri.to(torch.int64), big)
    k = cand.min(dim=1).values
    return t_min, torch.where(k == big, -1, k)


def intersect_brute(mesh: TriangleMesh, origins, directions, chunk_elements: int = BRUTE_CHUNK_ELEMENTS):
    """Closest hit of every ray against every triangle: (t, tri_idx) of
    the rays' shape, t = inf and tri = -1 on a miss. Chunked over rays so a
    chunk's (rays x triangles) temporaries hold ``chunk_elements`` values."""
    v0, e1, e2 = _edges(mesh, pad=False)
    num_tris = v0.shape[0]
    flat_o = origins.reshape(-1, 3)
    flat_d = directions.reshape(-1, 3)
    flat_o = flat_o.expand(flat_d.shape[0], 3) if flat_o.shape[0] == 1 else flat_o
    step = max(1, chunk_elements // max(num_tris, 1))
    ts_out, tri_out = [], []
    idx = torch.arange(num_tris, device=flat_d.device)[None, :]
    for r0 in range(0, flat_d.shape[0], step):
        o, d = flat_o[r0:r0 + step, None], flat_d[r0:r0 + step, None]
        ts = ray_triangle(o, d, v0[None], e1[None], e2[None])
        t, tri = _closest(ts, idx.expand(ts.shape))
        ts_out.append(t)
        tri_out.append(tri)
    shape = directions.shape[:-1]
    return torch.cat(ts_out).reshape(shape), torch.cat(tri_out).to(torch.int32).reshape(shape)


def _ray_aabb(origin, inv_dir, bmin, bmax, t_best):
    t0 = (bmin - origin) * inv_dir
    t1 = (bmax - origin) * inv_dir
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    # a box whose near side ties the best hit may still hold a lower-index
    # triangle at that distance: visit it (<=), where the JAX package skips it
    return (t_far >= torch.clamp(t_near, min=0.0)) & (t_near <= t_best)


def intersect_bvh(bvh: FlatBVH, mesh: TriangleMesh, origins, directions, chunk_rays: int = BVH_CHUNK_RAYS):
    """Closest hit over (..., 3) ray bundles by the stackless traversal ->
    (t, tri_idx), t = inf and tri = -1 on a miss; equal to
    :func:`intersect_brute`."""
    dev = directions.device
    bvh = bvh.to(dev)
    v0, e1, e2 = _edges(mesh.to(dev), pad=True)
    pad_slot = v0.shape[0] - 1
    pad = _BOX_PAD_REL * torch.maximum(bvh.box_min.abs(), bvh.box_max.abs()) + _BOX_PAD_ABS
    box_min, box_max = bvh.box_min - pad, bvh.box_max + pad
    escape = bvh.escape.to(torch.int64)
    tri_start = bvh.tri_start.to(torch.int64)
    order = bvh.order.to(torch.int64)
    n_nodes = escape.shape[0]
    lanes = torch.arange(LEAF_SIZE, device=dev)

    flat_d = directions.reshape(-1, 3).to(torch.float32)
    flat_o = origins.reshape(-1, 3).to(torch.float32)
    flat_o = flat_o.expand(flat_d.shape[0], 3) if flat_o.shape[0] == 1 else flat_o
    t_all = torch.full((flat_d.shape[0],), torch.inf, dtype=torch.float32, device=dev)
    tri_all = torch.full((flat_d.shape[0],), -1, dtype=torch.int64, device=dev)
    for r0 in range(0, flat_d.shape[0], chunk_rays):
        o, d = flat_o[r0:r0 + chunk_rays], flat_d[r0:r0 + chunk_rays]
        inv_dir = 1.0 / torch.where(d.abs() < 1e-12, 1e-12, d)
        t_best = t_all[r0:r0 + chunk_rays].clone()
        tri_best = tri_all[r0:r0 + chunk_rays].clone()
        node = torch.zeros(d.shape[0], dtype=torch.int64, device=dev)
        active = torch.arange(d.shape[0], device=dev)
        for _ in range(n_nodes):  # every step moves each ray to a later node
            if active.numel() == 0:
                break
            nd = node[active]
            oa, da = o[active], d[active]
            hit_box = _ray_aabb(oa, inv_dir[active], box_min[nd], box_max[nd], t_best[active])
            start = tri_start[nd]
            leaf = hit_box & (start >= 0)
            if bool(leaf.any()):
                rays = active[leaf]
                idx = order[start[leaf][:, None] + lanes]  # (R, LEAF_SIZE)
                slot = torch.where(idx < 0, pad_slot, idx)
                ts = ray_triangle(o[rays, None], d[rays, None], v0[slot], e1[slot], e2[slot])
                t_leaf, tri_leaf = _closest(ts, idx)
                tb, ib = t_best[rays], tri_best[rays]
                better = (t_leaf < tb) | ((t_leaf == tb) & (tri_leaf >= 0) & ((ib < 0) | (tri_leaf < ib)))
                t_best[rays] = torch.where(better, t_leaf, tb)
                tri_best[rays] = torch.where(better, tri_leaf, ib)
            nxt = torch.where(hit_box & (start < 0), nd + 1, escape[nd])
            node[active] = nxt
            active = active[nxt < n_nodes]
        t_all[r0:r0 + chunk_rays] = t_best
        tri_all[r0:r0 + chunk_rays] = tri_best
    shape = directions.shape[:-1]
    return t_all.reshape(shape), tri_all.to(torch.int32).reshape(shape)


# ---- Perlin improved noise (PerlinNoise.h; Perlin 2002) ----------------------

_PERLIN_P = np.array(
    [151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225, 140,
     36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148, 247, 120,
     234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32, 57, 177, 33,
     88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175, 74, 165, 71,
     134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111, 229, 122, 60, 211, 133,
     230, 220, 105, 92, 41, 55, 46, 245, 40, 244, 102, 143, 54, 65, 25, 63, 161,
     1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169, 200, 196, 135, 130,
     116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64, 52, 217, 226, 250,
     124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85, 212, 207, 206, 59, 227,
     47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170, 213, 119, 248, 152, 2, 44,
     154, 163, 70, 221, 153, 101, 155, 167, 43, 172, 9, 129, 22, 39, 253, 19,
     98, 108, 110, 79, 113, 224, 232, 178, 185, 112, 104, 218, 246, 97, 228,
     251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241, 81, 51, 145,
     235, 249, 14, 239, 107, 49, 192, 214, 31, 181, 199, 106, 157, 184, 84,
     204, 176, 115, 121, 50, 45, 127, 4, 150, 254, 138, 236, 205, 93, 222, 114,
     67, 29, 24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156, 180], np.int32)
_PERLIN_TABLE = np.concatenate([_PERLIN_P, _PERLIN_P])


def _fade(t):
    return t * t * t * (t * (t * 6 - 15) + 10)


def _grad(h, x, y, z):
    hh = h & 15
    u = torch.where(hh < 8, x, y)
    v = torch.where(hh < 4, y, torch.where((hh == 12) | (hh == 14), x, z))
    return torch.where(hh & 1 == 0, u, -u) + torch.where(hh & 2 == 0, v, -v)


def perlin(points: torch.Tensor) -> torch.Tensor:
    """Improved Perlin noise at (..., 3) points -> (...,) in ~[-1, 1]."""
    p = torch.as_tensor(_PERLIN_TABLE, device=points.device).to(torch.int64)
    cell = torch.floor(points)
    xi = cell.to(torch.int32).to(torch.int64) & 255  # floor of a negative coordinate wraps as in int32
    xf = points - cell
    x, y, z = xf[..., 0], xf[..., 1], xf[..., 2]
    u, v, w = _fade(x), _fade(y), _fade(z)
    X, Y, Z = xi[..., 0], xi[..., 1], xi[..., 2]
    a = p[X] + Y
    aa, ab = p[a] + Z, p[a + 1] + Z
    b = p[X + 1] + Y
    ba, bb = p[b] + Z, p[b + 1] + Z

    def lerp(t, p0, p1):
        return p0 + t * (p1 - p0)

    return lerp(
        w,
        lerp(v, lerp(u, _grad(p[aa], x, y, z), _grad(p[ba], x - 1, y, z)),
             lerp(u, _grad(p[ab], x, y - 1, z), _grad(p[bb], x - 1, y - 1, z))),
        lerp(v, lerp(u, _grad(p[aa + 1], x, y, z - 1), _grad(p[ba + 1], x - 1, y, z - 1)),
             lerp(u, _grad(p[ab + 1], x, y - 1, z - 1), _grad(p[bb + 1], x - 1, y - 1, z - 1))),
    )


def perlin_fbm(points, octaves: int = 4, lacunarity: float = 2.0, gain: float = 0.5):
    """Fractal sum of Perlin octaves -> (...,) roughly in [-1, 1]."""
    total = torch.zeros(points.shape[:-1], dtype=points.dtype, device=points.device)
    amp, freq, norm = 1.0, 1.0, 0.0
    for _ in range(octaves):
        total = total + amp * perlin(points * freq)
        norm += amp
        amp *= gain
        freq *= lacunarity
    return total / norm


# ---- scene construction ------------------------------------------------------


def _quad(a, b, c, d, color):
    return [np.asarray([a, b, c], np.float32), np.asarray([a, c, d], np.float32)], [color, color]


def _box_triangles(center, half_extents, color, inward: bool):
    """12 triangles of an axis-aligned box; ``inward`` flips winding (room walls)."""
    cx, cy, cz = center
    hx, hy, hz = half_extents

    def p(sx, sy, sz):
        return [cx + sx * hx, cy + sy * hy, cz + sz * hz]

    faces = [
        (p(-1, -1, -1), p(1, -1, -1), p(1, 1, -1), p(-1, 1, -1)),  # z-
        (p(-1, -1, 1), p(-1, 1, 1), p(1, 1, 1), p(1, -1, 1)),  # z+
        (p(-1, -1, -1), p(-1, 1, -1), p(-1, 1, 1), p(-1, -1, 1)),  # x-
        (p(1, -1, -1), p(1, -1, 1), p(1, 1, 1), p(1, 1, -1)),  # x+
        (p(-1, -1, -1), p(-1, -1, 1), p(1, -1, 1), p(1, -1, -1)),  # y-
        (p(-1, 1, -1), p(1, 1, -1), p(1, 1, 1), p(-1, 1, 1)),  # y+
    ]
    tris, cols = [], []
    for a, b, c, d in faces:
        if inward:
            a, b, c, d = a, d, c, b
        t, k = _quad(a, b, c, d, color)
        tris += t
        cols += k
    return tris, cols


def box_room_with_occluders(room_half_extents=(6.0, 6.0, 3.0), seed: int = 11,
                            num_occluders: int = 4) -> TriangleMesh:
    """An inward-facing textured room plus floating occluder boxes between
    the rig and the walls (depth discontinuities and occlusion, the regime
    RigSimulator tests): the JAX package's scene from the same
    ``RandomState`` draws. CPU tensors."""
    rng = np.random.RandomState(seed)
    tris, cols = _box_triangles((0.0, 0.0, 0.0), room_half_extents, (0.8, 0.75, 0.7), inward=True)
    he = np.asarray(room_half_extents)
    for _ in range(num_occluders):
        # keep occluders out of a 1 m rig-clearance bubble at the origin
        while True:
            c = rng.uniform(-0.55, 0.55, 3) * he
            if np.linalg.norm(c) > 1.6:
                break
        size = rng.uniform(0.3, 0.9, 3)
        color = rng.uniform(0.3, 1.0, 3)
        t, k = _box_triangles(c, size, tuple(color), inward=False)
        tris += t
        cols += k
    return TriangleMesh(vertices=torch.from_numpy(np.stack(tris)),
                        colors=torch.from_numpy(np.asarray(cols, np.float32)))


def shade(mesh: TriangleMesh, hit_points, tri_idx, texture_scale: float = 1.7):
    """Per-triangle base color modulated by Perlin fbm at the hit point:
    high-frequency texture so patch matching has signal."""
    colors = mesh.colors.to(hit_points.device, torch.float32)
    base = torch.cat([colors, torch.ones((1, 3), dtype=torch.float32, device=colors.device)])
    color = base[torch.where(tri_idx < 0, colors.shape[0], tri_idx.to(torch.int64))]
    tex = 0.5 + 0.5 * perlin_fbm(hit_points * texture_scale, octaves=5)
    return torch.clamp(color * tex[..., None], 0.0, 1.0)


def render_mesh_scene(rig, size_wh, mesh: TriangleMesh, bvh: FlatBVH | None = None,
                      row_chunk: int = 128, device=None):
    """Raytrace every rig camera against a triangle mesh on ``device``
    (None: the rig's). Returns (colors (N, H, W, 3), gt_disparity (N, H, W))
    float32 tensors: RigSimulator's per-camera truth outputs.

    Meshes of at most BRUTE_FORCE_MAX_TRIANGLES take brute force, larger
    ones the BVH. Rows go ``row_chunk`` at a time (fewer where a chunk's
    rays x triangles would pass BRUTE_CHUNK_ELEMENTS)."""
    from ..core import camera as cam
    from ..ops import sampling

    w, h = int(size_wh[0]), int(size_wh[1])
    cams = cam.normalize_rig(rig).cameras.to(device, torch.float32)
    dev = cams.position.device
    mesh = mesh.to(dev)
    small = mesh.vertices.shape[0] <= BRUTE_FORCE_MAX_TRIANGLES
    if not small and bvh is None:
        bvh = build_bvh(mesh.vertices)
    rows = max(1, min(row_chunk, BRUTE_CHUNK_ELEMENTS // max(w * mesh.vertices.shape[0], 1))) if small else row_chunk
    grid = sampling.pixel_center_grid(h, w, device=dev) / torch.tensor([w, h], dtype=torch.float32, device=dev)
    colors = torch.empty((len(rig.ids), h, w, 3), dtype=torch.float32, device=dev)
    disparity = torch.empty((len(rig.ids), h, w), dtype=torch.float32, device=dev)
    for i in range(len(rig.ids)):
        c = cams.index(i)
        dirs = cam.ray_dir(c, grid)  # (H, W, 3)
        for r0 in range(0, h, rows):
            d = dirs[r0:r0 + rows]
            o = c.position.expand(d.shape)
            t, tri = intersect_brute(mesh, o, d) if small else intersect_bvh(bvh, mesh, o, d)
            hit = c.position + d * t[..., None]
            colors[i, r0:r0 + rows] = shade(mesh, hit, tri)
            disparity[i, r0:r0 + rows] = torch.where(torch.isfinite(t), 1.0 / t, torch.nan)
    return colors, disparity


def ground_truth_equirect_mesh(mesh: TriangleMesh, width: int, height: int, bvh: FlatBVH | None = None,
                               origin=(0.0, 0.0, 0.0), device=None):
    """True (color (H, W, 3), disparity (H, W)) equirect from ``origin``
    over a triangle mesh by the BVH (RigSimulator's equirect truth outputs,
    arbitrary geometry), float32 tensors on ``device``."""
    from . import dibr

    if bvh is None:
        bvh = build_bvh(mesh.vertices)
    dirs = dibr.equirect_dirs(width, height, device=device)
    mesh = mesh.to(dirs.device)
    o = torch.as_tensor(origin, dtype=torch.float32, device=dirs.device).expand(dirs.shape)
    t, tri = intersect_bvh(bvh, mesh, o, dirs)
    hit = o + dirs * t[..., None]
    return shade(mesh, hit, tri), torch.where(torch.isfinite(t), 1.0 / t, torch.nan)
