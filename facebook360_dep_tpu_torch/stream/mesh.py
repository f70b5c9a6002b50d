"""Disparity-to-mesh conversion and the .vtx/.idx binary contract: the port
of ``facebook360_dep_tpu/stream/mesh.py``.

Reference: ``render/MeshUtil.h``: equi-error vertex grids
(getVertexesEquiError, :317-341), depth-tear triangle masks
(getTriangleMask/getFaces, :170-296), masked vertex/face removal, and the
row-major float32/uint32 .vtx/.idx files (writeDepth, :72-88) the 6DoF
streaming viewers read. The equi-error grid is built on the depth map's
device; faces are emitted by the native builder on the host
(``_native/mesh_faces.cpp``), whose plain twin is :func:`build_faces_plain`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import camera as cam
from . import native

# addTriangle vertex patterns (MeshUtil.h:224-247), counterclockwise;
# offsets are (0, 1, width, width+1) indexed as 0=tl, 1=tr, 2=bl, 3=br
_TRIANGLES = {
    0: ("bl", "tr", "tl"),  # top-left
    1: ("tl", "br", "tr"),  # top-right
    2: ("br", "tl", "bl"),  # bottom-left
    3: ("tr", "bl", "br"),  # bottom-right
}


def get_vertexes_equi_error(depth: torch.Tensor, camera: cam.Camera) -> torch.Tensor:
    """(H*W, 3) float32 equi-error vertices on the device of ``depth``:
    (x, y) in full-camera pixel units and z = focal / depth, so quadric
    simplification treats depth and image-plane errors equally
    (MeshUtil.h:317-341; derivation RigScene.cpp:160-186).

    The JAX package's values bit for bit: x and y formed in float64 and
    rounded to float32, z the float32 quotient of the float32 focal and
    depth."""
    h, w = depth.shape
    dev = depth.device
    res_x, res_y = (float(v) for v in camera.resolution.reshape(-1)[:2])
    focal = torch.tensor(float(camera.focal.reshape(-1)[0]), dtype=torch.float32, device=dev)
    x = ((res_x / w) * (torch.arange(w, dtype=torch.float64, device=dev) + 0.5)).float()
    y = ((res_y / h) * (torch.arange(h, dtype=torch.float64, device=dev) + 0.5)).float()
    z = focal / depth.float()  # a tensor quotient: one rounding, as numpy's
    return torch.stack([x.expand(h, w), y[:, None].expand(h, w), z], dim=-1).reshape(-1, 3)


def get_triangle_masks(corner_depths: np.ndarray, tear_ratio: float) -> np.ndarray:
    """Vectorized getTriangleMask (MeshUtil.h:170-216).

    corner_depths: (Q, 4) depth proxies in order (tl, tr, bl, br).
    Returns (Q, 4) bool: which of the 4 corner triangles each quad emits.
    """
    # float32 throughout, as the reference's MeshUtil.h
    cd = corner_depths.astype(np.float32, copy=False)
    # 4-element min/max sorting network for the sorted corner values; tie
    # handling matches a stable sort: the nearest index is the FIRST min
    # and the farthest the LAST max
    c0, c1, c2, c3 = (np.ascontiguousarray(cd[:, i]) for i in range(4))
    m01, big01 = np.minimum(c0, c1), np.maximum(c0, c1)
    m23, big23 = np.minimum(c2, c3), np.maximum(c2, c3)
    v0 = np.minimum(m01, m23)
    v3 = np.maximum(big01, big23)
    mid_a = np.maximum(m01, m23)
    mid_b = np.minimum(big01, big23)
    v1 = np.minimum(mid_a, mid_b)
    v2 = np.maximum(mid_a, mid_b)

    with np.errstate(divide="ignore", invalid="ignore"):
        all_close = v0 / v3 > tear_ratio
        lo = v0 / v2
        hi = v1 / v3

    diag_tlbr = np.abs(c0 - c3) < np.abs(c1 - c2)

    three_low = ~all_close & (lo >= tear_ratio) & (lo > hi)
    # LAST max index
    idx_low = np.where(
        (c3 >= c2) & (c3 >= c1) & (c3 >= c0), 3,
        np.where((c2 >= c1) & (c2 >= c0), 2, np.where(c1 >= c0, 1, 0)),
    ).astype(np.int8) ^ 0x3
    three_high = ~all_close & ~three_low & (hi >= tear_ratio)
    # FIRST min index
    idx_high = np.where(
        (c0 <= c1) & (c0 <= c2) & (c0 <= c3), 0,
        np.where((c1 <= c2) & (c1 <= c3), 1, np.where(c2 <= c3, 2, 3)),
    ).astype(np.int8) ^ 0x3

    close_diag = all_close & diag_tlbr
    close_anti = all_close & ~diag_tlbr
    out = np.empty((corner_depths.shape[0], 4), bool)
    out[:, 0] = close_anti | (three_low & (idx_low == 0)) | (three_high & (idx_high == 0))
    out[:, 1] = close_diag | (three_low & (idx_low == 1)) | (three_high & (idx_high == 1))
    out[:, 2] = close_diag | (three_low & (idx_low == 2)) | (three_high & (idx_high == 2))
    out[:, 3] = close_anti | (three_low & (idx_low == 3)) | (three_high & (idx_high == 3))
    return out


def build_faces_plain(proxy: np.ndarray, tear_ratio: float) -> np.ndarray:
    """The plain twin of :func:`native.build_faces`: :func:`get_triangle_masks`
    over every quad of the (H, W) proxy plane, then one gather of the
    emitted triangles, in the reference's row-major (quad, triangle 0..3)
    order."""
    proxy = np.asarray(proxy, np.float32)
    height, width = proxy.shape
    corners = np.stack([proxy[:-1, :-1], proxy[:-1, 1:], proxy[1:, :-1], proxy[1:, 1:]], axis=-1).reshape(-1, 4)
    masks = get_triangle_masks(corners, tear_ratio)  # (Q, 4)
    base = (np.arange(height - 1, dtype=np.uint32)[:, None] * np.uint32(width)
            + np.arange(width - 1, dtype=np.uint32)).reshape(-1)
    offsets = {"tl": 0, "tr": 1, "bl": width, "br": width + 1}
    pat = np.asarray([[offsets[p] for p in _TRIANGLES[t]] for t in range(4)], np.uint32)
    emit = np.flatnonzero(masks.reshape(-1))
    return (base[emit >> 2][:, None] + pat[emit & 3]).astype(np.uint32)


def get_faces(vertexes: np.ndarray, width: int, height: int, wrap_horizontally: bool = False,
              is_rig_coordinates: bool = False, tear_ratio: float = 0.0) -> np.ndarray:
    """(F, 3) uint32 faces with depth-discontinuity tears (MeshUtil.h:264-296),
    emitted by the native builder. Face order matches the reference's
    row-major quad scan with per-quad triangle order 0..3."""
    v = np.asarray(vertexes).reshape(height, width, 3)
    proxy = (np.linalg.norm(v, axis=-1) if is_rig_coordinates else v[..., 2]).astype(np.float32)
    faces = native.build_faces(proxy, tear_ratio)
    if wrap_horizontally:
        extra = []
        for y in range(height - 1):
            b = y * width
            extra.append([b + width, b, b + width - 1])
            extra.append([b + width - 1, b + 2 * width - 1, b + width])
        faces = np.concatenate([faces, np.asarray(extra)])
    return faces.astype(np.uint32)


def get_vertexes_equirect(disparity: np.ndarray, max_depth: float) -> np.ndarray:
    """Equirect disparity -> rig-coordinate vertex grid (MeshUtil.h:298-315)."""
    h, w = disparity.shape
    ys, xs = np.mgrid[0:h, 0:w]
    theta = (xs + 0.5) / w * 2.0 * np.pi
    phi = (ys + 0.5) / h * np.pi
    depth = np.minimum(max_depth, 1.0 / disparity)
    d = np.stack([np.sin(phi) * np.cos(theta), np.cos(phi), np.sin(phi) * np.sin(theta)], axis=-1)
    return (depth[..., None] * d).reshape(-1, 3)


def apply_mask(vertexes: np.ndarray, faces: np.ndarray, vertex_mask: np.ndarray):
    """Drop masked vertices and the faces touching them, compacting indices
    (applyMaskToVertexesAndFaces, MeshUtil.h:345+)."""
    flat = vertex_mask.reshape(-1)
    if not flat.all():
        faces = faces[flat[faces[:, 0]] & flat[faces[:, 1]] & flat[faces[:, 2]]]
    used = np.zeros(len(vertexes), bool)
    used[faces.reshape(-1)] = True
    if used.all():  # full un-torn grid: identity remap, skip the gathers
        return vertexes, faces.astype(np.uint32)
    remap = -np.ones(len(vertexes), np.int64)
    remap[used] = np.arange(used.sum())
    return vertexes[used], remap[faces].astype(np.uint32)


def write_vtx_idx(path_vtx, path_idx, vertexes: np.ndarray, faces: np.ndarray) -> None:
    """Row-major float32 / uint32 blobs (writeDepth, MeshUtil.h:72-88)."""
    np.ascontiguousarray(vertexes, np.float32).tofile(path_vtx)
    np.ascontiguousarray(faces, np.uint32).tofile(path_idx)


def read_vtx(path) -> np.ndarray:
    return np.fromfile(path, np.float32).reshape(-1, 3)


def read_idx(path) -> np.ndarray:
    return np.fromfile(path, np.uint32).reshape(-1, 3)


def write_obj(path, vertexes: np.ndarray, faces: np.ndarray, mtl_path: str = "") -> None:
    """OBJ export (writeObj, MeshUtil.h:91-129; 1-based indices)."""
    with open(path, "w") as f:
        if mtl_path:
            f.write(f"mtllib {mtl_path}\n")
        for v in vertexes:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in faces + 1:
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")
