"""The CUDA sampling kernels, their ctypes wrappers and plain twins.

Port of ``facebook360_dep_tpu/ops/warp_pallas.py``'s kernels:

=============================  ==========================================  ==========================
wrapper                        replaces (TPU kernel)                       source
=============================  ==========================================  ==========================
``project_sample``             ``project_sample_planar_v4`` (colors)       ``csrc/project_sample.cu``
``project_sample_planes``      ``project_sample_planar_v4`` (1-2 planes)   ``csrc/project_sample.cu``
``ssd_combine``                ``ssd_combine``                             ``csrc/ssd_combine.cu``
``cost_fused``                 ``project_sample_packed`` + ``ssd_combine``  ``csrc/cost_fused.cu``
``warp_sample_planar``         ``warp_sample_planar``                      ``csrc/warp_sample.cu``
``tile_windows``               the window anchor of ``_make_project_kernel_v4``  ``csrc/tile_windows.cu``
``project_sample_tpu``         ``project_sample_planar_v4`` (colors)       ``csrc/project_sample.cu``
``project_sample_planes_tpu``  ``project_sample_planar_v4`` (1-2 planes)   ``csrc/project_sample.cu``
``cost_fused_tpu``             ``project_sample_packed`` + ``ssd_combine``  ``csrc/cost_fused.cu``
``joint_bilateral``            none (the XLA filter, ``ops/filters.py``)   ``csrc/joint_bilateral.cu``
``chamfer_labels``             none (cv2 on the host)                      ``csrc/chamfer.cu``
=============================  ==========================================  ==========================

The first four carry the depth solve; ``warp_sample_planar`` carries the
render gather (``render/dibr.py::render_view``); ``joint_bilateral`` filters
all of a level's disparity maps in one launch (the solver's bilateral
stage), where the JAX package runs ``filters.joint_bilateral``'s XLA ops a
map at a time; ``chamfer_labels`` labels every pixel of a level's maps with
its nearest valid pixel in one launch (the foreground pass's init between
levels), where the JAX package runs ``cv2.distanceTransformWithLabels`` on
its host.

Each wrapper runs its kernel on CUDA tensors (or raises) and its plain
PyTorch twin on CPU tensors; there is no fallback from one to the other.
``LAUNCHES`` counts kernel launches only, and ``LAUNCHES_BY_SHAPE`` the
same launches by (kernel, H, W) of their output. The twins of the first five
are the JAX package's exact XLA path (f32 bilinear gathers: no source
windows, no quantization, so nothing is ever clipped) and are what the
kernels are held against.

The last four are the TPU sampler's semantics, which the JAX package runs
on its own chip (``use_pallas_sampler=True``): each destination tile of
V4_TILE_H x TILE_W pixels samples each source through a window of
ww x wh source pixels anchored on the span of the tile's valid
coordinates (``tile_windows``); a visible pixel outside its tile's window
is *clipped*, local coordinates round to 1/256 px, and the packed path
(``cost_fused_tpu``, from 512x384) rounds its samples to 2^-24 (R) and
2^-16 (G, B) and makes a pixel's cost FLT_MAX where a non-self source
clips it. On sources quantized to k/256 (``cost.quantize_src``) every
product and sum of such a sample is exact in float32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..core import camera as cam
from . import _build
from . import cost as cost_ops
from . import filters, sampling

# packed per-source camera parameters (warp_pallas.py:269-300)
PARAM_POS = 0        # 3: position
PARAM_ROT = 3        # 9: rotation rows (right, up, backward)
PARAM_PRINCIPAL = 12 # 2
PARAM_FOCAL = 14     # 2
PARAM_DIST = 16      # 3: distortion
PARAM_DIST_MAX = 19  # 1
PARAM_COS_FOV = 20   # 1
PARAM_TYPE = 21      # 1: type code
PARAM_RES = 22       # 2: resolution (normalized rigs: 1, 1)
PARAM_SIZE = 24

# The TPU sampler's geometry (warp_pallas.py:55, 353-355): destination
# tiles of V4_TILE_H x TILE_W pixels, source windows of V4_WINDOW_W x
# V4_WINDOW_H pixels unless a window is given (cost.auto_window).
V4_TILE_H = 24
TILE_W = 128
V4_WINDOW_H = 40
V4_WINDOW_W = 256

# kernel launches since the last reset_launch_counts(), in all and by
# (kernel, H, W) of the output
LAUNCHES = {"project_sample": 0, "ssd_combine": 0, "cost_fused": 0, "warp_sample": 0,
            "tile_windows": 0, "project_sample_tpu": 0, "cost_fused_tpu": 0, "joint_bilateral": 0, "chamfer": 0}
LAUNCHES_BY_SHAPE: dict[tuple[str, int, int], int] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_SHAPE.clear()


def pack_camera_params(cams: cam.Camera) -> torch.Tensor:
    """Stacked cameras (N,) -> (N, PARAM_SIZE) float32 on the cameras' device."""
    n = cams.position.shape[0]
    cols = [
        cams.position, cams.rotation.reshape(n, 9), cams.principal, cams.focal,
        cams.distortion, cams.distortion_max[:, None], cams.cos_fov[:, None],
        cams.type_code[:, None], cams.resolution,
    ]
    return torch.cat([c.to(torch.float32) for c in cols], dim=1).contiguous()


def unpack_camera_params(params: torch.Tensor) -> cam.Camera:
    """Inverse of pack_camera_params (float32 fields)."""
    n = params.shape[0]
    return cam.Camera(
        type_code=params[:, PARAM_TYPE].round().to(torch.int32),
        position=params[:, PARAM_POS:PARAM_POS + 3],
        rotation=params[:, PARAM_ROT:PARAM_ROT + 9].reshape(n, 3, 3),
        resolution=params[:, PARAM_RES:PARAM_RES + 2],
        principal=params[:, PARAM_PRINCIPAL:PARAM_PRINCIPAL + 2],
        focal=params[:, PARAM_FOCAL:PARAM_FOCAL + 2],
        distortion=params[:, PARAM_DIST:PARAM_DIST + 3],
        distortion_max=params[:, PARAM_DIST_MAX],
        cos_fov=params[:, PARAM_COS_FOV],
    )


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------


def project_sample_plain(src_planar, params, dst_position, disparity, rays):
    """K1's twin: cost.reproject_rays + sampling.bilinear_sample, zeroed
    where invalid. One destination (dst_position (3,), disparity (H, W),
    rays (3, H, W)) -> sampled (N, C, H, W) and valid (N, H, W) bool; D of
    them ((D, 3), (D, H, W), (D, 3, H, W)) -> (D, N, C, H, W), (D, N, H, W),
    one destination at a time, so that a batch gives the bits of its
    destinations' single calls (the CPU's vectorized atan2 may differ from
    its scalar tail by an ulp, and where the tail falls depends on the
    tensor's size)."""
    if dst_position.ndim == 2:
        outs = [project_sample_plain(src_planar, params, *one) for one in zip(dst_position, disparity, rays)]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    n, c, hs, ws = src_planar.shape
    coords, valid = cost_ops.reproject_rays(
        dst_position, rays, unpack_camera_params(params), disparity, (hs, ws))
    sampled = torch.stack([
        sampling.bilinear_sample(src_planar[i].permute(1, 2, 0), coords[i]).permute(2, 0, 1)
        for i in range(n)
    ])
    return torch.where(valid[:, None], sampled, 0.0), valid


def ssd_combine_plain(sampled, valid, dst_planar, variance, exclude_idx: int):
    """K2's twin: cost.ssd_planar + cost.combine_top2 over the non-self sources."""
    biased, unbiased, v = cost_ops.ssd_planar(dst_planar.permute(1, 2, 0), sampled, valid)
    not_self = torch.arange(v.shape[0], device=v.device) != exclude_idx
    return cost_ops.combine_top2(biased, unbiased, v & not_self[:, None, None], variance)


def cost_fused_plain(src_planar, params, dst_position, disparity, rays, dst_planar, variance,
                     exclude_idx: int):
    """K3's twin: K1's twin followed by K2's twin, on the planar stack
    (of the interleaved one K3 reads, :func:`planar_view`)."""
    sampled, valid = project_sample_plain(src_planar, params, dst_position, disparity, rays)
    return ssd_combine_plain(sampled, valid, dst_planar, variance, exclude_idx)


def warp_sample_planar_plain(src_planar, coords):
    """K4's twin: sampling.bilinear_sample of each source at its coords.
    valid = finite coords; sampled is 0 where not valid and NaN where a tap
    of the source is NaN. Returns sampled (N, C, H, W), valid (N, H, W) bool."""
    valid = torch.isfinite(coords).all(dim=-1)
    sampled = torch.stack([
        sampling.bilinear_sample(src_planar[i].permute(1, 2, 0), coords[i]).permute(2, 0, 1)
        for i in range(src_planar.shape[0])
    ])
    return torch.where(valid[:, None], sampled, 0.0), valid


def joint_bilateral_plain(src_rgba, dst2src, disparity, mask, radius: int):
    """The joint bilateral kernel's twin: filters.joint_bilateral of each
    map, guided by its source's colors in the interleaved stack, one map
    at a time, stacked."""
    return torch.stack([filters.joint_bilateral(disparity[i], src_rgba[s, ..., :3], mask[i], radius)
                        for i, s in enumerate(dst2src)])


# OpenCV's chamfer distance with labels (imgproc/distransform.cpp,
# distanceTransformEx_5x5): whenever labels are asked for, DIST_L2 runs the
# 5x5 chamfer mask (1, 1.4, 2.1969) in 16.16 fixed point, whatever the mask
# size passed, in one forward and one backward raster pass.
DT_HV, DT_DIAG, DT_LONG = 65536, 91750, 143976  # cvRound(m * 2^16)
DT_INIT = (2**31 - 1) >> 2
# neighbors in OpenCV's order (dy, dx, cost); the in-row neighbor comes last
DT_FORWARD = ((-2, -1, DT_LONG), (-2, 1, DT_LONG), (-1, -2, DT_LONG), (-1, -1, DT_DIAG),
              (-1, 0, DT_HV), (-1, 1, DT_DIAG), (-1, 2, DT_LONG))
DT_BACKWARD = ((2, 1, DT_LONG), (2, -1, DT_LONG), (1, 2, DT_LONG), (1, 1, DT_DIAG),
               (1, 0, DT_HV), (1, -1, DT_DIAG), (1, -2, DT_LONG))


def _chamfer_row_plain(dist, label, y, neighbors, step):
    """Relax padded row ``y + 2`` of (B, H+4, W+4) int32 ``dist``/``label``
    in place, as ``depth/pipeline.py::_chamfer_row`` does in numpy: the
    finished rows' neighbors in OpenCV's order, each compare strict, then
    the in-row recurrence v[j] = min(a[j], v[j-1] + 1) (left to right when
    ``step`` is 1, right to left when -1) as a running minimum of
    a[k] - k, the label of j-1 taken only where a[j] is strictly larger."""
    w = dist.shape[2] - 4
    best = dist[:, y + 2, 2:-2]
    lab = label[:, y + 2, 2:-2]
    for dy, dx, c in neighbors:
        cand = dist[:, y + 2 + dy, 2 + dx:2 + dx + w] + c
        better = cand < best
        best = torch.where(better, cand, best)
        lab = torch.where(better, label[:, y + 2 + dy, 2 + dx:2 + dx + w], lab)
    a, lab = (best, lab) if step == 1 else (best.flip(1), lab.flip(1))
    ramp = torch.arange(w, dtype=torch.int32, device=dist.device)
    v = torch.cummin(a - ramp * DT_HV, dim=1).values + ramp * DT_HV
    from_prev = torch.zeros_like(a, dtype=torch.bool)
    from_prev[:, 1:] = a[:, 1:] > v[:, :-1] + DT_HV
    src = torch.cummax(torch.where(from_prev, 0, ramp), dim=1).values
    lab = torch.gather(lab, 1, src.long())
    dist[:, y + 2, 2:-2] = v if step == 1 else v.flip(1)
    label[:, y + 2, 2:-2] = lab if step == 1 else lab.flip(1)


def chamfer_labels_plain(valid):
    """The chamfer kernel's twin: ``depth/pipeline.py::_nearest_valid_index``
    in PyTorch, bit for bit. valid (B, H, W) bool -> (B, H, W) int32, each
    pixel's nearest valid pixel under OpenCV's chamfer labels as the flat
    index y * W + x, -1 in a map with no valid pixel. Runs where ``valid``
    lies."""
    b, h, w = valid.shape
    dev = valid.device
    # int32 holds every sum: INIT + 2.2 px and W px in 16.16 stay below 2^31
    dist = torch.full((b, h + 4, w + 4), DT_INIT, dtype=torch.int32, device=dev)
    label = torch.full_like(dist, -1)
    dist[:, 2:-2, 2:-2] = torch.where(valid, 0, DT_INIT)
    label[:, 2:-2, 2:-2] = torch.where(valid, torch.arange(h * w, dtype=torch.int32, device=dev).view(h, w), -1)
    for y in range(h):
        _chamfer_row_plain(dist, label, y, DT_FORWARD, 1)
    for y in range(h - 1, -1, -1):
        _chamfer_row_plain(dist, label, y, DT_BACKWARD, -1)
    return label[:, 2:-2, 2:-2].contiguous()


# ---------------------------------------------------------------------------
# Plain twins of the TPU sampler's semantics
# ---------------------------------------------------------------------------


def window_dims(src_hw, window=None, align: int = 8):
    """(ww, wh, hs_pad, ws_pad): the source window of the TPU sampler on an
    (Hs, Ws) source and the source's dims padded to the (align, 128) tiling
    (warp_pallas.py:938-952). ``window`` is (ww_max, wh_max), either None
    for its default; ``align`` is 8, or 16 for a stack that stands for a
    bf16 one (cost.SRC_STACK_BF16)."""
    hs, ws = src_hw
    ww_max, wh_max = window if window is not None else (None, None)
    ww_max = V4_WINDOW_W if ww_max is None else ww_max
    wh_max = V4_WINDOW_H if wh_max is None else wh_max
    hs_pad, ws_pad = -(-hs // align) * align, -(-ws // 128) * 128
    return min(ww_max, ws_pad), min(-(-min(wh_max, hs_pad) // align) * align, hs_pad), hs_pad, ws_pad


def tile_grid(n: int, tile: int, reflect: bool) -> torch.Tensor:
    """The image row (column) of each row of the grid padded up to a
    multiple of ``tile``: edge padding (warp_pallas.pad_to_tiles, the
    plain sampler's), or with ``reflect`` one reflect-101 row then edge
    (warp_pallas._reflect1_grid_pad, the packed path's)."""
    pad = (-n) % tile
    tail = ([max(n - 2, 0)] + [n - 1] * (pad - 1)) if (reflect and pad) else [n - 1] * pad
    return torch.tensor(list(range(n)) + tail, dtype=torch.long)


def _tpu_coords(params, dst_position, disparity, rays, src_hw):
    """One destination's sample coordinates in each source as the TPU
    sampler takes them: (xt, yt) = coords - 0.5 clamped to the source, and
    the validity; each (N, H, W)."""
    hs, ws = src_hw
    coords, valid = cost_ops.reproject_rays(dst_position, rays, unpack_camera_params(params), disparity, (hs, ws))
    xt = torch.where(valid, coords[..., 0] - 0.5, 0.0).clamp(0.0, ws - 1.0)
    yt = torch.where(valid, coords[..., 1] - 0.5, 0.0).clamp(0.0, hs - 1.0)
    return xt, yt, valid


def _anchors(xt, yt, ok, src_hw, window, align: int, reflect: bool) -> torch.Tensor:
    """(N, ceil(H/V4_TILE_H), ceil(W/TILE_W), 2) int32 window origins (x, y)
    of each destination tile: centred on the span of the tile's valid
    coordinates, aligned down to 128 in x and ``align`` in y, clamped to the
    padded source (warp_pallas.py:471-497); a tile no pixel of which the
    source sees gets (0, 0)."""
    ww, wh, hs_pad, ws_pad = window_dims(src_hw, window, align)
    n, h, w = xt.shape
    rows, cols = tile_grid(h, V4_TILE_H, reflect).to(xt.device), tile_grid(w, TILE_W, reflect).to(xt.device)
    nty, ntx = len(rows) // V4_TILE_H, len(cols) // TILE_W
    ok = ok[:, rows][:, :, cols]
    big = 1e9

    def tiles(a, fill):
        return torch.where(ok, a[:, rows][:, :, cols], fill).reshape(n, nty, V4_TILE_H, ntx, TILE_W)

    xmin, ymin = tiles(xt, big).amin(dim=(2, 4)), tiles(yt, big).amin(dim=(2, 4))
    xmax, ymax = tiles(xt, -big).amax(dim=(2, 4)), tiles(yt, -big).amax(dim=(2, 4))
    none = xmin >= big
    xa = torch.where(none, 0.0, 0.5 * (xmin + xmax) - (ww - 128) * 0.5).to(torch.int32)
    ya = torch.where(none, 0.0, 0.5 * (ymin + ymax) - (wh - align) * 0.5).to(torch.int32)
    ox = torch.div(xa, 128, rounding_mode="floor").clamp(0, max((ws_pad - ww) // 128, 0)) * 128
    oy = torch.div(ya, align, rounding_mode="floor").clamp(0, max((hs_pad - wh) // align, 0)) * align
    return torch.stack([ox, oy], dim=-1).to(torch.int32)


def tile_windows_plain(params, dst_position, disparity, rays, src_hw, window=None, align: int = 8,
                       reflect: bool = False):
    """The anchor kernel's twin: each destination tile's window origin in
    each source (:func:`_anchors`), the tiles laid over the grid padded as
    the plain sampler pads it, or as the packed path does with ``reflect``.
    One destination ((3,), (H, W), (3, H, W)) -> (N, nty, ntx, 2) int32; D
    of them -> (D, N, nty, ntx, 2)."""
    if dst_position.ndim == 2:
        return torch.stack([tile_windows_plain(params, *one, src_hw, window, align, reflect)
                            for one in zip(dst_position, disparity, rays)])
    xt, yt, ok = _tpu_coords(params, dst_position, disparity, rays, src_hw)
    return _anchors(xt, yt, ok, src_hw, window, align, reflect)


def _tpu_sample(src_planar, xt, yt, ok0, ox, oy, ww: int, wh: int):
    """Samples of the TPU sampler at (xt, yt) through windows at (ox, oy),
    all (N, ...): the window test, coordinates local to the window rounded
    to 1/256 px, then the bilinear lerp (clamp-to-edge taps, which is what
    the window's edge padding holds). Returns (sampled (N, C, ...) 0 where
    not valid, valid, clipped)."""
    n, c, hs, ws = src_planar.shape
    in_win = (xt >= ox) & (xt <= ox + (ww - 1.0)) & (yt >= oy) & (yt <= oy + (wh - 1.0))
    valid, clipped = ok0 & in_win, ok0 & ~in_win
    lx = torch.round((xt - ox).clamp(0.0, ww - 1.0) * 256.0) * (1.0 / 256.0)
    ly = torch.round((yt - oy).clamp(0.0, wh - 1.0) * 256.0) * (1.0 / 256.0)
    fx, fy = torch.floor(lx), torch.floor(ly)
    wx, wy = (lx - fx)[:, None], (ly - fy)[:, None]
    x0, y0 = ox.long() + fx.long(), oy.long() + fy.long()
    xa, xb = x0.clamp(0, ws - 1), (x0 + 1).clamp(0, ws - 1)
    ya, yb = y0.clamp(0, hs - 1), (y0 + 1).clamp(0, hs - 1)
    flat = src_planar.reshape(n, c, hs * ws)

    def take(yi, xi):
        idx = (yi * ws + xi).reshape(n, 1, -1).expand(n, c, -1)
        return torch.gather(flat, 2, idx).reshape((n, c) + tuple(xt.shape[1:]))

    top = take(ya, xa) * (1 - wx) + take(ya, xb) * wx
    bot = take(yb, xa) * (1 - wx) + take(yb, xb) * wx
    out = top * (1 - wy) + bot * wy
    return torch.where(valid[:, None], out, 0.0), valid, clipped


def project_sample_tpu_plain(src_planar, params, dst_position, disparity, rays, anchors, window=None,
                             align: int = 8):
    """K1's twin in TPU mode: :func:`project_sample_plain` through each
    tile's window (``anchors`` from :func:`tile_windows_plain`, plain
    padding). One destination -> sampled (N, C, H, W), valid, clipped (N,
    H, W) bool; D of them -> (D, N, ...), one destination at a time."""
    if dst_position.ndim == 2:
        outs = [project_sample_tpu_plain(src_planar, params, *one, window, align)
                for one in zip(dst_position, disparity, rays, anchors)]
        return tuple(torch.stack([o[i] for o in outs]) for i in range(3))
    hs, ws = src_planar.shape[2:]
    ww, wh, _, _ = window_dims((hs, ws), window, align)
    xt, yt, ok = _tpu_coords(params, dst_position, disparity, rays, (hs, ws))
    h, w = disparity.shape
    ty = (torch.arange(h, device=xt.device) // V4_TILE_H)[:, None]
    tx = (torch.arange(w, device=xt.device) // TILE_W)[None, :]
    org = anchors[:, ty, tx]  # (N, H, W, 2)
    return _tpu_sample(src_planar, xt, yt, ok, org[..., 0], org[..., 1], ww, wh)


def packed_round(sampled: torch.Tensor) -> torch.Tensor:
    """The packed path's sample rounding (warp_pallas.py:625-636), colors on
    axis 1: R to 2^-24, G and B clamped to [0, 1] then to 2^-16 with 65535
    the top code; the power-of-two scales are exact."""
    r = torch.round(sampled[:, :1].clamp(min=0.0) * 16777216.0) * (1.0 / 16777216.0)
    gb = torch.minimum(torch.round(sampled[:, 1:].clamp(0.0, 1.0) * 65536.0), torch.tensor(65535.0)) * (1.0 / 65536.0)
    return torch.cat([r, gb], dim=1)


def _ring(n: int, tile: int):
    """For the rows -1 .. n of an image with its one-pixel ring: the
    reflect-101 image row each takes its inputs from, and the tile of the
    packed path that writes it (warp_pallas.py:571-753: the bulk of the
    tile holding the reflect-padded row, or a sliver of the tile holding
    the reflected one; either way the tile of the row clamped into the
    image)."""
    r = torch.arange(-1, n + 1)
    src = torch.where(r < 0, -r, torch.where(r >= n, 2 * (n - 1) - r, r)).clamp(0, n - 1)
    return src, r.clamp(0, n - 1) // tile


def ring_samples_tpu_plain(src_planar, params, dst_position, disparity, rays, anchors, window=None,
                           align: int = 8):
    """What the packed path (project_sample_packed) lays down for one
    destination: every pixel and the one-pixel reflect-101 ring around the
    image, each sampled through the window of the tile the packed path
    writes it from (``anchors`` from :func:`tile_windows_plain` with
    ``reflect``) and rounded as :func:`packed_round`. Returns sampled (N,
    3, H + 2, W + 2), valid and clipped (N, H + 2, W + 2)."""
    hs, ws = src_planar.shape[2:]
    h, w = disparity.shape
    ww, wh, _, _ = window_dims((hs, ws), window, align)
    xt, yt, ok = _tpu_coords(params, dst_position, disparity, rays, (hs, ws))
    (ry, ty), (rx, tx) = _ring(h, V4_TILE_H), _ring(w, TILE_W)
    dev = xt.device
    ry, ty, rx, tx = ry.to(dev)[:, None], ty.to(dev)[:, None], rx.to(dev)[None, :], tx.to(dev)[None, :]
    org = anchors[:, ty, tx]  # (N, H + 2, W + 2, 2)
    sampled, valid, clipped = _tpu_sample(src_planar, xt[:, ry, rx], yt[:, ry, rx], ok[:, ry, rx],
                                          org[..., 0], org[..., 1], ww, wh)
    return packed_round(sampled), valid, clipped


def cost_fused_tpu_plain(src_planar, params, dst_position, disparity, rays, dst_planar, variance,
                         exclude_idx: int, anchors, window=None, align: int = 8):
    """K3's twin in TPU mode, the packed path (project_sample_packed +
    ssd_combine(true_shape=)): the patch SSDs and the drop-two-worst
    combine of :func:`ssd_combine_plain` over :func:`ring_samples_tpu_plain`
    (the destination's colors reflected into the ring), and FLT_MAX where a
    non-self source clips the pixel itself."""
    sampled, valid, clipped = ring_samples_tpu_plain(src_planar, params, dst_position, disparity, rays, anchors,
                                                     window, align)
    n = sampled.shape[0]
    biased, unbiased, v = cost_ops.ssd_ringed(F.pad(dst_planar, (1, 1, 1, 1), mode="reflect"), sampled, valid)
    not_self = torch.arange(n, device=sampled.device) != exclude_idx
    cost, conf = cost_ops.combine_top2(biased, unbiased, v & not_self[:, None, None], variance)
    any_clip = (clipped[:, 1:-1, 1:-1] & not_self[:, None, None]).any(dim=0)
    return torch.where(any_clip, cost_ops.FLT_MAX, cost), conf


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, device, shape, dtype=torch.float32):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _launch(kernel: str, hw: tuple[int, int], fn, *args):
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {err}")
    LAUNCHES[kernel] += 1
    key = (kernel, *hw)
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1


def project_sample(src_rgba, params, dst_position, disparity, rays):
    """K1 on the colors: project every pixel of D destination maps at
    ``disparity`` into each source and sample its three colors there, one
    launch for all D maps.

    src_rgba (N, Hs, Ws, 4) the interleaved source stack (:func:`rgba_stack`,
    one 16-byte load a tap); params (N, 24); dst_position (D, 3), disparity
    (D, H, W), rays (D, 3, H, W) -> sampled (D, N, 3, H, W) (0 where
    invalid), valid (D, N, H, W) bool. With dst_position (3,), disparity
    (H, W) and rays (3, H, W) it is one destination (D = 1) and returns
    (N, 3, H, W), (N, H, W)."""
    if not src_rgba.is_cuda:
        return project_sample_plain(planar_view(src_rgba), params, dst_position, disparity, rays)
    n, hs, ws, _ = src_rgba.shape
    _check("src_rgba", src_rgba, src_rgba.device, (n, hs, ws, 4))
    return _project_sample(src_rgba, 3, params, dst_position, disparity, rays)


def project_sample_planes(src_planar, params, dst_position, disparity, rays):
    """K1 on one or two channel planes, src_planar (N, C, Hs, Ws) f32, C in
    1..2 (the mismatch stage samples the cameras' disparity maps, C = 1);
    the rest and the results as for :func:`project_sample`, with C
    channels."""
    if not src_planar.is_cuda:
        return project_sample_plain(src_planar, params, dst_position, disparity, rays)
    n, c, hs, ws = src_planar.shape
    if not 1 <= c <= 2:
        raise ValueError(f"project_sample_planes: C={c}, expected 1..2 (colors: project_sample)")
    _check("src_planar", src_planar, src_planar.device, (n, c, hs, ws))
    return _project_sample(src_planar, c, params, dst_position, disparity, rays)


def _project_sample(src, c, params, dst_position, disparity, rays, tpu=None):
    """K1's launch on a checked source stack of C channels (C = 3: the
    interleaved stack, else planes); ``tpu`` = (anchors, window, align)
    launches its TPU mode, which adds the clipped flags."""
    single = dst_position.ndim == 1
    if single:
        dst_position, disparity, rays = dst_position[None], disparity[None], rays[None]
    n = src.shape[0]
    hs, ws = src.shape[1:3] if c == 3 else src.shape[2:]
    d = dst_position.shape[0]
    h, w = disparity.shape[-2:]
    dev = src.device
    _check("params", params, dev, (n, PARAM_SIZE))
    _check("dst_position", dst_position, dev, (d, 3))
    _check("disparity", disparity, dev, (d, h, w))
    _check("rays", rays, dev, (d, 3, h, w))
    sampled = torch.empty((d, n, c, h, w), dtype=torch.float32, device=dev)
    valid = torch.empty((d, n, h, w), dtype=torch.bool, device=dev)
    if tpu is None:
        with torch.cuda.device(dev):
            _launch("project_sample", (h, w), _build.load().fdt_project_sample,
                    src.data_ptr(), n, c, hs, ws, params.data_ptr(), dst_position.data_ptr(),
                    disparity.data_ptr(), rays.data_ptr(), d, h, w, sampled.data_ptr(), valid.data_ptr())
        return (sampled[0], valid[0]) if single else (sampled, valid)
    anchors, window, align = tpu
    if single:
        anchors = anchors[None]
    _check("anchors", anchors, dev, (d, n, -(-h // V4_TILE_H), -(-w // TILE_W), 2), torch.int32)
    ww, wh, _, _ = window_dims((hs, ws), window, align)
    clipped = torch.empty((d, n, h, w), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        _launch("project_sample_tpu", (h, w), _build.load().fdt_project_sample_tpu,
                src.data_ptr(), n, c, hs, ws, params.data_ptr(), dst_position.data_ptr(),
                disparity.data_ptr(), rays.data_ptr(), d, h, w, anchors.data_ptr(), ww, wh,
                sampled.data_ptr(), valid.data_ptr(), clipped.data_ptr())
    return (sampled[0], valid[0], clipped[0]) if single else (sampled, valid, clipped)


def ssd_combine(sampled, valid, dst_planar, variance, exclude_idx: int):
    """K2: patch SSDs + drop-2-worst combine. sampled (N, C, H, W), valid
    (N, H, W) bool, dst_planar (C, H, W), variance (H, W), exclude_idx the
    destination's own source index -> cost, confidence (H, W)."""
    if not sampled.is_cuda:
        return ssd_combine_plain(sampled, valid, dst_planar, variance, exclude_idx)

    n, c, h, w = sampled.shape
    dev = sampled.device
    if not 1 <= c <= 3:
        raise ValueError(f"ssd_combine: C={c}, expected 1..3")
    _check("sampled", sampled, dev, (n, c, h, w))
    _check("valid", valid, dev, (n, h, w), torch.bool)
    _check("dst_planar", dst_planar, dev, (c, h, w))
    _check("variance", variance, dev, (h, w))
    cost = torch.empty((h, w), dtype=torch.float32, device=dev)
    conf = torch.empty((h, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("ssd_combine", (h, w), _build.load().fdt_ssd_combine,
                sampled.data_ptr(), valid.data_ptr(), dst_planar.data_ptr(), variance.data_ptr(),
                n, c, h, w, int(exclude_idx), cost.data_ptr(), conf.data_ptr())
    return cost, conf


def rgba_stack(imgs: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C >= 3) colors -> the (N, H, W, 4) float32 stack K1
    (:func:`project_sample`) and K3 read: RGB and a zero pad, so each
    bilinear tap is one 16-byte load."""
    return torch.nn.functional.pad(imgs[..., :3].to(torch.float32), (0, 1)).contiguous()


def planar_view(src_rgba: torch.Tensor) -> torch.Tensor:
    """The (N, 3, H, W) channel-planar view of an :func:`rgba_stack`, no
    copy (not contiguous): what the twins read."""
    return src_rgba[..., :3].permute(0, 3, 1, 2)


def cost_fused(src_rgba, params, dst_position, disparity, rays, dst_planar, variance,
               exclude_idx: int):
    """K3: project_sample + ssd_combine in one kernel, samples kept on chip.
    src_rgba (N, Hs, Ws, 4) the interleaved source stack (:func:`rgba_stack`);
    the rest as for K1 and K2 -> cost, confidence (H, W)."""
    if not src_rgba.is_cuda:
        return cost_fused_plain(planar_view(src_rgba), params, dst_position, disparity, rays,
                                dst_planar, variance, exclude_idx)

    n, hs, ws, _ = src_rgba.shape
    h, w = disparity.shape
    dev = src_rgba.device
    _check("src_rgba", src_rgba, dev, (n, hs, ws, 4))
    _check("params", params, dev, (n, PARAM_SIZE))
    _check("dst_position", dst_position, dev, (3,))
    _check("disparity", disparity, dev, (h, w))
    _check("rays", rays, dev, (3, h, w))
    _check("dst_planar", dst_planar, dev, (3, h, w))
    _check("variance", variance, dev, (h, w))
    cost = torch.empty((h, w), dtype=torch.float32, device=dev)
    conf = torch.empty((h, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("cost_fused", (h, w), _build.load().fdt_cost_fused,
                src_rgba.data_ptr(), n, hs, ws, params.data_ptr(), dst_position.data_ptr(),
                disparity.data_ptr(), rays.data_ptr(), dst_planar.data_ptr(), variance.data_ptr(),
                h, w, int(exclude_idx), cost.data_ptr(), conf.data_ptr())
    return cost, conf


def tile_windows(params, dst_position, disparity, rays, src_hw, window=None, align: int = 8,
                 reflect: bool = False):
    """The TPU sampler's window origin (x, y) of every destination tile in
    every source, one launch for D maps: the span-centred, aligned, clamped
    anchor of :func:`tile_windows_plain`, from the same projection K1 and
    K3 run (common.cuh). params (N, 24); dst_position (D, 3), disparity
    (D, H, W), rays (D, 3, H, W) -> (D, N, ceil(H/24), ceil(W/128), 2)
    int32; one destination ((3,), (H, W), (3, H, W)) -> (N, ...). The tiles
    lie on the grid padded as the plain sampler pads it, or with
    ``reflect`` as the packed path does (K3's)."""
    if not params.is_cuda:
        return tile_windows_plain(params, dst_position, disparity, rays, src_hw, window, align, reflect)
    single = dst_position.ndim == 1
    if single:
        dst_position, disparity, rays = dst_position[None], disparity[None], rays[None]
    n, d = params.shape[0], dst_position.shape[0]
    h, w = disparity.shape[-2:]
    dev = params.device
    _check("params", params, dev, (n, PARAM_SIZE))
    _check("dst_position", dst_position, dev, (d, 3))
    _check("disparity", disparity, dev, (d, h, w))
    _check("rays", rays, dev, (d, 3, h, w))
    ww, wh, hs_pad, ws_pad = window_dims(src_hw, window, align)
    nty, ntx = -(-h // V4_TILE_H), -(-w // TILE_W)
    anchors = torch.empty((d, n, nty, ntx, 2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("tile_windows", (h, w), _build.load().fdt_tile_windows,
                params.data_ptr(), n, src_hw[0], src_hw[1], dst_position.data_ptr(), disparity.data_ptr(),
                rays.data_ptr(), d, h, w, ww, wh, align, hs_pad, ws_pad, int(reflect), anchors.data_ptr())
    return anchors[0] if single else anchors


def project_sample_tpu(src_rgba, params, dst_position, disparity, rays, anchors, window=None, align: int = 8):
    """K1 in TPU mode on the colors: :func:`project_sample` through each
    tile's window (``anchors`` from :func:`tile_windows`, plain padding),
    coordinates rounded to 1/256 px, from the TPU sampler's stack
    (:func:`rgba_stack` of quantized colors). Returns sampled (D, N, 3, H,
    W), valid and clipped (D, N, H, W) bool (one destination: without D)."""
    if not src_rgba.is_cuda:
        return project_sample_tpu_plain(planar_view(src_rgba), params, dst_position, disparity, rays, anchors,
                                        window, align)
    n, hs, ws, _ = src_rgba.shape
    _check("src_rgba", src_rgba, src_rgba.device, (n, hs, ws, 4))
    return _project_sample(src_rgba, 3, params, dst_position, disparity, rays, (anchors, window, align))


def project_sample_planes_tpu(src_planar, params, dst_position, disparity, rays, anchors, window=None,
                              align: int = 8):
    """K1 in TPU mode on one or two planes (the mismatch stage's NaN-filled
    disparities and finite mask, C = 2); as :func:`project_sample_tpu`."""
    if not src_planar.is_cuda:
        return project_sample_tpu_plain(src_planar, params, dst_position, disparity, rays, anchors, window, align)
    n, c, hs, ws = src_planar.shape
    if not 1 <= c <= 2:
        raise ValueError(f"project_sample_planes_tpu: C={c}, expected 1..2 (colors: project_sample_tpu)")
    _check("src_planar", src_planar, src_planar.device, (n, c, hs, ws))
    return _project_sample(src_planar, c, params, dst_position, disparity, rays, (anchors, window, align))


def cost_fused_tpu(src_rgba, params, dst_position, disparity, rays, dst_planar, variance, exclude_idx: int,
                   anchors, window=None, align: int = 8):
    """K3 in TPU mode, the packed path: :func:`cost_fused` with every cell,
    the reflect ring included, sampled through the window of the tile the
    packed path writes it from (``anchors`` from :func:`tile_windows` with
    ``reflect``), the samples rounded as :func:`packed_round`, and FLT_MAX
    where a non-self source clips the pixel. One destination -> cost,
    confidence (H, W)."""
    if not src_rgba.is_cuda:
        return cost_fused_tpu_plain(planar_view(src_rgba), params, dst_position, disparity, rays, dst_planar,
                                    variance, exclude_idx, anchors, window, align)
    n, hs, ws, _ = src_rgba.shape
    h, w = disparity.shape
    dev = src_rgba.device
    _check("src_rgba", src_rgba, dev, (n, hs, ws, 4))
    _check("params", params, dev, (n, PARAM_SIZE))
    _check("dst_position", dst_position, dev, (3,))
    _check("disparity", disparity, dev, (h, w))
    _check("rays", rays, dev, (3, h, w))
    _check("dst_planar", dst_planar, dev, (3, h, w))
    _check("variance", variance, dev, (h, w))
    _check("anchors", anchors, dev, (n, -(-h // V4_TILE_H), -(-w // TILE_W), 2), torch.int32)
    ww, wh, _, _ = window_dims((hs, ws), window, align)
    cost = torch.empty((h, w), dtype=torch.float32, device=dev)
    conf = torch.empty((h, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("cost_fused_tpu", (h, w), _build.load().fdt_cost_fused_tpu,
                src_rgba.data_ptr(), n, hs, ws, params.data_ptr(), dst_position.data_ptr(),
                disparity.data_ptr(), rays.data_ptr(), dst_planar.data_ptr(), variance.data_ptr(),
                h, w, int(exclude_idx), anchors.data_ptr(), ww, wh, cost.data_ptr(), conf.data_ptr())
    return cost, conf


# the most maps a joint_bilateral launch takes (csrc/joint_bilateral.cu:
# their sources' indices travel by value)
JB_MAX_MAPS = 512


def joint_bilateral(src_rgba, dst2src, disparity, mask, radius: int):
    """The color-guided joint bilateral (filters.joint_bilateral) of D
    disparity maps in one launch, each guided by its source's colors,
    read in place from the interleaved stack.

    src_rgba (N, H, W, 4) (:func:`rgba_stack`); dst2src D ints, each map's
    source; disparity (D, H, W) f32; mask (D, H, W) bool, the pixels that
    are filtered and that weigh (the others pass through); radius 1..5 ->
    (D, H, W) f32, the bits of :func:`joint_bilateral_plain`. D is at most
    JB_MAX_MAPS."""
    n, h, w = src_rgba.shape[:3]
    d = len(dst2src)
    dev = src_rgba.device
    _check("src_rgba", src_rgba, dev, (n, h, w, 4))
    _check("disparity", disparity, dev, (d, h, w))
    _check("mask", mask, dev, (d, h, w), torch.bool)
    if not filters.BILATERAL_SPACE_RADIUS_MIN <= radius <= filters.BILATERAL_SPACE_RADIUS_MAX:
        raise ValueError(f"joint_bilateral: radius {radius}, expected 1..5")
    if not all(0 <= s < n for s in dst2src):
        raise ValueError(f"joint_bilateral: dst2src {tuple(dst2src)} outside the {n} sources")
    if not 1 <= d <= JB_MAX_MAPS:
        raise ValueError(f"joint_bilateral: {d} maps, expected 1..{JB_MAX_MAPS}")
    if not src_rgba.is_cuda:
        return joint_bilateral_plain(src_rgba, dst2src, disparity, mask, radius)
    out = torch.empty_like(disparity)
    with torch.cuda.device(dev):
        _launch("joint_bilateral", (h, w), _build.load().fdt_joint_bilateral,
                src_rgba.data_ptr(), n, h, w, (ctypes.c_int * d)(*(int(s) for s in dst2src)), d,
                disparity.data_ptr(), mask.data_ptr(), int(radius), out.data_ptr())
    return out


# the widest map the chamfer kernel takes (csrc/chamfer.cu: 16 pixels a
# thread, 256 threads a row)
CHAMFER_MAX_WIDTH = 4096


def chamfer_labels(valid):
    """Each pixel's nearest valid pixel under OpenCV's chamfer labels, for
    a stack of maps in one launch (:func:`chamfer_labels_plain`'s bits).

    valid (B, H, W) bool, W at most CHAMFER_MAX_WIDTH -> (B, H, W) int32,
    the flat index y * W + x of the nearest valid pixel, -1 in a map with no
    valid pixel. On a CUDA tensor the kernel runs; on a CPU tensor the twin."""
    if valid.ndim != 3:
        raise ValueError(f"chamfer_labels: valid of shape {tuple(valid.shape)}, expected (B, H, W)")
    b, h, w = valid.shape
    if valid.device.type not in ("cpu", "cuda"):
        raise ValueError(f"chamfer_labels: valid on {valid.device}, expected a CPU or CUDA tensor")
    _check("valid", valid, valid.device, (b, h, w), torch.bool)
    if min(b, h, w) < 1 or w > CHAMFER_MAX_WIDTH or h * w >= 2**31:
        raise ValueError(f"chamfer_labels: valid of shape {(b, h, w)}, expected B, H >= 1, 1 <= W <= "
                         f"{CHAMFER_MAX_WIDTH} and H * W < 2^31")
    if not valid.is_cuda:
        return chamfer_labels_plain(valid)
    dist = torch.empty(valid.shape, dtype=torch.int32, device=valid.device)
    label = torch.empty_like(dist)
    with torch.cuda.device(valid.device):
        _launch("chamfer", (h, w), _build.load().fdt_chamfer_labels,
                valid.data_ptr(), b, h, w, dist.data_ptr(), label.data_ptr())
    return label


def warp_sample_planar(src_planar, coords):
    """K4: multi-source bilinear sampling at caller-given coords, one launch.
    src_planar (N, C, Hs, Ws) f32 (C in 1..4), coords (N, H, W, 2) f32 as
    (x, y) pixel-center coords -> sampled (N, C, H, W) (0 where not valid),
    valid (N, H, W) bool (finite coords)."""
    if not src_planar.is_cuda:
        return warp_sample_planar_plain(src_planar, coords)

    n, c, hs, ws = src_planar.shape
    h, w = coords.shape[1:3]
    dev = src_planar.device
    if not 1 <= c <= 4:
        raise ValueError(f"warp_sample_planar: C={c}, expected 1..4")
    _check("src_planar", src_planar, dev, (n, c, hs, ws))
    _check("coords", coords, dev, (n, h, w, 2))
    sampled = torch.empty((n, c, h, w), dtype=torch.float32, device=dev)
    valid = torch.empty((n, h, w), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        _launch("warp_sample", (h, w), _build.load().fdt_warp_sample,
                src_planar.data_ptr(), n, c, hs, ws, coords.data_ptr(), h, w,
                sampled.data_ptr(), valid.data_ptr())
    return sampled, valid


def warp_sample_multi(src_imgs_t, coords):
    """Multi-source sampling from the (N, C, H, W) planar stack (K4)."""
    return warp_sample_planar(src_imgs_t, coords)


def warp_sample(src_img, coords):
    """Single-source convenience wrapper over any (H, W): an (Hs, Ws, C) or
    (Hs, Ws) image and (H, W, 2) coords -> interleaved (H, W, C) samples and
    valid (H, W) bool (K4 on CUDA tensors)."""
    if src_img.ndim == 2:
        src_img = src_img[..., None]
    out, valid = warp_sample_planar(src_img.permute(2, 0, 1)[None].contiguous(), coords[None].contiguous())
    return out[0].permute(1, 2, 0), valid[0]
