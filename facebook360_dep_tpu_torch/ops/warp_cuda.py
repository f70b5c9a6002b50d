"""The CUDA sampling kernels, their ctypes wrappers and plain twins.

Port of ``facebook360_dep_tpu/ops/warp_pallas.py``'s kernels:

=========================  ==========================================  ==========================
wrapper                    replaces (TPU kernel)                       source
=========================  ==========================================  ==========================
``project_sample``         ``project_sample_planar_v4`` (colors)       ``csrc/project_sample.cu``
``project_sample_planes``  ``project_sample_planar_v4`` (1-2 planes)   ``csrc/project_sample.cu``
``ssd_combine``            ``ssd_combine``                             ``csrc/ssd_combine.cu``
``cost_fused``             ``project_sample_packed`` + ``ssd_combine``  ``csrc/cost_fused.cu``
``warp_sample_planar``     ``warp_sample_planar``                      ``csrc/warp_sample.cu``
=========================  ==========================================  ==========================

The first four carry the depth solve; ``warp_sample_planar`` carries the
render gather (``render/dibr.py::render_view``).

Each wrapper runs its kernel on CUDA tensors (or raises) and its plain
PyTorch twin on CPU tensors; there is no fallback from one to the other.
``LAUNCHES`` counts kernel launches only, and ``LAUNCHES_BY_SHAPE`` the
same launches by (kernel, H, W) of their output. The twins are the JAX package's
exact XLA path (f32 bilinear gathers: no source windows, no quantization, so
nothing is ever clipped) and are what the kernels are held against.
"""

from __future__ import annotations

import torch

from ..core import camera as cam
from . import _build
from . import cost as cost_ops
from . import sampling

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

# kernel launches since the last reset_launch_counts(), in all and by
# (kernel, H, W) of the output
LAUNCHES = {"project_sample": 0, "ssd_combine": 0, "cost_fused": 0, "warp_sample": 0}
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


def _project_sample(src, c, params, dst_position, disparity, rays):
    """K1's launch on a checked source stack of C channels (C = 3: the
    interleaved stack, else planes)."""
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
    with torch.cuda.device(dev):
        _launch("project_sample", (h, w), _build.load().fdt_project_sample,
                src.data_ptr(), n, c, hs, ws, params.data_ptr(), dst_position.data_ptr(),
                disparity.data_ptr(), rays.data_ptr(), d, h, w, sampled.data_ptr(), valid.data_ptr())
    return (sampled[0], valid[0]) if single else (sampled, valid)


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
