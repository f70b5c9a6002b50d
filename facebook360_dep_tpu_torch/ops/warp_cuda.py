"""The plane-sweep CUDA kernels, their ctypes wrappers and plain twins.

Port of ``facebook360_dep_tpu/ops/warp_pallas.py``'s main-path kernels:

==================  ==========================================  ================
wrapper             replaces (TPU kernel)                       source
==================  ==========================================  ================
``project_sample``  ``project_sample_planar_v4``                ``csrc/project_sample.cu``
``ssd_combine``     ``ssd_combine``                             ``csrc/ssd_combine.cu``
``cost_fused``      ``project_sample_packed`` + ``ssd_combine``  ``csrc/cost_fused.cu``
==================  ==========================================  ================

Each wrapper runs its kernel on CUDA tensors (or raises) and its plain
PyTorch twin on CPU tensors; there is no fallback from one to the other.
``LAUNCHES`` counts kernel launches only. The twins are the JAX package's
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

# kernel launches since the last reset_launch_counts()
LAUNCHES = {"project_sample": 0, "ssd_combine": 0, "cost_fused": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    where invalid. Returns sampled (N, C, H, W) and valid (N, H, W) bool."""
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
    """K3's twin: K1's twin followed by K2's twin."""
    sampled, valid = project_sample_plain(src_planar, params, dst_position, disparity, rays)
    return ssd_combine_plain(sampled, valid, dst_planar, variance, exclude_idx)


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


def _launch(kernel: str, fn, *args):
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {err}")
    LAUNCHES[kernel] += 1


def project_sample(src_planar, params, dst_position, disparity, rays):
    """K1: project every destination pixel at ``disparity`` into each source
    and sample it. src_planar (N, C, Hs, Ws) f32 (C in 1..3), params (N, 24),
    dst_position (3,), disparity (H, W), rays (3, H, W) -> sampled
    (N, C, H, W) (0 where invalid), valid (N, H, W) bool."""
    if not src_planar.is_cuda:
        return project_sample_plain(src_planar, params, dst_position, disparity, rays)

    n, c, hs, ws = src_planar.shape
    h, w = disparity.shape
    dev = src_planar.device
    if not 1 <= c <= 3:
        raise ValueError(f"project_sample: C={c}, expected 1..3")
    _check("src_planar", src_planar, dev, (n, c, hs, ws))
    _check("params", params, dev, (n, PARAM_SIZE))
    _check("dst_position", dst_position, dev, (3,))
    _check("disparity", disparity, dev, (h, w))
    _check("rays", rays, dev, (3, h, w))
    sampled = torch.empty((n, c, h, w), dtype=torch.float32, device=dev)
    valid = torch.empty((n, h, w), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        _launch("project_sample", _build.load().fdt_project_sample,
                src_planar.data_ptr(), n, c, hs, ws, params.data_ptr(), dst_position.data_ptr(),
                disparity.data_ptr(), rays.data_ptr(), h, w, sampled.data_ptr(), valid.data_ptr())
    return sampled, valid


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
        _launch("ssd_combine", _build.load().fdt_ssd_combine,
                sampled.data_ptr(), valid.data_ptr(), dst_planar.data_ptr(), variance.data_ptr(),
                n, c, h, w, int(exclude_idx), cost.data_ptr(), conf.data_ptr())
    return cost, conf


def cost_fused(src_planar, params, dst_position, disparity, rays, dst_planar, variance,
               exclude_idx: int):
    """K3: project_sample + ssd_combine in one kernel, samples kept on chip.
    src_planar (N, 3, Hs, Ws); the rest as for K1 and K2 -> cost,
    confidence (H, W)."""
    if not src_planar.is_cuda:
        return cost_fused_plain(src_planar, params, dst_position, disparity, rays, dst_planar,
                                variance, exclude_idx)

    n, c, hs, ws = src_planar.shape
    h, w = disparity.shape
    dev = src_planar.device
    _check("src_planar", src_planar, dev, (n, 3, hs, ws))
    _check("params", params, dev, (n, PARAM_SIZE))
    _check("dst_position", dst_position, dev, (3,))
    _check("disparity", disparity, dev, (h, w))
    _check("rays", rays, dev, (3, h, w))
    _check("dst_planar", dst_planar, dev, (3, h, w))
    _check("variance", variance, dev, (h, w))
    cost = torch.empty((h, w), dtype=torch.float32, device=dev)
    conf = torch.empty((h, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("cost_fused", _build.load().fdt_cost_fused,
                src_planar.data_ptr(), n, hs, ws, params.data_ptr(), dst_position.data_ptr(),
                disparity.data_ptr(), rays.data_ptr(), dst_planar.data_ptr(), variance.data_ptr(),
                h, w, int(exclude_idx), cost.data_ptr(), conf.data_ptr())
    return cost, conf
