"""Multi-GPU depth estimation: the port of the JAX package's
``parallel/sharding.py`` on ``torch.distributed``.

The reference scales with an embarrassingly parallel farm over (stage,
frame chunk) jobs (``scripts/render/pipeline.py:173-248``). Here the axes
map to a mesh of ranks, one process each:

- **cameras**: each rank of the ``"cam"`` axis solves a contiguous block of
  the destination cameras; the only cross-camera exchange is the disparity
  all-gather that feeds the mismatch stage (Derp.cpp:553-748);
- **frames**: the ``"frame"`` axis lays frames over ranks, with no
  collective.

Every rank holds every source image, as every worker of the reference
loads the whole rig's imagery, and only its own block of the destination
fields (``make_level_context(destinations=)``). The level body is
:func:`..depth.solver.process_level`, given a ``gather`` for the mismatch
stage. The random proposals' draws depend on the level and the destination
only, never on the mesh, so a sharded solve equals ``process_level`` on
one process bit for bit.

The meshes are ``torch.distributed.device_mesh.DeviceMesh`` objects over
the initialized process group (:mod:`.multihost`), with the device type
of what their collectives move: ``cuda`` under NCCL, ``cpu`` under gloo,
whose collectives go through host memory (:func:`all_gather` stages the
tensors there itself). So ranks that share one card, which NCCL refuses,
form a mesh through gloo.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..depth import solver

MAPS = ("disparity", "cost", "confidence", "mismatches")


def _mesh_device_type() -> str:
    """What a mesh's collectives move: device tensors under NCCL, host
    tensors under gloo."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def camera_mesh(axis_name: str = "cam") -> DeviceMesh:
    """A 1-D mesh over every rank of the process group."""
    return init_device_mesh(_mesh_device_type(), (dist.get_world_size(),), mesh_dim_names=(axis_name,))


def frame_camera_mesh(frame_axis: int = 2) -> DeviceMesh:
    """A 2-D ``("frame", "cam")`` mesh: data-parallel frames (the reference
    farm's frame chunks, pipeline.py:173-248) by destination cameras."""
    n = dist.get_world_size()
    if n % frame_axis:
        raise ValueError(f"{n} ranks do not split into {frame_axis} frame groups")
    return init_device_mesh(_mesh_device_type(), (frame_axis, n // frame_axis), mesh_dim_names=("frame", "cam"))


def block(n: int, mesh: DeviceMesh, axis: str) -> range:
    """The contiguous block of ``n`` items (destinations, frames) that this
    rank holds along ``axis``."""
    size, rank = mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)
    if n % size:
        raise ValueError(f"{n} items along {axis!r} not divisible by its {size} ranks")
    k = n // size
    return range(rank * k, (rank + 1) * k)


def all_gather(tensor: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Every rank's ``tensor`` along ``axis``, concatenated in rank order on
    the tensor's device. Under gloo the tensors go through host memory
    (staged here); bool tensors travel as uint8."""
    group = mesh.get_group(axis)
    send = tensor.to(torch.uint8) if tensor.dtype == torch.bool else tensor
    if dist.get_backend(group) == "gloo":
        send = send.cpu()
    send = send.contiguous()
    parts = [torch.empty_like(send) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, send, group=group)
    return torch.cat(parts).to(device=tensor.device, dtype=tensor.dtype)


def disparity_gather(dst2src, mesh: DeviceMesh, axis: str = "cam"):
    """``process_level``'s ``gather`` for a rank of a destination-sharded
    solve: the ranks' disparity blocks (rank order is destination order)
    put in source order through ``dst2src``, the whole level's map of
    destinations to sources."""
    dst2src = list(dst2src)

    def gather(local: torch.Tensor) -> torch.Tensor:
        if sorted(dst2src) != list(range(len(dst2src))):
            raise ValueError("the mismatch stage needs every source camera as a destination")
        return all_gather(local, mesh, axis)[[dst2src.index(s) for s in range(len(dst2src))]]

    return gather


def process_level_sharded(ctx: solver.LevelContext, cfg: solver.SolverConfig, mesh: DeviceMesh,
                          init_disparity=None, uniforms=None, generator=None):
    """``process_level`` with the destination cameras sharded over the
    mesh's ``"cam"`` axis.

    This rank solves the destinations ``block(D, mesh, "cam")``. ``ctx`` is
    its block of the level (``make_level_context(..., destinations=that
    block)``), so the rank never holds another rank's destination fields;
    the whole level's context is taken too, and its block selected from it.
    ``init_disparity`` holds the rank's own (D / ranks, H, W) maps, as the
    previous level returned them; ``uniforms`` is the whole level's (D, P,
    H, W) draws, of which it uses its block. Without them the draws come
    from ``generator`` (default: :func:`..depth.solver.level_generator`),
    one destination at a time in destination order, keeping the block's
    only (``draw_uniforms(keep=)``), so they do not depend on the mesh.
    Returns this rank's (D / ranks, H, W) maps and ``"destinations"``, the
    indices it holds. D not divisible by the ranks raises.
    """
    held, level_dst2src = solver.level_destinations(ctx)
    dsts = block(len(level_dst2src), mesh, "cam")
    if held == tuple(range(len(level_dst2src))) and len(held) != len(dsts):
        ctx = solver.select_destinations(ctx, dsts)
    elif held != tuple(dsts):
        raise ValueError(f"the context holds destinations {held}, this rank solves {tuple(dsts)}")
    h, w = ctx.src_imgs.shape[1:3]
    coarsest = cfg.level == cfg.num_levels - 1
    if uniforms is not None:
        uniforms = uniforms[dsts.start:dsts.stop]
    elif not coarsest and cfg.num_random_proposals > 0:
        if generator is None:
            generator = solver.level_generator(cfg, ctx.src_imgs.device)
        uniforms = solver.draw_uniforms(generator, len(level_dst2src), cfg.num_random_proposals, h, w, keep=dsts)
    out = solver.process_level(ctx, cfg, init_disparity=init_disparity, uniforms=uniforms,
                               gather=disparity_gather(level_dst2src, mesh))
    return dict(out, destinations=tuple(dsts))


def process_frames_sharded(base_ctx: solver.LevelContext, frame_imgs, cfg: solver.SolverConfig,
                           mesh: DeviceMesh, init_disparity=None, uniforms=None):
    """Frames over the mesh's ``"frame"`` axis, each frame's destinations
    over its ``"cam"`` axis as in :func:`process_level_sharded`.

    ``frame_imgs`` (F, N, H, W, 3) are every frame's colors; ``base_ctx``
    gives the cameras and masks (this rank's block of the ``"cam"`` axis,
    or the whole level), and each frame's context replaces every field that
    depends on the colors, the TPU sampler's stack included where the base
    has one (:func:`..depth.solver.with_images`: the destinations' only for
    those the base holds). ``init_disparity`` holds this rank's (F / frame
    ranks, D / cam ranks, H, W) maps; ``uniforms`` is every frame's (F, D,
    P, H, W) draws. Without them each frame draws from
    :func:`..depth.solver.level_generator`, as ``DepthEstimator`` solves
    each frame, so a frame's maps equal ``process_level`` on its own
    context. Returns this rank's (F / frame ranks, D / cam ranks, H, W)
    maps, ``"frames"`` and ``"destinations"``.
    """
    frames = block(len(frame_imgs), mesh, "frame")
    outs = []
    for i, f in enumerate(frames):
        outs.append(process_level_sharded(
            solver.with_images(base_ctx, torch.as_tensor(frame_imgs[f])), cfg, mesh,
            init_disparity=None if init_disparity is None else init_disparity[i],
            uniforms=None if uniforms is None else uniforms[f]))
    result = {k: torch.stack([o[k] for o in outs]) for k in MAPS}
    return dict(result, frames=tuple(frames), destinations=outs[0]["destinations"])


def gather_result(out: dict, mesh: DeviceMesh) -> dict:
    """The whole result of a sharded solve on every rank: each map gathered
    over the mesh's axes in order, last axis first ((D, H, W) stacks from
    :func:`process_level_sharded` on a ``("cam",)`` mesh, (F, D, H, W) from
    :func:`process_frames_sharded` on a ``("frame", "cam")`` mesh)."""
    names = mesh.mesh_dim_names
    full = {}
    for k in MAPS:
        v = out[k]
        if v.dim() != len(names) + 2:
            raise ValueError(f"{k} {tuple(v.shape)}: not a result sharded over {names}")
        for dim in reversed(range(len(names))):
            v = all_gather(v.movedim(dim, 0), mesh, names[dim]).movedim(0, dim)
        full[k] = v
    return full
