"""Multi-process initialization: the port of the JAX package's
``parallel/multihost.py`` on ``torch.distributed``.

The reference spans hosts with a RabbitMQ farm of independent processes
(``scripts/render/worker.py:532-556``). Work that must share one solve
across cards (destinations sharded over the ranks, with the disparity
all-gather of the mismatch stage) runs one process a card: every process
runs the same program and joins one process group through a TCP
rendezvous at the coordinator's address.

Enabled per CLI with ``--coordinator_address host:port --num_processes N
--process_id i``; ``-1`` takes the value from the environment
(``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them). Rank 0 serves the
rendezvous at the coordinator's address; under ``torchrun`` its agent
serves it, at ``$MASTER_ADDR:$MASTER_PORT``. Without a coordinator
nothing is initialized and the single-process path is unchanged.

Backends: NCCL needs one card a rank; several ranks on one card (or ranks
on the CPU) take gloo, whose collectives go through host memory.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch
import torch.distributed as dist

from .. import default_device, resolve_device
from .sharding import camera_mesh

log = logging.getLogger("multihost")


def add_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--coordinator_address",
        default="",
        help="host:port of process 0 for a multi-process run (empty = single host)",
    )
    p.add_argument("--num_processes", type=int, default=-1, help="total processes (-1 = WORLD_SIZE)")
    p.add_argument("--process_id", type=int, default=-1, help="this process's rank (-1 = RANK)")


def _from_env(value, name: str) -> int:
    if value is not None and int(value) >= 0:
        return int(value)
    if name not in os.environ:
        raise ValueError(f"{name} is not set: pass it as a flag or set the environment variable")
    return int(os.environ[name])


def maybe_initialize(args=None, *, backend=None, device=None, **overrides) -> bool:
    """Join the process group iff a coordinator address is configured.

    Accepts an argparse namespace carrying :func:`add_flags` values and/or
    keyword overrides of them. ``backend`` None means ``nccl`` where
    ``device`` (None: the card) is a CUDA device and ``gloo`` for the CPU;
    a caller that puts several ranks on one card passes ``gloo``. Returns
    True if the group is initialized (now or earlier), False for the
    single-process path. A second call does nothing.
    """
    coord = overrides.get("coordinator_address") or getattr(args, "coordinator_address", "")
    if not coord or dist.is_initialized():
        return dist.is_initialized()
    world = _from_env(overrides.get("num_processes", getattr(args, "num_processes", -1)), "WORLD_SIZE")
    rank = _from_env(overrides.get("process_id", getattr(args, "process_id", -1)), "RANK")
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    log.info("init_process_group(%s, tcp://%s, world_size=%d, rank=%d)", backend, coord, world, rank)
    dist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=world, rank=rank)
    log.info("multi-host up: process %d/%d (%s)", dist.get_rank(), dist.get_world_size(), backend)
    return True


def local_device(device=None) -> torch.device:
    """The device this rank computes on: the CPU where asked, a card named
    with its index as given, else the rank's card,
    ``cuda:{LOCAL_RANK or rank % device_count}``. Raises where no card is
    visible unless the CPU is asked for."""
    device = resolve_device(device)
    if device.type != "cuda":
        return device
    default_device()  # raises where no card is visible
    if device.index is not None:
        return device
    if "LOCAL_RANK" in os.environ:
        index = int(os.environ["LOCAL_RANK"])
    else:
        index = (dist.get_rank() if dist.is_initialized() else 0) % torch.cuda.device_count()
    return torch.device("cuda", index)


def global_camera_mesh(axis_name: str = "cam"):
    """A 1-D mesh over every rank of the process group: the multi-host form
    of :func:`.sharding.camera_mesh`."""
    return camera_mesh(axis_name=axis_name)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
