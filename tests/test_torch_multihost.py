"""The port's multi-process initialization
(facebook360_dep_tpu_torch/parallel/multihost.py): two OS processes join one
gloo group through ``--coordinator_address`` and all-gather over the global
camera mesh; the single-process path initializes nothing; the flags, the
environment's WORLD_SIZE/RANK and the backend reach
``init_process_group``; ``local_device`` names the rank's card."""

import argparse
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from facebook360_dep_tpu.parallel import multihost as jmultihost
from facebook360_dep_tpu_torch.parallel import multihost

from torch_ranks import REPO, free_port

CHILD = r"""
import argparse, sys
import torch
from facebook360_dep_tpu_torch.parallel import multihost, sharding
p = argparse.ArgumentParser()
multihost.add_flags(p)
args = p.parse_args()
assert multihost.maybe_initialize(args, device="cpu")
assert multihost.maybe_initialize(args, device="cpu")  # a second call is harmless
import torch.distributed as dist
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
mesh = multihost.global_camera_mesh()
assert mesh.mesh_dim_names == ("cam",) and mesh.size() == 2
r = dist.get_rank()
got = sharding.all_gather(torch.tensor([[r, 10 * r + 1]], dtype=torch.float32), mesh, "cam")
assert got.tolist() == [[0.0, 1.0], [1.0, 11.0]], got
mask = sharding.all_gather(torch.tensor([r == 1, True]), mesh, "cam")
assert mask.dtype == torch.bool and mask.tolist() == [False, True, True, True], mask
assert multihost.local_device("cpu") == torch.device("cpu")
multihost.shutdown()
assert not dist.is_initialized()
print("MULTIHOST_OK", r)
"""


def test_two_processes_join_and_gather(tmp_path):
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    coord = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, str(script), "--coordinator_address", coord,
                               "--num_processes", "2", "--process_id", str(r)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"rank {r} rc={p.returncode}:\n{err[-2000:]}"
            assert f"MULTIHOST_OK {r}" in out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_flags_match_the_jax_module():
    jp, tp = argparse.ArgumentParser(), argparse.ArgumentParser()
    jmultihost.add_flags(jp)
    multihost.add_flags(tp)
    defaults = lambda p: {a.dest: a.default for a in p._actions if a.dest != "help"}  # noqa: E731
    assert defaults(tp) == defaults(jp) == {"coordinator_address": "", "num_processes": -1, "process_id": -1}


def test_single_host_is_noop():
    args = argparse.Namespace(coordinator_address="", num_processes=-1, process_id=-1)
    assert multihost.maybe_initialize(args) is False
    assert multihost.maybe_initialize(args, device="cpu") is False
    assert not dist.is_initialized()
    multihost.shutdown()  # nothing to shut down


@pytest.fixture
def fake_init(monkeypatch):
    """init_process_group recorded, not run; the group then reads as up."""
    calls = []
    up = {"on": False}

    def init(backend, **kw):
        calls.append(dict(kw, backend=backend))
        up["on"] = True

    monkeypatch.setattr(dist, "init_process_group", init)
    monkeypatch.setattr(dist, "is_initialized", lambda: up["on"])
    monkeypatch.setattr(dist, "get_rank", lambda: calls[-1]["rank"])
    monkeypatch.setattr(dist, "get_world_size", lambda: calls[-1]["world_size"])
    return calls


def test_flags_reach_init_process_group_once(fake_init):
    args = argparse.Namespace(coordinator_address="10.0.0.1:1234", num_processes=4, process_id=3)
    assert multihost.maybe_initialize(args, device="cpu") is True
    assert fake_init == [dict(backend="gloo", init_method="tcp://10.0.0.1:1234", world_size=4, rank=3)]
    assert multihost.maybe_initialize(args, device="cpu") is True  # idempotent
    assert len(fake_init) == 1


def test_minus_one_reads_the_environment(fake_init, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    assert multihost.maybe_initialize(coordinator_address="h:1", device="cpu")
    assert fake_init[0]["world_size"] == 8 and fake_init[0]["rank"] == 5


def test_minus_one_without_the_environment_raises(fake_init, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        multihost.maybe_initialize(coordinator_address="h:1", device="cpu")
    assert fake_init == []


@pytest.mark.parametrize("device, backend, want", [
    ("cpu", None, "gloo"), ("cuda", None, "nccl"), ("cuda:0", None, "nccl"), ("cuda", "gloo", "gloo")])
def test_backend_follows_the_device(fake_init, device, backend, want):
    multihost.maybe_initialize(coordinator_address="h:1", num_processes=1, process_id=0, device=device,
                               backend=backend)
    assert fake_init[0]["backend"] == want


def test_backend_without_a_device_is_the_cards(fake_init, monkeypatch):
    """device None means the card: nccl where one is visible, and raises
    where none is, as every entry point does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    multihost.maybe_initialize(coordinator_address="h:1", num_processes=1, process_id=0)
    assert fake_init[0]["backend"] == "nccl"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fake_init.clear()
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.maybe_initialize(coordinator_address="h:1", num_processes=1, process_id=0)


def test_local_device_is_the_ranks_card(fake_init, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert multihost.local_device() == torch.device("cuda", 0)  # no group: rank 0
    multihost.maybe_initialize(coordinator_address="h:1", num_processes=4, process_id=3, device="cuda")
    assert multihost.local_device() == torch.device("cuda", 1)  # rank 3 of 2 cards
    assert multihost.local_device("cuda") == torch.device("cuda", 1)
    assert multihost.local_device("cuda:0") == torch.device("cuda", 0)  # named: kept
    assert multihost.local_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert multihost.local_device() == torch.device("cuda", 0)

