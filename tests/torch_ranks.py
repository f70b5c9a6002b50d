"""The ranks of the port's multi-process tests (torch.distributed, gloo, CPU).

A test writes jobs with :func:`spawn` (or :func:`start`, then :func:`finish`),
which starts ``world`` processes of

    python tests/torch_ranks.py JOB.pt RANK

for each job, each job on a free port, waits for them with a timeout (a
hung rendezvous fails the test instead of holding the suite) and returns
what each rank saved. A rank imports torch and the port only. Job kinds:

- ``solve``: join the group (``multihost.maybe_initialize``), build the
  level context of ``rig`` and ``colors``, run each of ``tasks`` (a
  ``process_level_sharded`` on the camera mesh, a ``process_frames_sharded``
  on a frame x camera mesh, or a context whose destinations do not divide
  by the ranks) and save the gathered results. A task with ``block`` builds
  the rank's own context (``make_level_context(destinations=)``, with the
  task's ``context`` arguments) and saves the shapes of its destination
  fields and of the proposal draws the rank kept;
- ``derp_cli``: run ``derp_cli.main(argv + the coordinator flags,
  device="cpu")``, which joins the group itself.
"""

import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS = 2  # as torch_parity sets for the test processes


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start(tmp_path, runs: dict) -> dict:
    """Start every run of ``runs`` (name -> (world, job)) at once, each on
    its own port; :func:`finish` waits for them."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = {}
    for name, (world, job) in runs.items():
        path = os.path.join(str(tmp_path), f"job_{name}.pt")
        torch.save(dict(job, coordinator=f"127.0.0.1:{free_port()}", world=world), path)
        procs[name] = (path, [subprocess.Popen([sys.executable, os.path.abspath(__file__), path, str(r)], env=env,
                                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                              for r in range(world)])
    return procs


def finish(procs: dict, timeout: float = 150.0) -> dict:
    """Wait for :func:`start`'s ranks (each rank must exit 0 within
    ``timeout`` s; any left are killed); returns name -> each rank's saved
    dict."""
    try:
        for name, (_, ranks) in procs.items():
            for r, p in enumerate(ranks):
                _, err = p.communicate(timeout=timeout)
                assert p.returncode == 0, f"{name} rank {r} rc={p.returncode}:\n{err[-3000:]}"
    finally:
        kill(procs)
    return {name: [torch.load(f"{path}.rank{r}.pt", weights_only=False) for r in range(len(ranks))]
            for name, (path, ranks) in procs.items()}


def kill(procs: dict) -> None:
    for _, ranks in procs.values():
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()


def spawn(tmp_path, runs: dict, timeout: float = 150.0) -> dict:
    return finish(start(tmp_path, runs), timeout)


def _solve(job: dict, rank: int) -> dict:
    from facebook360_dep_tpu_torch.depth import pipeline, solver
    from facebook360_dep_tpu_torch.parallel import multihost, sharding

    multihost.maybe_initialize(coordinator_address=job["coordinator"], num_processes=job["world"],
                               process_id=rank, device="cpu")
    rig, colors = job["rig"], job["colors"]
    h, w = colors.shape[1:3]
    ctx = solver.make_level_context(rig, rig, colors, pipeline.generate_fov_masks(rig, (h, w)),
                                    **job.get("context", {}))
    d = len(ctx.dst2src)
    saved = {}
    draws = []
    draw_uniforms = solver.draw_uniforms

    def counting_draws(*args, **kwargs):
        out = draw_uniforms(*args, **kwargs)
        draws.append(tuple(out.shape))
        return out

    solver.draw_uniforms = counting_draws
    for name, task in job["tasks"].items():
        cfg = solver.SolverConfig(**task["cfg"])
        init = task.get("init")
        mesh = sharding.frame_camera_mesh(task["frame_axis"]) if task["kind"] == "frames" else None
        mesh = sharding.camera_mesh() if task["kind"] == "level" else mesh
        base = ctx
        if task.get("block"):
            base = solver.make_level_context(rig, rig, colors, pipeline.generate_fov_masks(rig, (h, w)),
                                             destinations=sharding.block(d, mesh, "cam"),
                                             **dict(job.get("context", {}), **task.get("context", {})))
            saved[name + "_fields"] = {f: tuple(getattr(base, f).shape) for f in (
                "dst_planar", "dst_variance", "dst_fov_masks", "dst_fg_masks", "dst_bg_disp", "dst_rays")}
            saved[name + "_fields"].update(dst2src=base.dst2src, dst_index=base.dst_index)
        draws.clear()
        if task["kind"] == "level":
            dsts = sharding.block(d, mesh, "cam")
            out = sharding.process_level_sharded(
                base, cfg, mesh, init_disparity=None if init is None else init[dsts.start:dsts.stop],
                uniforms=task.get("uniforms"))
        elif task["kind"] == "frames":
            frames = sharding.block(len(task["frames"]), mesh, "frame")
            dsts = sharding.block(d, mesh, "cam")
            out = sharding.process_frames_sharded(
                base, task["frames"], cfg, mesh,
                init_disparity=None if init is None else init[frames.start:frames.stop, dsts.start:dsts.stop],
                uniforms=task.get("uniforms"))
            saved[name + "_frames"] = out["frames"]
        else:  # "indivisible": a context with task["destinations"] destinations, and 3 frame groups
            try:
                sharding.process_level_sharded(
                    solver.select_destinations(ctx, range(task["destinations"])), cfg, sharding.camera_mesh())
            except ValueError as e:
                saved[name] = str(e)
            try:
                sharding.frame_camera_mesh(3)
            except ValueError as e:
                saved[name + "_frames"] = str(e)
            continue
        saved[name + "_destinations"] = out["destinations"]
        saved[name + "_draws"] = list(draws)
        saved[name] = sharding.gather_result(out, mesh)
    solver.draw_uniforms = draw_uniforms
    multihost.shutdown()
    return saved


def _derp_cli(job: dict, rank: int) -> dict:
    from facebook360_dep_tpu_torch.cli import derp_cli
    from facebook360_dep_tpu_torch.parallel import multihost

    out_root = os.path.join(job["out"], f"rank{rank}")
    derp_cli.main(job["argv"] + ["--output_root", out_root, "--coordinator_address", job["coordinator"],
                                 "--num_processes", str(job["world"]), "--process_id", str(rank)],
                  device="cpu")
    saved = dict(out_root=out_root, rank=dist.get_rank(), world=dist.get_world_size(),
                 backend=dist.get_backend())
    multihost.shutdown()
    return saved


def main(path: str, rank: int) -> None:
    torch.set_num_threads(THREADS)
    job = torch.load(path, weights_only=False)
    saved = {"solve": _solve, "derp_cli": _derp_cli}[job["kind"]](job, rank)
    torch.save(saved, f"{path}.rank{rank}.pt")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
