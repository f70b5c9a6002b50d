"""Elastic GPU-fleet provisioning: the scripts/aws equivalent, for single-H100 VMs.

Reference: ``scripts/aws/create.py:227-330`` spins up an EC2 staging instance,
a kops/Kubernetes worker fleet, deploys the Docker image, runs the render,
and auto-terminates when average worker CPU stays under 5% for 20 minutes
(``scripts/aws/util.py:168-185``, ``scripts/render/config.py:86-87``).

Here each worker is one Compute Engine VM with one NVIDIA H100
(``gcloud compute instances``), the project ships through GCS
(farm.transfer), each worker runs the port's render_pipeline on a
frame-range shard, and the fleet is torn down on idle. Frame-level work is
embarrassingly parallel, so workers need no interconnect: each owns a chunk
range, and the output tree on GCS is the ledger (missing-chunk resume,
runner.Stage.missing). The lifecycle, methods and flags are the JAX
package's TPU fleet's.

Every gcloud/gsutil action is built as an argv and can be inspected with
``dry_run=True``; this module is fully testable offline.
"""

from __future__ import annotations

import logging
import subprocess
import time
from dataclasses import dataclass, field

log = logging.getLogger("cluster")

AUTO_TERMINATE_IDLE_MIN = 20  # config.py:86-87
AUTO_TERMINATE_CPU_FRAC = 0.05


@dataclass
class ClusterConfig:
    name: str = "dep-farm"
    project: str = ""
    zone: str = "us-central1-a"
    accelerator_type: str = "nvidia-h100-80gb"  # one card a worker
    machine_type: str = "a3-highgpu-1g"
    image_family: str = "common-cu124-ubuntu-2204"
    image_project: str = "deeplearning-platform-release"
    workers: int = 2
    gcs_root: str = ""  # gs://bucket/project
    setup_script: str = "cd /workspace && python3 -c 'import facebook360_dep_tpu_torch'"
    env: dict = field(default_factory=dict)


class GpuFleet:
    """Lifecycle of a fleet of independent single-GPU VM workers."""

    def __init__(self, cfg: ClusterConfig, dry_run: bool = False):
        self.cfg = cfg
        self.dry_run = dry_run
        self.issued: list[list[str]] = []  # every argv built (dry-run ledger)

    # -- command plumbing ---------------------------------------------------

    def _run(self, argv: list[str], capture: bool = False):
        self.issued.append(argv)
        if self.dry_run:
            log.info("[dry-run] %s", " ".join(argv))
            return ""
        out = subprocess.run(argv, check=True, capture_output=capture, text=True)
        return out.stdout if capture else ""

    def _gcloud_vm(self, verb: str, worker: str, *extra: str) -> list[str]:
        head = ["gcloud", "compute", "ssh"] if verb == "ssh" else ["gcloud", "compute", "instances", verb]
        argv = [*head, worker, f"--zone={self.cfg.zone}"]
        if self.cfg.project:
            argv.append(f"--project={self.cfg.project}")
        argv.extend(extra)
        return argv

    def worker_name(self, i: int) -> str:
        return f"{self.cfg.name}-w{i}"

    # -- lifecycle (create.py:227-330 equivalents) --------------------------

    def create(self):
        for i in range(self.cfg.workers):
            self._run(self._gcloud_vm(
                "create", self.worker_name(i),
                f"--machine-type={self.cfg.machine_type}",
                f"--accelerator=type={self.cfg.accelerator_type},count=1",
                "--maintenance-policy=TERMINATE",
                f"--image-family={self.cfg.image_family}",
                f"--image-project={self.cfg.image_project}",
                "--metadata=install-nvidia-driver=True",
            ))

    def deploy(self, local_repo: str):
        """Ship the framework + project pointers to every worker."""
        from . import transfer

        if self.cfg.gcs_root:
            cmd = transfer.transfer(
                local_repo, f"{self.cfg.gcs_root}/workspace", dry_run=self.dry_run
            )
            if cmd:
                self.issued.append(cmd)
        for i in range(self.cfg.workers):
            fetch = f"gsutil -m rsync -r {self.cfg.gcs_root}/workspace /workspace"
            self._run(self._gcloud_vm(
                "ssh", self.worker_name(i), "--command",
                f"{fetch} && {self.cfg.setup_script}",
            ))

    def run_render(self, input_root: str, output_root: str, first: int, last: int,
                   chunk_size: int = 1, extra_flags: dict | None = None):
        """Shard [first, last] across workers; each runs the pipeline CLI on
        its range with missing-chunk resume (render.py:168-216 semantics)."""
        per = max((last - first + 1 + self.cfg.workers - 1) // self.cfg.workers, 1)
        for i in range(self.cfg.workers):
            lo = first + i * per
            hi = min(lo + per - 1, last)
            if lo > hi:
                break
            flags = {
                "input_root": input_root, "output_root": output_root,
                "first": f"{lo:06d}", "last": f"{hi:06d}", "chunk_size": chunk_size,
                **(extra_flags or {}),
            }
            flag_str = " ".join(f"--{k}={v}" for k, v in flags.items())
            env = " ".join(f"{k}={v}" for k, v in self.cfg.env.items())
            self._run(self._gcloud_vm(
                "ssh", self.worker_name(i), "--command",
                f"{env} python3 -m facebook360_dep_tpu_torch.cli.render_pipeline {flag_str}".strip(),
            ))

    def worker_utilization(self) -> list[float]:
        """Average recent CPU fraction per worker (aws/util.py:133-185
        get_staging_info equivalent; via ssh loadavg)."""
        loads = []
        for i in range(self.cfg.workers):
            out = self._run(self._gcloud_vm(
                "ssh", self.worker_name(i), "--command",
                "cat /proc/loadavg",
            ), capture=True)
            loads.append(float(out.split()[0]) if out else 0.0)
        return loads

    def monitor_and_terminate(self, poll_s: int = 60, idle_minutes: int = AUTO_TERMINATE_IDLE_MIN):
        """Tear the fleet down once CPU stays under 5% for idle_minutes
        (config.py:86-87 auto_terminate_cluster)."""
        idle_since = None
        while True:
            util = self.worker_utilization()
            busy = any(u > AUTO_TERMINATE_CPU_FRAC for u in util)
            now = time.time()
            if busy:
                idle_since = None
            elif idle_since is None:
                idle_since = now
            elif now - idle_since >= idle_minutes * 60:
                log.info("idle for %d min; terminating", idle_minutes)
                self.terminate()
                return
            if self.dry_run:
                return  # one pass is enough offline
            time.sleep(poll_s)

    def terminate(self):
        for i in range(self.cfg.workers):
            self._run(self._gcloud_vm("delete", self.worker_name(i), "--quiet"))

    def plan(self) -> str:
        """Human-readable dry-run ledger."""
        return "\n".join(" ".join(a) for a in self.issued)


def main(argv=None):
    import argparse

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--name", default="dep-farm")
    p.add_argument("--project", default="")
    p.add_argument("--zone", default=ClusterConfig.zone)
    p.add_argument("--accelerator_type", default=ClusterConfig.accelerator_type)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--gcs_root", default="")
    p.add_argument("--input_root", required=True)
    p.add_argument("--output_root", required=True)
    p.add_argument("--first", type=int, default=0)
    p.add_argument("--last", type=int, default=0)
    p.add_argument("--chunk_size", type=int, default=1)
    p.add_argument("--local_repo", default=".")
    p.add_argument("--dry_run", action="store_true")
    p.add_argument("--skip_create", action="store_true")
    p.add_argument("--auto_terminate", action="store_true")
    args = p.parse_args(argv)

    cfg = ClusterConfig(
        name=args.name, project=args.project, zone=args.zone,
        accelerator_type=args.accelerator_type, workers=args.workers,
        gcs_root=args.gcs_root,
    )
    fleet = GpuFleet(cfg, dry_run=args.dry_run)
    if not args.skip_create:
        fleet.create()
    fleet.deploy(args.local_repo)
    fleet.run_render(args.input_root, args.output_root, args.first, args.last, args.chunk_size)
    if args.auto_terminate:
        fleet.monitor_and_terminate()
    if args.dry_run:
        print(fleet.plan())
    return fleet


if __name__ == "__main__":
    main()
