"""Standalone farm worker process.

Mirrors the reference worker (``scripts/render/worker.py:488-556``): claim one
message at a time (prefetch 1), run the named CLI module as a subprocess with
the message's flag dict (``_run_bin``, worker.py:66-107), ack on success,
requeue on failure. A heartbeat thread keeps the claim's lease alive; if the
worker is SIGKILLed mid-chunk the lease goes stale and the master requeues the
job for another worker (at-least-once).

Run one per host/chip::

    python -m facebook360_dep_tpu_torch.farm.worker --queue_dir /shared/q [--once]
"""

from __future__ import annotations

import argparse
import logging
import os
import subprocess
import sys
import threading
import time

from .broker import HEARTBEAT_SECONDS, FileQueue

log = logging.getLogger("farm.worker")


def build_argv(message: dict) -> list[str]:
    """A farm message is a flat flag dict + target module, exactly the shape
    of the reference's RabbitMQ messages (worker.py:66-107)."""
    if "argv" in message:
        return list(message["argv"])
    argv = [sys.executable, "-m", f"facebook360_dep_tpu_torch.cli.{message['module']}"]
    for k, v in message.get("flags", {}).items():
        argv.append(f"--{k}={v}")
    return argv


def run_one(queue: FileQueue, worker_id: str, max_retries: int = 1) -> bool:
    """Claim and run a single job. Returns False if the queue was empty."""
    claimed = queue.claim(worker_id)
    if claimed is None:
        return False
    claim_path, message = claimed
    job_id = message.get("job_id", "?")
    stop = threading.Event()

    def beat():
        while not stop.wait(HEARTBEAT_SECONDS):
            try:
                queue.heartbeat(claim_path)
            except FileNotFoundError:
                return

    hb = threading.Thread(target=beat, daemon=True)
    hb.start()
    t0 = time.time()
    try:
        argv = build_argv(message)
        env = dict(os.environ, **message.get("env", {}))
        result = subprocess.run(argv, capture_output=True, text=True, env=env)
        if result.returncode != 0:
            raise RuntimeError(
                f"rc={result.returncode}: {result.stderr[-2000:] or result.stdout[-2000:]}"
            )
        queue.ack(claim_path, {"seconds": round(time.time() - t0, 2), "worker": worker_id})
        log.info("done %s (%.1fs)", job_id, time.time() - t0)
        return True
    except Exception as e:  # noqa: BLE001 — reject-with-requeue semantics
        requeued = queue.fail(claim_path, str(e), max_retries=max_retries)
        log.warning("failed %s (%s): %s", job_id, "requeued" if requeued else "parked", e)
        return True
    finally:
        stop.set()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--queue_dir", required=True)
    p.add_argument("--worker_id", default=None)
    p.add_argument("--max_retries", type=int, default=1)
    p.add_argument("--once", action="store_true", help="exit when the queue is empty")
    p.add_argument("--poll_s", type=float, default=0.2)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")

    worker_id = args.worker_id or f"{os.uname().nodename}-{os.getpid()}"
    queue = FileQueue(args.queue_dir)
    log.info("worker %s consuming %s", worker_id, args.queue_dir)
    while True:
        if not run_one(queue, worker_id, max_retries=args.max_retries):
            if args.once:
                return
            time.sleep(args.poll_s)


if __name__ == "__main__":
    main()
