"""Cross-process / cross-host work queue over a shared filesystem.

The reference's control plane is RabbitMQ: persistent (stage, frame-chunk)
messages, prefetch 1, manual ack, reject-with-requeue on worker failure, and a
master that aborts when no worker is alive for 180 s
(``scripts/render/pipeline.py:173-248``, ``worker.py:458-556``,
``config.py:92``). Here the broker is a directory — on one host or on any
shared filesystem (NFS/GCS-fuse) spanning hosts — giving the same
at-least-once semantics with no daemon:

- ``publish``: master writes ``queue/<job>.json`` (durable message).
- ``claim``: worker atomically ``os.rename``s it to ``claimed/<worker>.<job>``
  — rename is the mutual exclusion, exactly one worker wins.
- ``ack``: worker renames the claim to ``done/<job>.json``.
- lease expiry: workers touch their claim file as a heartbeat; the master
  requeues claims whose mtime is stale (worker died mid-chunk → another
  worker picks the job up, the reference's reject-requeue).
- watchdog: the master raises if nothing is claimed or finished for
  ``NO_WORKER_TIMEOUT`` seconds while work is outstanding.
"""

from __future__ import annotations

import json
import logging
import os
import time
import uuid

log = logging.getLogger("farm")

NO_WORKER_TIMEOUT = 180.0  # scripts/render/config.py:92
LEASE_SECONDS = 30.0  # heartbeat staleness before a claim is requeued
HEARTBEAT_SECONDS = 5.0

QUEUE, CLAIMED, DONE, FAILED = "queue", "claimed", "done", "failed"


def _sanitize_worker_id(worker_id: str) -> str:
    """Worker ids embed in claim filenames as '<worker>.<job>.json'; any
    character that could confuse the '.'-separated parse (or the filesystem)
    becomes '-'. os.uname().nodename is frequently a dotted FQDN."""
    return "".join(c if (c.isalnum() or c in "_-") else "-" for c in worker_id)


class FileQueue:
    def __init__(self, root: str):
        self.root = root
        for d in (QUEUE, CLAIMED, DONE, FAILED):
            os.makedirs(os.path.join(root, d), exist_ok=True)

    def _dir(self, state: str) -> str:
        return os.path.join(self.root, state)

    # ---- master side --------------------------------------------------------

    def publish(self, job_id: str, message: dict) -> None:
        """Durable message (delivery_mode=2 equivalent): write then rename so
        readers never see a partial file. Stale done/failed entries for the
        same job (from a previous run against this queue root) are cleared so
        re-published jobs must be re-acked before they count as done."""
        for state in (DONE, FAILED):
            try:
                os.remove(os.path.join(self._dir(state), job_id + ".json"))
            except FileNotFoundError:
                pass
        tmp = os.path.join(self.root, f".tmp.{uuid.uuid4().hex}")
        with open(tmp, "w") as f:
            json.dump({"job_id": job_id, **message}, f)
        os.rename(tmp, os.path.join(self._dir(QUEUE), job_id + ".json"))

    def requeue_stale_claims(self, lease: float = LEASE_SECONDS) -> list[str]:
        """Claims with a heartbeat older than ``lease`` go back to the queue
        (the reference's reject-with-requeue, worker.py:469-481)."""
        requeued = []
        now = time.time()
        for fn in os.listdir(self._dir(CLAIMED)):
            path = os.path.join(self._dir(CLAIMED), fn)
            try:
                age = now - os.stat(path).st_mtime
            except FileNotFoundError:
                continue  # acked between listdir and stat
            if age > lease:
                job_id = fn.split(".", 1)[1].rsplit(".json", 1)[0]
                try:
                    os.rename(path, os.path.join(self._dir(QUEUE), job_id + ".json"))
                    requeued.append(job_id)
                    log.warning("requeued stale claim %s (worker dead %.0fs)", job_id, age)
                except FileNotFoundError:
                    continue
        return requeued

    def counts(self) -> dict:
        return {s: len(os.listdir(self._dir(s))) for s in (QUEUE, CLAIMED, DONE, FAILED)}

    def await_drain(
        self,
        expected_done: int,
        timeout: float | None = None,
        no_worker_timeout: float = NO_WORKER_TIMEOUT,
        lease: float = LEASE_SECONDS,
        poll: float = 0.25,
        jobs: list[str] | None = None,
    ) -> None:
        """Block until ``expected_done`` jobs are acked. Requeues stale claims
        each poll; raises if no progress AND no live worker for
        ``no_worker_timeout`` (pipeline.py:238-246 watchdog) or on any
        permanently failed job.

        ``jobs`` names the job_ids published by THIS run: completion then
        requires exactly those to be acked, so done/failed files left by a
        previous run against the same queue root cannot satisfy (or abort)
        the wait prematurely."""
        t0 = time.time()
        last_activity = time.time()
        last_sig = None
        want = None if jobs is None else {j + ".json" for j in jobs}
        while True:
            self.requeue_stale_claims(lease)
            c = self.counts()
            fails = set(os.listdir(self._dir(FAILED)))
            if want is not None:
                fails &= want
            if fails:
                raise RuntimeError(f"jobs failed permanently: {sorted(fails)}")
            if want is not None:
                done_now = len(want & set(os.listdir(self._dir(DONE))))
                c = {**c, DONE: done_now}
                if done_now >= len(want):
                    return
            elif c[DONE] >= expected_done:
                return
            sig = (c[DONE], c[CLAIMED], c[QUEUE])
            if sig != last_sig:
                last_sig, last_activity = sig, time.time()
            if c[CLAIMED] == 0 and time.time() - last_activity > no_worker_timeout:
                raise RuntimeError(
                    f"no live workers for {no_worker_timeout:.0f}s with "
                    f"{c[QUEUE]} jobs queued ({c[DONE]}/{expected_done} done)"
                )
            if timeout is not None and time.time() - t0 > timeout:
                raise TimeoutError(f"queue not drained after {timeout:.0f}s: {c}")
            time.sleep(poll)

    # ---- worker side ---------------------------------------------------------

    def claim(self, worker_id: str) -> tuple[str, dict] | None:
        """Atomically take one message (prefetch_count=1 equivalent). Returns
        (claim_path, message) or None if the queue is empty."""
        # Claim files are '<worker>.<job>.json' and ack/requeue parse the job
        # with split('.', 1) — a dotted worker id (FQDN nodenames!) would make
        # them extract the wrong job name, so dots are squashed here.
        worker_id = _sanitize_worker_id(worker_id)
        for fn in sorted(os.listdir(self._dir(QUEUE))):
            src = os.path.join(self._dir(QUEUE), fn)
            dst = os.path.join(self._dir(CLAIMED), f"{worker_id}.{fn}")
            try:
                os.rename(src, dst)
            except FileNotFoundError:
                continue  # another worker won the race
            with open(dst) as f:
                return dst, json.load(f)
        return None

    def heartbeat(self, claim_path: str) -> None:
        os.utime(claim_path)

    def ack(self, claim_path: str, result: dict | None = None) -> None:
        job = os.path.basename(claim_path).split(".", 1)[1]
        done = os.path.join(self._dir(DONE), job)
        if result:
            with open(claim_path, "r+") as f:
                msg = json.load(f)
                msg["result"] = result
                f.seek(0)
                json.dump(msg, f)
                f.truncate()
        os.rename(claim_path, done)

    def fail(self, claim_path: str, error: str, max_retries: int = 1) -> bool:
        """Requeue the message with an attempt count; after ``max_retries``
        requeues, park it in failed/. Returns True if requeued."""
        with open(claim_path) as f:
            msg = json.load(f)
        msg["attempts"] = msg.get("attempts", 0) + 1
        msg["last_error"] = error[-2000:]
        job = os.path.basename(claim_path).split(".", 1)[1]
        state = QUEUE if msg["attempts"] <= max_retries else FAILED
        tmp = os.path.join(self.root, f".tmp.{uuid.uuid4().hex}")
        with open(tmp, "w") as f:
            json.dump(msg, f)
        os.rename(tmp, os.path.join(self._dir(state), job))
        os.remove(claim_path)
        return state == QUEUE
