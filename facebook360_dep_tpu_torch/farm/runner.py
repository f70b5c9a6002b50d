"""Render-farm orchestration: stages over frame chunks with resume.

The reference farm is a RabbitMQ master/worker over (stage, frame-chunk) jobs
with filesystem-as-checkpoint resume (``scripts/render/pipeline.py:56-515``:
``_get_missing_chunks`` re-enqueues only chunks whose outputs are missing;
workers at-least-once via ack/requeue). Here the same contract is a local /
multi-process executor with identical chunking + resume semantics; frame-axis
work is embarrassingly parallel, so scaling out means running more worker
processes (or hosts) against the same shared filesystem — no message broker
required, the output tree IS the ledger.

Every stage's work is a subprocess (``python -m
facebook360_dep_tpu_torch.cli.<module>``), so the parent never touches the
card: with ``workers > 1`` the chunks of a stage run on threads that each
wait on their subprocess, and each subprocess holds its own CUDA context.
(The JAX package forks a process pool here, which must pickle each stage's
command and cannot pickle the lambdas that render_pipeline builds.)
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Sequence

from ..core import io

log = logging.getLogger("farm")

NO_WORKER_TIMEOUT = 180  # scripts/render/config.py:92


@dataclass
class FrameChunk:
    first: int
    last: int

    @property
    def name(self) -> str:
        return f"{io.frame_name(self.first)}_{io.frame_name(self.last)}"

    def frames(self):
        return [io.frame_name(f) for f in range(self.first, self.last + 1)]


def chunk_frames(first: int, last: int, chunk_size: int) -> list[FrameChunk]:
    """render.py:168-174 frame chunking."""
    chunks = []
    f = first
    while f <= last:
        chunks.append(FrameChunk(f, min(f + chunk_size - 1, last)))
        f += chunk_size
    return chunks


@dataclass
class Stage:
    """One pipeline stage: a command per chunk plus the outputs it promises.

    ``command(chunk) -> argv`` (run via subprocess) or a callable
    ``run(chunk)``; ``outputs(chunk) -> [paths]`` drives the resume check.
    """

    name: str
    outputs: Callable[[FrameChunk], Sequence[str]]
    command: Callable[[FrameChunk], Sequence[str]] | None = None
    run: Callable[[FrameChunk], None] | None = None

    def missing(self, chunks: Sequence[FrameChunk]) -> list[FrameChunk]:
        """Chunks with any missing output (pipeline.py:120-171 cache check)."""
        out = []
        for chunk in chunks:
            if any(not os.path.exists(p) for p in self.outputs(chunk)):
                out.append(chunk)
        return out


def _run_chunk(stage: Stage, chunk: FrameChunk) -> str:
    t0 = time.time()
    if stage.run is not None:
        stage.run(chunk)
    else:
        argv = list(stage.command(chunk))
        result = subprocess.run(argv, capture_output=True, text=True)
        if result.returncode != 0:
            raise RuntimeError(
                f"stage {stage.name} chunk {chunk.name} failed ({result.returncode}):\n"
                f"{result.stderr[-4000:]}"
            )
    return f"{stage.name}/{chunk.name} ({time.time() - t0:.1f}s)"


class _StagesRunner:
    """Runs stages in order over chunks with skip-if-done resume; a subclass
    says how a stage's missing chunks are worked off (``_dispatch``)."""

    force_recompute = False
    _banner = ""

    def _dispatch(self, stage: Stage, todo: list[FrameChunk]) -> None:
        raise NotImplementedError

    def run_stage(self, stage: Stage, chunks: Sequence[FrameChunk]) -> None:
        todo = list(chunks) if self.force_recompute else stage.missing(chunks)
        skipped = len(chunks) - len(todo)
        if skipped:
            log.info("%s: %d/%d chunks cached, skipping", stage.name, skipped, len(chunks))
        if not todo:
            return
        self._dispatch(stage, todo)
        still_missing = stage.missing(chunks) if not self.force_recompute else []
        if still_missing:
            raise RuntimeError(
                f"stage {stage.name}: outputs still missing for {[c.name for c in still_missing]}"
            )

    def run(self, stages: Sequence[Stage], chunks: Sequence[FrameChunk]) -> None:
        t0 = time.time()
        for stage in stages:
            log.info("=== stage %s (%d chunks%s) ===", stage.name, len(chunks), self._banner)
            self.run_stage(stage, chunks)
        log.info("pipeline complete in %.1fs", time.time() - t0)


class Pipeline(_StagesRunner):
    """Run stages in order; within a stage, chunks run in parallel with
    skip-if-done resume and at-least-once retry."""

    def __init__(self, workers: int = 1, force_recompute: bool = False, max_retries: int = 1):
        self.workers = workers
        self.force_recompute = force_recompute
        self.max_retries = max_retries

    def _dispatch(self, stage: Stage, todo: list[FrameChunk]) -> None:
        attempts = {c.name: 0 for c in todo}
        pending = list(todo)
        while pending:
            failed = []
            if self.workers <= 1 or stage.run is not None:
                for chunk in pending:
                    try:
                        log.info("done: %s", _run_chunk(stage, chunk))
                    except Exception as e:  # noqa: BLE001 — requeue semantics
                        log.warning("failed: %s/%s: %s", stage.name, chunk.name, e)
                        failed.append(chunk)
            else:
                with ThreadPoolExecutor(self.workers) as pool:
                    futures = {pool.submit(_run_chunk, stage, c): c for c in pending}
                    for fut, chunk in futures.items():
                        try:
                            log.info("done: %s", fut.result())
                        except Exception as e:  # noqa: BLE001
                            log.warning("failed: %s/%s: %s", stage.name, chunk.name, e)
                            failed.append(chunk)
            # at-least-once: requeue failures up to max_retries (worker.py:458-481)
            pending = []
            for chunk in failed:
                attempts[chunk.name] += 1
                if attempts[chunk.name] <= self.max_retries:
                    pending.append(chunk)
                else:
                    raise RuntimeError(f"stage {stage.name} chunk {chunk.name} exhausted retries")


class DistributedPipeline(_StagesRunner):
    """Master for cross-process / cross-host workers over a shared-filesystem
    broker (``farm.broker.FileQueue``). Same contract as the reference master
    (``pipeline.py:173-248``): publish one persistent message per missing
    chunk, poll until the response count matches, requeue dead workers' chunks,
    abort if no worker is alive for the watchdog window. Workers are separate
    ``python -m facebook360_dep_tpu_torch.farm.worker`` processes on any host that
    shares ``queue_root``."""

    _banner = ", distributed"

    def __init__(
        self,
        queue_root: str,
        force_recompute: bool = False,
        no_worker_timeout: float | None = None,
        lease_seconds: float | None = None,
        stage_timeout: float | None = None,
    ):
        from . import broker

        self.queue_root = queue_root
        self.force_recompute = force_recompute
        self.no_worker_timeout = no_worker_timeout or broker.NO_WORKER_TIMEOUT
        self.lease_seconds = lease_seconds or broker.LEASE_SECONDS
        self.stage_timeout = stage_timeout

    def _dispatch(self, stage: Stage, todo: list[FrameChunk]) -> None:
        from .broker import FileQueue

        assert stage.command is not None, "distributed stages need a subprocess command"
        queue = FileQueue(os.path.join(self.queue_root, stage.name))
        for chunk in todo:
            queue.publish(chunk.name, {"argv": list(stage.command(chunk))})
        log.info("%s: published %d chunk jobs", stage.name, len(todo))
        queue.await_drain(
            expected_done=len(todo),
            timeout=self.stage_timeout,
            no_worker_timeout=self.no_worker_timeout,
            lease=self.lease_seconds,
            # wait for THIS run's job ids: done/ entries left by a previous
            # run against the same queue root must not satisfy the drain
            jobs=[chunk.name for chunk in todo],
        )


def python_module_command(module: str, flags: dict) -> list[str]:
    """Build a subprocess argv for one of our CLI modules with --flag=value
    pairs — the farm message format is a flat flag dict, exactly like the
    reference's worker messages (worker.py:66-107)."""
    argv = [sys.executable, "-m", f"facebook360_dep_tpu_torch.cli.{module}"]
    for k, v in flags.items():
        argv.append(f"--{k}={v}")
    return argv
