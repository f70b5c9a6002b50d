"""Asynchronous striped-file playback loader: the port of
``facebook360_dep_tpu/stream/async_loader.py``.

Reference: ``mesh_stream/AsyncFile.h:9-247`` (platform async reads — POSIX
``preadv`` under ``std::async``), ``render/AsyncLoader.h:20-196``
(double-buffered background frame loader feeding the 6DoF viewer), and
``viewer/GlViewer.cpp:44`` (3-frame readahead).

Same design, host-side: a thread pool issues ``os.preadv`` scatter reads of
whole frames from the stripe files (512 KiB stripes round-robin across
"disks", StripedFile.h:21-120), keeping a readahead window of decoded frames
ahead of the playback cursor. Reads of one frame are split per stripe so
independent disks are hit concurrently.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor

from . import fusion

STRIPE_SIZE = 512 * 1024  # StripedFile.h:23
DEFAULT_READAHEAD = 3  # GlViewer.cpp:44


class AsyncStripedFile:
    """Scatter-reads over N stripe files with preadv (AsyncFile equivalent)."""

    def __init__(self, paths, max_workers: int | None = None):
        self.paths = list(paths)
        self.fds = [os.open(p, os.O_RDONLY) for p in self.paths]
        self.pool = ThreadPoolExecutor(max_workers=max_workers or max(len(self.paths), 2))
        self._lock = threading.Lock()

    def _read_stripe_span(self, disk: int, offset: int, size: int) -> bytes:
        return os.pread(self.fds[disk], size, offset)

    def read_begin(self, global_offset: int, size: int) -> list[Future]:
        """Issue the stripe-aligned reads for a logical span; returns futures
        in stripe order (AsyncFile readBegin)."""
        futures = []
        pos = global_offset
        end = global_offset + size
        while pos < end:
            stripe_idx, within = divmod(pos, STRIPE_SIZE)
            disk = stripe_idx % len(self.fds)
            local_stripe = stripe_idx // len(self.fds)
            local_offset = local_stripe * STRIPE_SIZE + within
            n = min(STRIPE_SIZE - within, end - pos)
            futures.append(self.pool.submit(self._read_stripe_span, disk, local_offset, n))
            pos += n
        return futures

    @staticmethod
    def read_end(futures) -> bytes:
        """Await and concatenate (AsyncFile readEnd)."""
        return b"".join(f.result() for f in futures)

    def read(self, global_offset: int, size: int) -> bytes:
        return self.read_end(self.read_begin(global_offset, size))

    def close(self):
        self.pool.shutdown(wait=True)
        for fd in self.fds:
            os.close(fd)


class AsyncFrameLoader:
    """Readahead frame loader over a fused 6DoF stream (AsyncLoader).

    ``get(frame)`` returns {(cam_id, ext): bytes} for one frame; a window of
    ``readahead`` subsequent frames is always in flight on background
    threads. Frames are identified by their catalog order.
    """

    EXTS = (".vtx", ".idx", ".bc7", ".rgba")

    def __init__(self, fused_dir: str, catalog: dict, num_disks: int = 1,
                 readahead: int = DEFAULT_READAHEAD):
        self.fused_dir = fused_dir
        self.catalog = catalog
        self.num_disks = num_disks
        self.readahead = readahead
        self.frames = sorted(catalog["frames"].keys())
        self.pool = ThreadPoolExecutor(max_workers=2)
        self._pending: dict[str, Future] = {}
        self._lock = threading.Lock()

    def _load_frame(self, frame: str) -> dict:
        out = {}
        for cam_id, entries in self.catalog["frames"][frame].items():
            for ext in self.EXTS:
                if ext in entries:
                    out[(cam_id, ext)] = fusion.read_fused_entry(
                        self.fused_dir, self.catalog, frame, cam_id, ext, self.num_disks
                    )
        return out

    def _schedule(self, frame: str):
        with self._lock:
            if frame not in self._pending:
                self._pending[frame] = self.pool.submit(self._load_frame, frame)

    def get(self, frame: str) -> dict:
        """Blocking fetch of one frame; kicks off readahead of the next ones."""
        self._schedule(frame)
        idx = self.frames.index(frame)
        for nxt in self.frames[idx + 1 : idx + 1 + self.readahead]:
            self._schedule(nxt)
        with self._lock:
            fut = self._pending[frame]
        result = fut.result()
        with self._lock:
            # keep the window bounded: drop anything behind the cursor
            for f in list(self._pending):
                if f < frame:
                    del self._pending[f]
        return result

    def close(self):
        self.pool.shutdown(wait=False, cancel_futures=True)
