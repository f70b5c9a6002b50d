"""Named spans of the frame job, on one clock with the profiler's trace.

``span(name)`` times its block on ``time.perf_counter_ns`` into the record
that :meth:`Record.at` binds (the running estimator's, per (frame, level));
outside such a block it records nothing. Only while a torch profiler runs
in the process does it also open ``torch.profiler.record_function(name)``,
so a trace (``--profile_dir``, a benchmark's traced run) shows the span on
the clock the card's work is aligned to. The names are listed in PERF.md.
"""

from __future__ import annotations

import contextlib
import time
from contextvars import ContextVar

import torch
from torch.autograd import profiler as _autograd_profiler

_SINK: ContextVar = ContextVar("derp_span_sink", default=None)

# the per-frame log line's split: group -> span names (a name ending in "." is a prefix)
GROUPS = {
    "io": ("derp.io.",),
    "copies": ("derp.upload", "derp.readback"),
    "setup": ("derp.stage.setup",),
    "search": ("derp.stage.brute_force", "derp.stage.proposals", "derp.stage.ping_pong", "derp.stage.mismatches"),
    "filters": ("derp.stage.bilateral", "derp.stage.median"),
}


class span:
    """``with span(name) as s:`` times the block; ``s.ns`` holds its nanoseconds after it."""

    __slots__ = ("name", "ns", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name
        self.ns = 0

    def __enter__(self):
        # entering a record_function costs ~16 us even with no profiler: read the flag first
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.ns = time.perf_counter_ns() - self._t0
        sink = _SINK.get()
        if sink is not None:
            sink[self.name] = sink.get(self.name, 0) + self.ns
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class Record:
    """One estimator's spans: ``ns[(frame, level)][name]`` nanoseconds, and
    ``wall[(frame, level)]`` the nanoseconds of the blocks bound to it.
    Frame None holds a level's shared part, (None, None) the estimator's own."""

    def __init__(self):
        self.ns: dict = {}
        self.wall: dict = {}

    @contextlib.contextmanager
    def at(self, frame, level):
        """Bind the spans of the block to (frame, level)."""
        key = (frame, level)
        token = _SINK.set(self.ns.setdefault(key, {}))
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.wall[key] = self.wall.get(key, 0) + time.perf_counter_ns() - t0
            _SINK.reset(token)

    def split(self, frame, level) -> dict:
        """Seconds of each group of :data:`GROUPS` in (frame, level)."""
        ns = self.ns.get((frame, level), {})
        return {g: sum(v for n, v in ns.items() if any(n == p or (p[-1] == "." and n.startswith(p)) for p in names))
                / 1e9 for g, names in GROUPS.items()}
