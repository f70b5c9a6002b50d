"""What a traced run reads from torch.profiler, and the breakdown it prints.

The traced jobs run under ``torch.profiler`` (host and card). Their events
are read straight from the profiler's result (``kineto_results.events()``),
without building its event tree or exporting a chrome trace: the device's
intervals, the program's ``derp level N`` ranges and the benchmark's
``depbench job`` ranges. :class:`TraceData` holds what the per-layer
metric readers (``metrics/<name>.py``) read.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import numpy as np

JOB_RANGE = "depbench job"
LEVEL_PREFIX = "derp level "


@dataclass
class TraceData:
    """The traced window of one run.

    ``kernels``: (name, start_ns, duration_ns) of every kernel the card ran;
    ``busy``: merged (start_ns, end_ns) intervals of all device activity
    (kernels, copies, fills) inside ``window``, the traced jobs' (start_ns,
    end_ns) ranges (the harness's read-back between jobs lies outside); ``levels``: (level, start_ns,
    end_ns) host ranges of the program's levels, sorted by start;
    ``level_sizes``: level -> (w, h); ``level_seconds``: the program's
    per-level wall times, one dict a traced job; ``frames``: frames solved
    in the window; ``cameras``: the rig's; ``needs``: level -> what K1's
    and K3's inputs need there (``coverage.level_needs``), filled in after
    the trace is read."""

    kernels: list
    busy: list
    window: list
    levels: list
    level_sizes: dict
    level_seconds: list
    frames: int
    cameras: int
    finest_level: int
    host_ops: list = field(default_factory=list)  # (name, start_ns, end_ns) of the host's torch ops
    needs: dict = field(default_factory=dict)

    def level_at(self, t_ns):
        """The level whose host range holds ``t_ns``, or None."""
        starts = [s for _, s, _ in self.levels]
        i = bisect.bisect_right(starts, t_ns) - 1
        if i >= 0 and self.levels[i][1] <= t_ns <= self.levels[i][2]:
            return self.levels[i][0]
        return None

    def busy_ns(self) -> int:
        return sum(e - s for s, e in self.busy)

    def window_ns(self) -> int:
        return sum(e - s for s, e in self.window)


def merge(intervals, lo, hi):
    """Union of (start, end) intervals, clipped to [lo, hi], sorted."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def collect(prof, level_sizes, level_seconds, frames, cameras, finest_level) -> TraceData:
    """TraceData of a finished ``torch.profiler.profile``."""
    device_events, host_ops, levels, jobs = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type().name != "CPU":
            # the card's copy of a host range (gpu_user_annotation) spans its kernels: not device work
            if not (e.is_user_annotation() or name == JOB_RANGE or name.startswith(LEVEL_PREFIX)):
                device_events.append((name, start, end))
        elif name == JOB_RANGE:
            jobs.append((start, end))
        elif name.startswith(LEVEL_PREFIX):
            levels.append((int(name[len(LEVEL_PREFIX):]), start, end))
        else:
            host_ops.append((name, start, end))
    if not jobs:
        raise RuntimeError("the trace holds no job range")
    window = sorted(jobs)
    inside, busy = [], []
    for lo, hi in window:
        job = [d for d in device_events if lo <= d[1] <= hi]
        inside += job
        busy += merge([(s, e) for _, s, e in job], lo, hi)
    return TraceData(
        kernels=[(n, s, e - s) for n, s, e in inside if is_kernel(n)],
        busy=busy,
        window=window, levels=sorted(levels, key=lambda x: x[1]), level_sizes=dict(level_sizes),
        level_seconds=list(level_seconds), frames=frames, cameras=cameras,
        finest_level=finest_level, host_ops=host_ops)


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without ``void``, an anonymous namespace and its argument list."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    if name.startswith("void "):
        name = name[5:]
    return name[:limit]


def breakdown(t: TraceData, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    of the card, each labelled with the level and the host op that covers
    most of it (where one covers at least half)."""
    by_name: dict[str, int] = {}
    for n, _, d in t.kernels:
        k = short_name(n)
        by_name[k] = by_name.get(k, 0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    for lo, hi in t.window:
        edges = [lo] + [x for s, e in t.busy if lo <= s and e <= hi for x in (s, e)] + [hi]
        gaps += [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    names = [n for n, _, _ in t.host_ops]
    starts = np.array([s for _, s, _ in t.host_ops], np.int64)
    ends = np.array([e for _, _, e in t.host_ops], np.int64)
    labelled = []
    for s, e in gaps:
        level = t.level_at((s + e) // 2)
        best = "host Python, no torch op"
        if names:
            overlap = np.minimum(ends, e) - np.maximum(starts, s)
            i = int(np.argmax(overlap))
            if 2 * overlap[i] >= e - s:  # an op that covers at least half of the gap
                best = names[i]
        where = "outside the levels" if level is None else f"derp level {level}"
        labelled.append([f"{where}: {best}", (e - s) / 1e9])
    return {"device_ops": [[k, v / 1e9] for k, v in ops], "idle_gaps": labelled}
