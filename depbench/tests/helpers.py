"""Shared set-up of the benchmark's CPU tests: a test-sized cell run on the CPU."""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def bench_with_test_cells() -> dict:
    """BENCHMARK.json's metrics with the test-sized cells of tests/data as its workloads."""
    b = benchmark()
    wl = []
    for name in sorted(os.listdir(os.path.join(DATA, "cells"))):
        with open(os.path.join(DATA, "cells", name)) as f:
            cell = json.load(f)
        wl.append({"name": cell["name"], "config": cell["config"], "traffic": cell["traffic"], "chips": 1})
    return {**b, "workloads": wl}


def run_cpu(name: str, traced: bool = False, seed: int = 2**31 + 12345, limits: dict | None = None):
    """One run of a test-sized cell on the CPU (the harness's look for a card skipped)."""
    import torch

    from depbench import harness

    c = harness.find_cell(name, bench_with_test_cells(), DATA)
    if limits:
        c.cell["compare"]["limits"] = dict(limits)
    return harness.run(c, seed, 0.5, traced, torch.device("cpu"), time.perf_counter())
