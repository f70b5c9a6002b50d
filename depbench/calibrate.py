"""Readings that the limits of ``correct`` are set from, for one cell, in one process.

    python3 depbench/calibrate.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9 [--out FILE]

For each of ``--seeds``: the cell's tree from that seed, one job a distinct
frame (as a run's window alternates them), and the compared numbers of
those jobs against the float32 reference: the lower readings. For each of
``--control-seeds``: the reference computed in bfloat16 put in the
program's place, against the float32 reference: the upper readings. For
each of ``--rounding-seeds``: the float32 reference with the sources' SSDs
summed in the other order, which shows how far a change of rounding alone
moves the numbers. Each of ``--harness-runs`` (``kind:seed``, kind
``control`` or a fault of ``tests/faults.py``) is a whole run of the cell,
``--seconds`` long, with the control in the program's place or the fault
planted in the program: the run's own ``correct`` has to come out false.
Runs on the card (the kernels build on first use); prints one JSON line a
seed and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor


def main(argv=None) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from depbench import harness, judge

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--rounding-seeds", default="",
                   help="seeds whose float32 reference summed in another order is read against the reference")
    p.add_argument("--harness-runs", default="",
                   help="kind:seed,... whole runs with the control (kind 'control') or a fault planted")
    p.add_argument("--seconds", type=float, default=5.0, help="the window of each --harness-runs run")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    c = harness.find_cell(args.workload, harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json")))
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    rounding = [int(s) for s in args.rounding_seeds.split(",") if s]
    rows = []
    for spec in [s for s in args.harness_runs.split(",") if s]:
        import pytest

        from depbench import control
        from depbench.tests import faults

        kind, seed = spec.split(":")
        with pytest.MonkeyPatch.context() as mp:
            if kind == "control":
                mp.setattr(harness, "solve", control.solve)
            else:
                faults.plant(kind, mp.setattr)
            t = time.perf_counter()
            r = harness.run(c, int(seed), args.seconds, False, dev, t)
        row = {"workload": c.name, "seed": int(seed), "side": f"harness:{kind}", "correct": r["correct"],
               "attempted": r["attempted"], "failed": r["failed"], "compared": r["compared"],
               "seconds": time.perf_counter() - t}
        rows.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(harness.WORK, exist_ok=True)
    for seed, side in [(s, "program") for s in seeds] + [(s, "control") for s in controls] + \
            [(s, "rounding") for s in rounding]:
        work = tempfile.mkdtemp(prefix="calibrate.", dir=harness.WORK)
        try:
            t = time.perf_counter()
            with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 1)) as pool:
                tree = harness.make_tree(c, os.path.join(work, "tree"), seed, dev, pool)
            row = {"workload": c.name, "seed": seed, "side": side}
            if side != "program":
                finest, coarsest = c.levels[0], c.levels[-1]
                sizes = {lv: c.size(lv) for lv in c.levels}
                ref = harness.load_module(os.path.join(harness.BASE, "reference", c.cell["reference"] + ".py"))
                for frame in c.frames:
                    args_ = (tree.cams_norm, tree.colors[frame], sizes, tree.full_height,
                             float(c.config["min_depth_m"]), float(c.config["max_depth_m"]), dev)
                    kw = dict(keep=(finest, coarsest), **harness.reference_inputs(c, tree, frame))
                    want = ref.solve_pyramid(*args_, torch.float32, **kw)
                    low = (ref.solve_pyramid(*args_, torch.bfloat16, **kw) if side == "control"
                           else ref.solve_pyramid(*args_, torch.float32, reverse_sum=True, **kw))
                    for tag, level in (("finest", finest), ("coarsest", coarsest)):
                        s = judge.off_stats(low[level], want[level], c.cell["compare"]["rel_tol"])
                        row[f"{frame}.{tag}"] = s
                        key = f"{tag}_off_share"
                        row[key] = max(row.get(key, 0.0), s["off_share"])
            else:
                jobs = [harness.run_job(c, tree, os.path.join(work, "out", frame), frame, dev) for frame in c.frames]
                stats, _ = harness.judge_jobs(c, tree, jobs, dev)
                row.update(harness.compared_numbers(stats))
                row["jobs"] = [{"frame": j.frame, "seconds": j.seconds, **s} for j, s in zip(jobs, stats)]
            row["seconds"] = time.perf_counter() - t
            rows.append(row)
            print(json.dumps(row), flush=True)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
