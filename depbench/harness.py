"""One run of one cell: set-up, the measured (or traced) window, the check.

Everything that belongs to one configuration, traffic mix, scene, rig maker
or per-layer metric is a file of its own, found by name:
``configs/<config>.json``, ``cells/<workload>.json``, ``scenes/<scene>.py``,
``rigs/<maker>.py``, ``reference/<module>.py`` and ``metrics/<metric>.py``;
``BENCHMARK.json`` at the root of the checkout names the cells and metrics.

A run:

1. set-up: renders the cell's distinct frames of the scene on the device
   from ``--seed``, writes them as a project tree of 16-bit PNGs (host
   threads) with the rig file and the input layers the cell lists
   (``inputs``: foreground masks a frame, the background plate's
   disparity), and runs one warm-up job on a frame name the
   window does not use, which builds the program's kernels on a checkout's
   first run and warms every shape the cell uses; then deletes the warm-up's
   output and flushes the tree to disk, so that no writeback of set-up's
   files falls into the window;
2. ``--trace 0``: a closed loop of ``derp_cli`` frame jobs, alternating
   between the frames, each into an output root of its own; jobs start
   while the window is open and the last one finishes; ``--trace 1``: a
   fixed number of whole jobs under torch.profiler. After each job the
   harness reads back the maps it judges (the finest and the coarsest
   level) and deletes the job's output before its pages are written back;
3. with the program's state freed, the plain reference solves every frame
   the jobs solved, and every job's maps at the finest and the coarsest
   level are compared with it (``judge.py``); a traced run also counts
   what K1's and K3's inputs need at each level (``coverage.py``).

The last line of standard output is the result; the numbers compared, with
their limits, are the last lines of standard error and the result's last key.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from depbench import coverage, judge, pngio, program, trace
from depbench.reference import camera as cam

BASE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BASE)
WORK = os.path.join(ROOT, "_depbench_work")
FORBIDDEN = ("jax", "jaxlib", "flax", "facebook360_dep_tpu")
WARMUP_FRAME = "000000"
GIB = float(1 << 30)
# The input layers a cell may list beside the colours: image type -> (its
# directory, frozen from facebook360_dep_tpu_torch/core/imagetypes.py:16,37;
# its file type). Masks are 8-bit grey PNGs, 255 inside (what resize_images
# --threshold 0.5 writes), maps are PFMs.
INPUT_LAYERS = {"foreground_masks_levels": ("video/foreground_masks_levels", "png"),
                "background_disp_levels": ("background/disparity_levels", "pfm")}
# Layers of one plate for the whole tree, written under DerpCLI's default
# --background_frame (the warm-up frame's name, in another directory).
PLATE_INPUTS = {"background_disp_levels"}
PLATE_FRAME = "000000"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """A module of the benchmark found by file name (names may hold dots)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"no such benchmark file: {path}")
    name = "depbench_file_" + os.path.relpath(path, BASE).replace(os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is exactly one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Cell:
    name: str
    bench: dict
    workload: dict
    cell: dict
    config: dict

    @property
    def frames(self) -> list[str]:
        return [f"{k:06d}" for k in range(1, self.cell["distinct_frames"] + 1)]

    @property
    def inputs(self) -> list[str]:
        """The input layers the scene makes beside the colours (image types of ``INPUT_LAYERS``)."""
        return list(self.cell.get("inputs", []))

    @property
    def levels(self) -> list[int]:
        return sorted(self.cell["levels_written"])

    @property
    def judged(self) -> tuple[int, int]:
        """The levels ``correct`` compares: the finest and the coarsest written."""
        return self.levels[0], self.levels[-1]

    def size(self, level: int) -> tuple[int, int]:
        lv = self.config["levels"]
        return lv["widths"][level], lv["heights"][level]

    def flags(self) -> list[str]:
        c = self.config
        return ["--min_depth_m", repr(float(c["min_depth_m"])), "--max_depth_m", repr(float(c["max_depth_m"])),
                *self.cell["derp_flags"]]

    def metrics(self, section: str) -> list[dict]:
        """The BENCHMARK.json metrics of ``section`` that this cell reports."""
        return [m for m in self.bench[section] if self.name in m.get("workloads", [self.name])]


def find_cell(name: str, bench: dict, data: str = BASE) -> Cell:
    wl = [w for w in bench["workloads"] if w["name"] == name]
    if not wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = load_json(os.path.join(data, "cells", name + ".json"))
    if (cell["config"], cell["traffic"]) != (wl[0]["config"], wl[0]["traffic"]):
        raise ValueError(f"cells/{name}.json disagrees with BENCHMARK.json on its config or traffic")
    if cell["frames_per_job"] != 1:
        # a job solves one frame (``solve`` passes first == last), so frame_s would read too fast
        raise ValueError(f"cells/{name}.json: frames_per_job {cell['frames_per_job']}, but a job solves one "
                         "frame; jobs of several frames (sphere16.chunk8) need the harness to pass --last")
    unknown = set(cell.get("inputs", [])) - set(INPUT_LAYERS)
    if unknown:
        raise ValueError(f"cells/{name}.json: unknown inputs {sorted(unknown)}; "
                         f"the harness writes {sorted(INPUT_LAYERS)}")
    return Cell(name, bench, wl[0], cell, load_json(os.path.join(data, "configs", cell["config"] + ".json")))


@dataclass
class Tree:
    """The project tree of a run and the inputs the reference reads."""

    root: str
    cams_norm: cam.Camera  # normalized, float64, as the program reads the rig file
    ids: tuple
    full_height: int
    colors: dict  # frame -> level -> (N, H, W, 3) uint16, the values the PNGs hold
    truth: dict  # frame -> (N, H, W) true disparity at the finest level written
    # image type -> frame (PLATE_FRAME for a plate's layer) -> level -> (N, H, W)
    # bool masks or float32 maps, the values the files hold
    inputs: dict

    def inputs_of(self, frame: str) -> dict:
        """{image type: {level: array}}: the layers a job of ``frame`` reads, masks of that frame, the plate's."""
        return {t: by_frame[PLATE_FRAME if t in PLATE_INPUTS else frame] for t, by_frame in self.inputs.items()}


def _write_input(pool, root: str, image_type: str, level: int, ids, frame: str, arr: np.ndarray) -> list:
    sub, ext = INPUT_LAYERS[image_type]
    writer = pngio.write_gray8 if ext == "png" else pngio.write_pfm
    writes = []
    for i, cid in enumerate(ids):
        d = os.path.join(root, sub, f"level_{level}", cid)
        os.makedirs(d, exist_ok=True)
        writes.append(pool.submit(writer, os.path.join(d, f"{frame}.{ext}"), arr[i]))
    return writes


def make_tree(c: Cell, root: str, seed: int, device, pool) -> Tree:
    """Render the cell's frames from ``seed`` on ``device`` and write them (and the rig) as a project tree."""
    import torch

    maker = load_module(os.path.join(BASE, "rigs", c.config["rig"]["maker"] + ".py"))
    scene = load_module(os.path.join(BASE, "scenes", c.cell["scene"] + ".py"))
    cams64, ids = maker.make(c.config["rig"])
    text = cam.rig_json_text(cams64, ids)
    os.makedirs(os.path.join(root, "rigs"))
    with open(os.path.join(root, "rigs", "rig_calibrated.json"), "w") as f:
        f.write(text)
    cams, ids = cam.load_rig_text(text)
    cams_norm = cam.normalize(cams)
    render_cams = cams_norm.to(device, torch.float32)
    colors, truth, writes = {}, {}, []
    finest = c.levels[0]
    for k, frame in enumerate(c.frames, start=1):
        colors[frame] = {}
        for level in c.levels:
            rgb, gt = scene.render(render_cams, c.size(level), seed, k)
            u16 = (rgb.clamp(0.0, 1.0) * 65535.0 + 0.5).to(torch.int32).cpu().numpy().astype(np.uint16)
            colors[frame][level] = u16
            if level == finest:
                truth[frame] = gt.cpu().numpy()
            for i, cid in enumerate(ids):
                d = os.path.join(root, "video", "color_levels", f"level_{level}", cid)
                os.makedirs(d, exist_ok=True)
                writes.append(pool.submit(pngio.write_rgb16, os.path.join(d, frame + ".png"), u16[i]))
    # the input layers: a frame's (masks) from its own frame, the plate's (the background) from frame 0
    inputs = {t: {} for t in c.inputs}
    frame_types = [t for t in c.inputs if t not in PLATE_INPUTS]
    plate_types = [t for t in c.inputs if t in PLATE_INPUTS]
    plan = [(k, frame, frame_types) for k, frame in enumerate(c.frames, start=1)] + [(0, PLATE_FRAME, plate_types)]
    for k, frame, types in plan:
        for level in c.levels if types else ():
            layers = scene.render_inputs(render_cams, c.size(level), seed, k)
            for t in types:
                arr = layers[t].cpu().numpy().astype(bool if INPUT_LAYERS[t][1] == "png" else np.float32)
                inputs[t].setdefault(frame, {})[level] = arr
                writes += _write_input(pool, root, t, level, ids, frame, arr)
    for w in writes:
        w.result()
    # the warm-up job's frame: the first frame's files under a name the window does not use
    for sub, ext in [("video/color_levels", "png")] + [INPUT_LAYERS[t] for t in frame_types]:
        for level in c.levels:
            for cid in ids:
                d = os.path.join(root, sub, f"level_{level}", cid)
                src, dst = os.path.join(d, f"{c.frames[0]}.{ext}"), os.path.join(d, f"{WARMUP_FRAME}.{ext}")
                try:
                    os.link(src, dst)
                except OSError:
                    shutil.copyfile(src, dst)
    return Tree(root, cams_norm, ids, int(cams.resolution[0, 1]), colors, truth, inputs)


def tree_bytes(root: str) -> int:
    """Bytes of the files under ``root``, a hard-linked file once."""
    sizes = {}
    for d, _, files in os.walk(root):
        for f in files:
            st = os.stat(os.path.join(d, f))
            sizes[st.st_ino] = st.st_size
    return sum(sizes.values())


@dataclass
class Job:
    frame: str
    seconds: float  # the job alone, without the read-back of its maps
    level_seconds: dict
    maps: dict  # judged level -> (D, H, W) maps the job wrote


def solve(c: Cell, tree: Tree, out: str, frame: str, device) -> dict:
    """The system under test: one ``derp_cli`` job of ``frame`` into ``out``; its per-level wall seconds."""
    return program.job(tree.root, out, frame, frame, c.flags(), device)


def run_job(c: Cell, tree: Tree, out: str, frame: str, device) -> Job:
    """One job, then the read-back of its judged maps and the deletion of its output.
    The job alone is the trace's job range."""
    import torch
    from torch.profiler import record_function

    t = time.perf_counter()
    with record_function(trace.JOB_RANGE):
        ls = solve(c, tree, out, frame, device)
        if device.type == "cuda":
            torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    maps = {}
    for level in c.judged:
        w, h = c.size(level)
        maps[level] = judge.read_maps(out, level, tree.ids, frame, (h, w))
    shutil.rmtree(out, ignore_errors=True)
    return Job(frame, seconds, ls, maps)


def measured_window(c: Cell, tree: Tree, work: str, seconds: float, device):
    """(jobs, the window's seconds, its start, its wall seconds). The window's
    clock runs while a job runs: the harness's read-back of a job's maps
    between two jobs is not the program's time. Jobs start while the window
    has run less than ``seconds``, and the last one finishes."""
    jobs, span = [], 0.0
    t_open = time.perf_counter()
    while not jobs or span < seconds:
        k = len(jobs)
        jobs.append(run_job(c, tree, os.path.join(work, "out", f"job{k:03d}"), c.frames[k % len(c.frames)], device))
        span += jobs[-1].seconds
    return jobs, span, t_open, time.perf_counter() - t_open


def traced_jobs(c: Cell, tree: Tree, work: str, device):
    """(jobs, TraceData) of ``trace_jobs`` whole jobs under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    jobs = []
    with profile(activities=acts) as prof:
        for k in range(c.cell["trace_jobs"]):
            jobs.append(run_job(c, tree, os.path.join(work, "out", f"job{k:03d}"), c.frames[k % len(c.frames)], device))
        t = time.perf_counter()
    log(f"depbench: profiler stopped in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    frames = len(jobs) * c.cell["frames_per_job"]
    td = trace.collect(prof, {lv: c.size(lv) for lv in c.levels}, [j.level_seconds for j in jobs], frames,
                       len(tree.ids), c.levels[0])
    del prof
    log(f"depbench: trace post-processing {time.perf_counter() - t:.3f} s ({len(td.kernels)} kernels, "
        f"{len(td.host_ops)} host ops)")
    return jobs, td


def reference_inputs(c: Cell, tree: Tree, frame: str) -> dict:
    """The keywords that hand the reference a frame's input layers: none for a cell that lists none."""
    return {"inputs": tree.inputs_of(frame)} if c.inputs else {}


def judge_jobs(c: Cell, tree: Tree, jobs: list[Job], device):
    """Per-job stats of the finest and the coarsest level against the
    reference, and the reference's maps ({frame: {level: (D, H, W)}})."""
    ref = load_module(os.path.join(BASE, "reference", c.cell["reference"] + ".py"))
    sizes = {lv: c.size(lv) for lv in c.levels}
    refs = {}
    for frame in sorted({j.frame for j in jobs}):
        t = time.perf_counter()
        refs[frame] = ref.solve_pyramid(tree.cams_norm, tree.colors[frame], sizes, tree.full_height,
                                        float(c.config["min_depth_m"]), float(c.config["max_depth_m"]), device,
                                        keep=c.judged, **reference_inputs(c, tree, frame))
        log(f"depbench: reference of frame {frame}: {time.perf_counter() - t:.2f} s")
    rel_tol = c.cell["compare"]["rel_tol"]
    stats = [{tag: judge.off_stats(j.maps[level], refs[j.frame][level], rel_tol)
              for tag, level in zip(("finest", "coarsest"), c.judged)} for j in jobs]
    return stats, refs


def level_needs(c: Cell, tree: Tree, seed: int, device) -> dict:
    """level -> what K1's and K3's inputs need there, at the true disparity of the scene's first frame."""
    import torch

    scene = load_module(os.path.join(BASE, "scenes", c.cell["scene"] + ".py"))
    cams = tree.cams_norm.to(device, torch.float32)
    needs = {}
    for level in c.levels:
        _, truth = scene.render(cams, c.size(level), seed, 1)
        needs[level] = coverage.level_needs(tree.cams_norm, c.size(level), truth)
        del truth
    return needs


def compared_numbers(stats: list[dict]) -> dict:
    """The numbers ``correct`` compares: the worst job's off share at the finest and the coarsest level."""
    return {f"{tag}_off_share": max(s[tag]["off_share"] for s in stats) for tag in ("finest", "coarsest")}


def smi_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run(c: Cell, seed: int, seconds: float, traced: bool, device, started: float) -> dict:
    """One run of cell ``c`` on ``device``; ``started`` is the process's
    start on the perf_counter clock. Returns the result (without printing it)."""
    import torch

    cuda = device.type == "cuda"
    os.makedirs(WORK, exist_ok=True)
    work = tempfile.mkdtemp(prefix=c.name + ".", dir=WORK)
    try:
        with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 1)) as pool:
            t = time.perf_counter()
            tree = make_tree(c, os.path.join(work, "tree"), seed, device, pool)
            log(f"depbench: scene rendered and tree written in {time.perf_counter() - t:.2f} s "
                f"({tree_bytes(tree.root) / 1e9:.3f} GB)")
        warm = run_job(c, tree, os.path.join(work, "out", "warmup"), WARMUP_FRAME, device)
        log(f"depbench: warm-up job {warm.seconds:.2f} s")
        t = time.perf_counter()
        os.sync()
        log(f"depbench: set-up's files flushed in {time.perf_counter() - t:.3f} s")
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        metrics, extra = {}, {}
        if traced:
            jobs, td = traced_jobs(c, tree, work, device)
            frames = len(jobs) * c.cell["frames_per_job"]
            log(f"depbench: traced frame_s {sum(j.seconds for j in jobs) / frames:.4f} s/frame "
                f"over {len(jobs)} job(s)")
        else:
            jobs, span, t_open, wall = measured_window(c, tree, work, seconds, device)
            frames = len(jobs) * c.cell["frames_per_job"]
            e2e = {"frame_s": span / frames,
                   "peak_gib": torch.cuda.max_memory_allocated() / GIB if cuda else float("nan"),
                   "setup_s": t_open - started}
            for m in c.metrics("end_to_end"):
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
            lat = sorted(j.seconds for j in jobs)
            log(f"depbench: {len(jobs)} jobs in {span:.3f} s; job seconds median {statistics.median(lat):.3f}, "
                f"min {lat[0]:.3f}, max {lat[-1]:.3f}; read-back and deletion {wall - span:.3f} s")
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        found = forbidden_modules()
        if found:
            return {"forbidden": found}
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        if traced:
            t = time.perf_counter()
            td.needs = level_needs(c, tree, seed, device)
            log(f"depbench: the levels' needs counted in {time.perf_counter() - t:.3f} s")
            for m in c.metrics("per_layer"):
                v = load_module(os.path.join(BASE, "metrics", m["name"] + ".py")).read(td)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            extra["breakdown"] = trace.breakdown(td)
            busy_s, window_s = td.busy_ns() / 1e9, td.window_ns() / 1e9
            del td
        stats, refs = judge_jobs(c, tree, jobs, device)
        for frame in refs:
            maps = [j for j in jobs if j.frame == frame][-1].maps[c.levels[0]]
            log(f"depbench: frame {frame} finest level median relative error against the truth "
                f"{judge.interior_median_rel_error(maps, tree.truth[frame]):.5f} (program), "
                f"{judge.interior_median_rel_error(refs[frame][c.levels[0]], tree.truth[frame]):.5f} (reference)")
        for k, (j, s) in enumerate(zip(jobs, stats)):
            log(f"depbench: job {k} frame {j.frame} {j.seconds:.3f} s: " + ", ".join(
                f"{tag} off {v['off_share']:.6g} median {v['median_rel']:.3g} p99 {v['p99_rel']:.3g}"
                for tag, v in s.items()))
        limits = c.cell["compare"]["limits"]
        numbers = compared_numbers(stats)
        failed = sum(any(s[tag]["off_share"] > limits[f"{tag}_off_share"] for tag in ("finest", "coarsest"))
                     for s in stats)
        device_info = {"platform": "gpu" if cuda else device.type,
                       "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                       "count": 1, "memory_peak_bytes": peak}
        if traced:
            device_info.update(busy_s=busy_s, window_s=window_s)
        result = {"correct": failed == 0 and all(numbers[k] <= limits[k] for k in numbers),
                  "attempted": len(jobs), "failed": failed, "metrics": metrics, "device": device_info}
        result.update(extra)
        result["compared"] = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv, started: float) -> int:
    import argparse

    p = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    c = find_cell(args.workload, load_json(os.path.join(ROOT, "BENCHMARK.json")))
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.workload["chips"]:
        log(f"depbench: the cell needs {c.workload['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 2
    log(f"depbench: {c.name} seed {args.seed} trace {args.trace} on {smi_line()}")
    result = run(c, args.seed, args.seconds, bool(args.trace), torch.device("cuda"), started)
    found = forbidden_modules() or result.get("forbidden")
    if found:
        log(f"depbench: modules of JAX or the JAX package are loaded: {found}")
        return 3
    for k, v in result["compared"].items():
        log(f"compared {k} {v['value']:.6g} limit {v['limit']:.6g}")
    print(json.dumps(result), flush=True)
    return 0
