"""Project driver: the UI's tab workflows as subcommands.

Reference: ``scripts/ui/dep.py:95-278`` — a PyQt app with Background /
Calibration / DepthEstimation / Export tabs wrapping the farm, input
validation (verify_data), progress from logs, and pickled project state.
Headless equivalent: one ``dep`` command per tab over the same project
tree, with state in ``<root>/project.json`` instead of a pickle and
progress via ``log_reader``.

    dep init        --project_root R            create the skeleton + verify
    dep background  --project_root R [--frame F] depth on the background frame
    dep calibration --project_root R [--frame F] match corners + calibrate
    dep depth       --project_root R --first A --last B   video depth (+ masks)
    dep export      --project_root R --format eqrcolor ... offline exports
    dep status      --project_root R            tree check + metric summary

Run as ``python -m facebook360_dep_tpu_torch.cli.dep <command> ...``. The
driver stays on the host: background, depth and export run render_pipeline,
whose stages are subprocesses on the card (or on the CPU with
``DEP_TORCH_DEVICE=cpu`` in their environment); calibration runs in this
process on ``main``'s ``device`` (None: ``DEP_TORCH_DEVICE``, else the card).
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from ..core import camera as cam, imagetypes
from ..farm import runner
from . import render_pipeline, verify_data

log = logging.getLogger("dep")

STATE_FILE = "project.json"


def load_state(root: str) -> dict:
    path = os.path.join(root, STATE_FILE)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_state(root: str, state: dict) -> None:
    with open(os.path.join(root, STATE_FILE), "w") as f:
        json.dump(state, f, indent=2, sort_keys=True)


def _remember(root: str, section: str, values: dict) -> None:
    state = load_state(root)
    state.setdefault(section, {}).update(values)
    save_state(root, state)


def cmd_init(args):
    root = args.project_root
    for t in ("color", "background_color"):
        os.makedirs(imagetypes.image_dir(root, t), exist_ok=True)
    os.makedirs(os.path.join(root, "rigs"), exist_ok=True)
    os.makedirs(os.path.join(root, "logs"), exist_ok=True)
    save_state(root, load_state(root) or {"version": 1})
    problems, info = verify_data.verify_project(root, check_sizes=False)
    for prob in problems:
        log.warning("PROBLEM: %s", prob)
    log.info("project initialized at %s (%d problems)", root, len(problems))
    return 0


def cmd_background(args):
    """Full-quality depth on the background frame (UI Background tab), in
    the tree ``init`` makes: ``background/color`` resized into
    ``background/color_levels``, solved into ``background/disparity_levels``,
    where the foreground solve of ``depth --use_foreground_masks`` reads it.
    (The JAX package's runs render_pipeline on ``<root>/background``, whose
    stages look for ``background/video/color``.)"""
    root = args.project_root
    rig_path = args.rig or os.path.join(root, "rigs/rig_calibrated.json")
    _remember(root, "background", {"frame": args.frame})
    rig = cam.load_rig(rig_path)
    color = imagetypes.image_dir(root, "background_color")
    color_levels = imagetypes.image_dir(root, "background_color_levels")
    disparity_levels = imagetypes.image_dir(root, "background_disp_levels")

    def level0(directory, ext):
        return lambda chunk: [os.path.join(directory, "level_0", cid, f + ext) for cid in rig.ids
                              for f in chunk.frames()]

    def frames(chunk):
        return {"first": chunk.frames()[0], "last": chunk.frames()[-1]}

    stages = [
        runner.Stage(name="precompute_resizes_background", outputs=level0(color_levels, ".png"),
                     command=lambda c: runner.python_module_command(
                         "resize_images", {"rig": rig_path, "color": color, "output": color_levels, **frames(c)})),
        runner.Stage(name="depth_estimation_background", outputs=level0(disparity_levels, ".pfm"),
                     command=lambda c: runner.python_module_command("derp_cli", {
                         "input_root": root, "output_root": os.path.join(root, "background"),
                         "color": color_levels, "rig": rig_path, **frames(c),
                         "resolution": args.resolution, "min_depth_m": args.min_depth_m,
                         "max_depth_m": args.max_depth_m})),
    ]
    frame = int(args.frame)
    runner.Pipeline().run(stages, runner.chunk_frames(frame, frame, 1))


def cmd_calibration(args, device=None):
    from . import calibration as calib_cli

    root = args.project_root
    rig_in = args.rig or os.path.join(root, "rigs/rig.json")
    rig_out = os.path.join(root, "rigs/rig_calibrated.json")
    matches = os.path.join(root, "matches.json")
    _remember(root, "calibration", {"frame": args.frame, "rig_in": rig_in})
    calib_cli.main([
        "--color", imagetypes.image_dir(root, "color"),
        "--rig_in", rig_in,
        "--rig_out", rig_out,
        "--matches", matches,
        "--frame", args.frame,
        "--min_depth_m", str(args.min_depth_m),
        "--max_depth_m", str(args.max_depth_m),
    ], device=device)
    log.info("wrote %s", rig_out)
    return 0


def cmd_depth(args):
    root = args.project_root
    rig = args.rig or os.path.join(root, "rigs/rig_calibrated.json")
    _remember(root, "depth", {"first": args.first, "last": args.last})
    flags = [
        "--input_root", root,
        "--output_root", args.output_root or root,
        "--rig", rig,
        "--first", args.first, "--last", args.last,
        "--resolution", str(args.resolution),
        "--min_depth_m", str(args.min_depth_m),
        "--max_depth_m", str(args.max_depth_m),
        "--use_foreground_masks", str(args.use_foreground_masks).lower(),
        "--do_temporal_filter", str(args.do_temporal_filter).lower(),
        "--workers", str(args.workers),
        "--run_convert_to_binary", "false",
    ]
    return render_pipeline.main(flags)


def cmd_export(args):
    root = args.project_root
    rig = args.rig or os.path.join(root, "rigs/rig_calibrated.json")
    _remember(root, "export", {"format": args.format})
    return render_pipeline.main([
        "--input_root", root,
        "--output_root", args.output_root or root,
        "--rig", rig,
        "--first", args.first, "--last", args.last,
        "--format", args.format,
        "--resolution", str(args.resolution),
        "--run_depth_estimation", "false",
    ])


def cmd_status(args):
    from . import log_reader

    root = args.project_root
    problems, info = verify_data.verify_project(root, check_sizes=False)
    state = load_state(root)
    log.info("state: %s", json.dumps(state, sort_keys=True))
    for prob in problems:
        log.warning("PROBLEM: %s", prob)
    logs_dir = os.path.join(root, "logs")
    if os.path.isdir(logs_dir) and os.listdir(logs_dir):
        log_reader.main(["--logs", logs_dir])
    log.info("status: %d problems, %d color frames",
             len(problems), len(info.get("color_frames", [])))
    return 1 if problems else 0


def main(argv=None, *, device=None):
    """Run one subcommand; returns its exit code (None where render_pipeline
    ran to its end). ``device`` is the in-process calibration's."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(required=True)

    def common(sp, frames=False):
        sp.add_argument("--project_root", required=True)
        sp.add_argument("--rig", default="")
        sp.add_argument("--resolution", type=int, default=2048)
        sp.add_argument("--min_depth_m", type=float, default=0.5)
        sp.add_argument("--max_depth_m", type=float, default=1e4)
        if frames:
            sp.add_argument("--first", default="000000")
            sp.add_argument("--last", default="000000")

    s = sub.add_parser("init"); s.add_argument("--project_root", required=True)
    s.set_defaults(fn=cmd_init)

    s = sub.add_parser("background"); common(s)
    s.add_argument("--frame", default="000000")
    s.set_defaults(fn=cmd_background)

    s = sub.add_parser("calibration"); common(s)
    s.add_argument("--frame", default="000000")
    s.set_defaults(fn=lambda a: cmd_calibration(a, device))

    s = sub.add_parser("depth"); common(s, frames=True)
    s.add_argument("--output_root", default="")
    s.add_argument("--use_foreground_masks", action="store_true")
    s.add_argument("--do_temporal_filter", action="store_true")
    s.add_argument("--workers", type=int, default=1)
    s.set_defaults(fn=cmd_depth)

    s = sub.add_parser("export"); common(s, frames=True)
    s.add_argument("--output_root", default="")
    s.add_argument("--format", default="eqrcolor",
                   choices=["6dof", "eqrcolor", "eqrdisp", "cubecolor", "cubedisp", "lr180", "tb3dof", "tbstereo"])
    s.set_defaults(fn=cmd_export)

    s = sub.add_parser("status"); s.add_argument("--project_root", required=True)
    s.set_defaults(fn=cmd_status)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
