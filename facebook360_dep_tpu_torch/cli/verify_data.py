"""Project-tree validator: the UI's input-verification layer as a CLI.

Reference: ``scripts/ui/verify_data.py`` (630 LoC) — the PyQt UI refuses to
run stages until the project tree has a rig, consistent color frames, and the
expected level structure. Headless equivalent: walk the tree against the
``imagetypes`` contract and report (and exit non-zero on) problems:

- rig JSON parses and cameras have distinct ids
- every rig camera has a color directory; frame names are zero-padded,
  consistent across cameras; frame range is contiguous
- level directories (if present) cover the same cameras/frames and follow
  the pyramid width schedule
- disparity/foreground-mask trees (if present) match the color frame range
- image sizes agree with the rig resolution (full-size color only)
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from ..core import camera as cam, imagetypes, io

log = logging.getLogger("verify_data")


def list_frames(d):
    try:
        return sorted(
            os.path.splitext(f)[0]
            for f in os.listdir(d)
            if not f.startswith(".") and "." in f
        )
    except FileNotFoundError:
        return []


def check_frame_names(frames, problems, where):
    if not frames:
        return
    widths = {len(f) for f in frames}
    if len(widths) > 1:
        problems.append(f"{where}: inconsistent frame-name padding {sorted(widths)}")
    if not all(f.isdigit() for f in frames):
        problems.append(f"{where}: non-numeric frame names")
        return
    nums = sorted(int(f) for f in frames)
    if nums[-1] - nums[0] + 1 != len(nums):
        problems.append(
            f"{where}: frame range {nums[0]}..{nums[-1]} has gaps ({len(nums)} frames)"
        )


def check_camera_tree(root, image_type, rig, problems, level=None):
    """One image-type dir: every camera present with the same frames."""
    base = imagetypes.image_dir(root, image_type, level)
    if not os.path.isdir(base):
        return None
    per_cam = {}
    for cam_id in rig.ids:
        d = os.path.join(base, cam_id)
        frames = list_frames(d)
        if not frames:
            problems.append(f"{image_type}{'' if level is None else f'/level_{level}'}: no frames for camera {cam_id}")
            continue
        check_frame_names(frames, problems, f"{image_type}/{cam_id}")
        per_cam[cam_id] = frames
    ranges = {tuple(v) for v in per_cam.values()}
    if len(ranges) > 1:
        problems.append(
            f"{image_type}{'' if level is None else f'/level_{level}'}: frame sets differ across cameras"
        )
    return sorted(ranges, key=len)[-1] if ranges else None


def verify_project(root, rig_path=None, check_sizes=True) -> tuple[list, dict]:
    problems, info = [], {}

    # rig
    if rig_path is None:
        rigs_dir = os.path.join(root, "rigs")
        candidates = (
            [os.path.join(rigs_dir, f) for f in sorted(os.listdir(rigs_dir)) if f.endswith(".json")]
            if os.path.isdir(rigs_dir)
            else []
        )
        if not candidates:
            problems.append("no rig JSON found (pass --rig or create <root>/rigs/*.json)")
            return problems, info
        rig_path = candidates[0]
    try:
        rig = cam.load_rig(rig_path)
    except Exception as e:  # noqa: BLE001 — report, don't crash the validator
        problems.append(f"rig {rig_path} failed to parse: {e}")
        return problems, info
    info["rig"] = rig_path
    info["cameras"] = list(rig.ids)
    if len(set(rig.ids)) != len(rig.ids):
        problems.append("rig has duplicate camera ids")

    # full-size color; projects may carry only the level pyramid (e.g. the
    # simulator), in which case level_0 is the frame-range source of truth
    frames = check_camera_tree(root, "color", rig, problems)
    if frames is None:
        frames = check_camera_tree(root, "color_levels", rig, problems, level=0)
    info["color_frames"] = frames or []
    if frames and check_sizes:
        cam_id = rig.ids[0]
        d = imagetypes.image_dir(root, "color", None, cam_id)
        probe = io.first_image_in(d)
        if probe:
            img = io.read_color(os.path.join(d, probe))
            import numpy as np

            res = np.asarray(rig.camera(0).resolution)
            if img.shape[1] != int(res[0]) or img.shape[0] != int(res[1]):
                problems.append(
                    f"color image {img.shape[1]}x{img.shape[0]} != rig resolution {int(res[0])}x{int(res[1])}"
                )

    # color levels follow the pyramid schedule
    levels_base = imagetypes.image_dir(root, "color_levels")
    if os.path.isdir(levels_base):
        level_dirs = sorted(
            int(d.split("_")[1]) for d in os.listdir(levels_base) if d.startswith("level_")
        )
        info["color_levels"] = level_dirs
        # only hold levels to the standard pyramid schedule when level_0
        # actually starts it (custom pyramids are legitimate)
        d0 = imagetypes.image_dir(root, "color_levels", 0, rig.ids[0])
        probe0 = io.first_image_in(d0) if os.path.isdir(d0) else None
        standard = False
        if probe0:
            standard = io.read_color(os.path.join(d0, probe0)).shape[1] == imagetypes.PYRAMID_WIDTHS[0]
        for lvl in level_dirs:
            lvl_frames = check_camera_tree(root, "color_levels", rig, problems, level=lvl)
            if lvl_frames and frames and set(lvl_frames) != set(frames):
                problems.append(f"color_levels/level_{lvl}: frames differ from full-size color")
            d = imagetypes.image_dir(root, "color_levels", lvl, rig.ids[0])
            probe = io.first_image_in(d)
            if standard and probe and lvl < len(imagetypes.PYRAMID_WIDTHS):
                img = io.read_color(os.path.join(d, probe))
                expect = imagetypes.PYRAMID_WIDTHS[lvl]
                if img.shape[1] != expect:
                    problems.append(
                        f"color_levels/level_{lvl}: width {img.shape[1]} != schedule {expect}"
                    )

    # optional trees must track the color frame range
    for t in ("foreground_masks", "video_disp", "disparity", "background_color"):
        t_frames = check_camera_tree(root, t, rig, problems)
        if t_frames is not None:
            info[f"{t}_frames"] = t_frames
            if t == "video_disp" and frames and not set(t_frames) <= set(frames):
                problems.append(f"{t}: contains frames missing from color")

    return problems, info


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--project_root", required=True)
    p.add_argument("--rig", default=None)
    p.add_argument("--skip_size_checks", action="store_true")
    p.add_argument("--json_out", default="", help="write the report as JSON")
    args = p.parse_args(argv)

    problems, info = verify_project(args.project_root, args.rig, not args.skip_size_checks)
    for key, v in info.items():
        log.info("%s: %s", key, v if not isinstance(v, list) else f"{len(v)} entries")
    if problems:
        for prob in problems:
            log.error("PROBLEM: %s", prob)
    else:
        log.info("project tree OK")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"problems": problems, "info": info}, f, indent=2, default=str)
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
