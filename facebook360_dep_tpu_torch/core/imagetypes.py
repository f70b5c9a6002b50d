"""Directory contract: the single source of truth for pipeline stage paths.

Mirrors ``source/util/ImageTypes.h:16-60`` (and its Python twin
``scripts/util/system_util.py:74-108``) so our outputs drop into the exact
tree the reference binaries, farm, and viewers expect.
"""

from __future__ import annotations

import os

IMAGE_TYPE_PATHS: dict[str, str] = {
    "background_color": "background/color",
    "background_color_levels": "background/color_levels",
    "background_disp": "background/disparity",
    "background_disp_levels": "background/disparity_levels",
    "background_disp_upsample": "background/disparity_upsample",
    "bin": "bin",
    "color": "video/color",
    "color_levels": "video/color_levels",
    "confidence": "confidence",
    "cost": "cost",
    "disparity": "disparity",
    "disparity_upsample": "disparity_upsample",
    "disparity_levels": "disparity_levels",
    "disparity_time_filtered": "disparity_time_filtered",
    "disparity_time_filtered_levels": "disparity_time_filtered_levels",
    "exports": "exports",
    "exports_cubecolor": "exports/cubecolor",
    "exports_cubedisp": "exports/cubedisp",
    "exports_eqrcolor": "exports/eqrcolor",
    "exports_eqrdisp": "exports/eqrdisp",
    "exports_lr180": "exports/lr180",
    "exports_tb3dof": "exports/tb3dof",
    "exports_tbstereo": "exports/tbstereo",
    "foreground_masks": "video/foreground_masks",
    "foreground_masks_levels": "video/foreground_masks_levels",
    "fused": "fused",
    "mismatches": "mismatches",
    "video_bin": "video/bin",
    "video_disp": "video/disparity",
    "video_disp_levels": "video/disparity_levels",
    "video_fused": "video/fused",
}

# Default pyramid widths, coarse index 9 .. fine index 0 (scripts/render/config.py:46)
PYRAMID_WIDTHS = [2048, 1024, 512, 256, 200, 128, 100, 80, 60, 50]


def image_dir(root, image_type: str, level: int | None = None, cam_id: str | None = None) -> str:
    """<root>/<type path>[/level_N][/<cam>] (DerpUtil.cpp:278-298)."""
    p = os.path.join(str(root), IMAGE_TYPE_PATHS[image_type])
    if level is not None:
        p = os.path.join(p, f"level_{level}")
    if cam_id is not None:
        p = os.path.join(p, cam_id)
    return p


def gen_filename(root, image_type: str, level: int | None, cam_id: str, frame: str, ext: str) -> str:
    return os.path.join(image_dir(root, image_type, level, cam_id), f"{frame}.{ext}")
