"""Full-pipeline orchestrator: the render.py farm entry equivalent.

Assembles the reference's standard stage list (scripts/render/render.py:
190-216 + pipeline.py stage bodies) over the chunked farm runner:

  resize levels -> [foreground masks -> resize masks] -> depth estimation
  (per level, coarse->fine, optional temporal filter) -> upsample ->
  [convert_to_binary -> fusion] or [exports]

Every stage runs the port's CLI modules as subprocesses (``python -m
facebook360_dep_tpu_torch.cli.<module>``) with the same flag dicts a farm
worker would receive, with missing-chunk resume. The stage list is the JAX
package's, plus the mask resize that its list leaves out: with
``--use_foreground_masks`` the masks go through ``resize_images
--threshold 0.5`` into ``video/foreground_masks_levels``, which the depth
stage reads. The orchestrator itself stays on the host and never touches
the card; each stage's device comes from the environment its subprocess
inherits (``DEP_TORCH_DEVICE``, see ``cli/__init__.py``).

    python -m facebook360_dep_tpu_torch.cli.render_pipeline --input_root <root> --output_root <root> \
        --first 000000 --last 000009 --resolution 2048 --format eqrcolor
"""

from __future__ import annotations

import argparse
import logging
import os

from ..core import camera as cam, imagetypes, io
from ..farm import runner

log = logging.getLogger("render_pipeline")


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_root", required=True)
    p.add_argument("--output_root", required=True)
    p.add_argument("--rig", default="")
    p.add_argument("--first", default="000000")
    p.add_argument("--last", default="000000")
    p.add_argument("--format", default="6dof", choices=["6dof", "eqrcolor", "eqrdisp", "cubecolor", "cubedisp", "lr180", "tb3dof", "tbstereo"])
    p.add_argument("--chunk_size", type=int, default=1)
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--resolution", type=int, default=2048)
    p.add_argument("--min_depth_m", type=float, default=0.5)
    p.add_argument("--max_depth_m", type=float, default=1e4)
    p.add_argument("--use_foreground_masks", type=lambda v: str(v).lower() in ("1", "true"), default=False)
    p.add_argument("--do_temporal_filter", type=lambda v: str(v).lower() in ("1", "true"), default=False)
    p.add_argument("--force_recompute", type=lambda v: str(v).lower() in ("1", "true"), default=False)
    p.add_argument("--run_depth_estimation", type=lambda v: str(v).lower() in ("1", "true"), default=True)
    p.add_argument("--run_convert_to_binary", type=lambda v: str(v).lower() in ("1", "true"), default=True)
    p.add_argument("--run_fusion", type=lambda v: str(v).lower() in ("1", "true"), default=True)
    p.add_argument("--run_generate_foreground_masks",
                   type=lambda v: str(v).lower() in ("1", "true"), default=True,
                   help="gate the mask stage (also requires --use_foreground_masks)")
    p.add_argument("--run_precompute_resizes",
                   type=lambda v: str(v).lower() in ("1", "true"), default=True)
    p.add_argument("--master", default="", help=(
        "accepted for render.flags parity: the reference's RabbitMQ master "
        "IP; this farm's control plane is a shared-filesystem broker "
        "(--queue_dir), which has no host address"))
    p.add_argument("--queue_dir", default="", help=(
        "shared-filesystem broker root: publish chunk jobs for standalone "
        "farm.worker processes on any host instead of running locally "
        "(the reference's RabbitMQ master role, pipeline.py:173-248)"))
    p.add_argument("--no_worker_timeout", type=float, default=0.0,
                   help="seconds without live workers before aborting (0 = broker default 180)")
    args = p.parse_args(argv)

    rig_path = args.rig or os.path.join(args.input_root, "rigs/rig_calibrated.json")
    rig = cam.load_rig(rig_path)
    chunks = runner.chunk_frames(int(args.first), int(args.last), args.chunk_size)
    color_levels = imagetypes.image_dir(args.input_root, "color_levels")
    disparity_levels = imagetypes.image_dir(args.output_root, "disparity_levels")
    stages = []

    def per_cam_frames(directory, ext):
        def outputs(chunk):
            return [
                os.path.join(directory, cid, f + ext) for cid in rig.ids for f in chunk.frames()
            ]

        return outputs

    # resize stage: only if levels are absent but full-res color exists
    full_color = imagetypes.image_dir(args.input_root, "color")
    if (args.run_precompute_resizes
            and not os.path.isdir(os.path.join(color_levels, "level_0"))
            and os.path.isdir(full_color)):
        stages.append(
            runner.Stage(
                name="precompute_resizes",
                outputs=per_cam_frames(os.path.join(color_levels, "level_0"), ".png"),
                command=lambda c: runner.python_module_command(
                    "resize_images",
                    {"rig": rig_path, "color": full_color, "output": color_levels,
                     "first": c.frames()[0], "last": c.frames()[-1]},
                ),
            )
        )

    if args.use_foreground_masks and args.run_generate_foreground_masks:
        fg = imagetypes.image_dir(args.input_root, "foreground_masks")
        stages.append(
            runner.Stage(
                name="generate_foreground_masks",
                outputs=per_cam_frames(fg, ".png"),
                command=lambda c: runner.python_module_command(
                    "generate_foreground_masks",
                    {
                        "rig": rig_path,
                        "color": full_color,
                        "background_color": imagetypes.image_dir(args.input_root, "background_color"),
                        "foreground_masks": fg,
                        "first": c.frames()[0],
                        "last": c.frames()[-1],
                    },
                ),
            )
        )

    if args.use_foreground_masks:
        # masks to every level width, binarized, where the depth stage
        # reads them (the JAX stage list leaves this stage out)
        fg = imagetypes.image_dir(args.input_root, "foreground_masks")
        fg_levels = imagetypes.image_dir(args.input_root, "foreground_masks_levels")
        stages.append(
            runner.Stage(
                name="precompute_resizes_foreground",
                outputs=per_cam_frames(os.path.join(fg_levels, "level_0"), ".png"),
                command=lambda c: runner.python_module_command(
                    "resize_images",
                    {"rig": rig_path, "color": fg, "output": fg_levels, "threshold": 0.5,
                     "first": c.frames()[0], "last": c.frames()[-1]},
                ),
            )
        )

    if args.run_depth_estimation:
        stages.append(
            runner.Stage(
                name="depth_estimation",
                outputs=per_cam_frames(os.path.join(disparity_levels, "level_0"), ".pfm"),
                command=lambda c: runner.python_module_command(
                    "derp_cli",
                    {
                        "input_root": args.input_root,
                        "output_root": args.output_root,
                        "rig": rig_path,
                        "first": c.frames()[0],
                        "last": c.frames()[-1],
                        "resolution": args.resolution,
                        "min_depth_m": args.min_depth_m,
                        "max_depth_m": args.max_depth_m,
                        "use_foreground_masks": args.use_foreground_masks,
                    },
                ),
            )
        )

    if args.do_temporal_filter:
        tf_dir = imagetypes.image_dir(args.output_root, "disparity_time_filtered_levels")
        stages.append(
            runner.Stage(
                name="temporal_filter",
                outputs=per_cam_frames(os.path.join(tf_dir, "level_0"), ".pfm"),
                command=lambda c: runner.python_module_command(
                    "temporal_bilateral_filter",
                    {
                        "input_root": args.input_root,
                        "output_root": args.output_root,
                        "rig": rig_path,
                        "first": c.frames()[0],
                        "last": c.frames()[-1],
                        "level": 0,
                        "use_foreground_masks": args.use_foreground_masks,
                    },
                ),
            )
        )

    disp_src = (
        os.path.join(imagetypes.image_dir(args.output_root, "disparity_time_filtered_levels"), "level_0")
        if args.do_temporal_filter
        else os.path.join(disparity_levels, "level_0")
    )

    if args.format == "6dof" and args.run_convert_to_binary:
        bin_dir = imagetypes.image_dir(args.output_root, "bin")
        fused_dir = imagetypes.image_dir(args.output_root, "fused")
        stages.append(
            runner.Stage(
                name="convert_to_binary",
                outputs=per_cam_frames(bin_dir, ".vtx"),
                command=lambda c: runner.python_module_command(
                    "convert_to_binary",
                    {
                        "rig": rig_path,
                        "bin": bin_dir,
                        "disparity": disp_src,
                        "color": os.path.join(color_levels, "level_0"),
                        "first": c.frames()[0],
                        "last": c.frames()[-1],
                    },
                ),
            )
        )
        if args.run_fusion:
            stages.append(
                runner.Stage(
                    name="fusion",
                    outputs=lambda c: [os.path.join(fused_dir, "fused.json")],
                    command=lambda c: runner.python_module_command(
                        "convert_to_binary",
                        {
                            "rig": rig_path,
                            "bin": bin_dir,
                            "fused": fused_dir,
                            "run_conversion": "false",
                            "first": io.frame_name(int(args.first)),
                            "last": io.frame_name(int(args.last)),
                        },
                    ),
                )
            )
    elif args.format != "6dof":
        export_dir = imagetypes.image_dir(args.output_root, f"exports_{args.format}")
        stages.append(
            runner.Stage(
                name=f"export_{args.format}",
                outputs=lambda c: [os.path.join(export_dir, f + ".png") for f in c.frames()],
                command=lambda c: runner.python_module_command(
                    "simple_mesh_renderer",
                    {
                        "rig": rig_path,
                        "color": os.path.join(color_levels, "level_0"),
                        "disparity": disp_src,
                        "output": export_dir,
                        "format": args.format,
                        "first": c.frames()[0],
                        "last": c.frames()[-1],
                    },
                ),
            )
        )

    if args.queue_dir:
        pipeline = runner.DistributedPipeline(
            args.queue_dir,
            force_recompute=args.force_recompute,
            no_worker_timeout=args.no_worker_timeout or None,
        )
    else:
        pipeline = runner.Pipeline(workers=args.workers, force_recompute=args.force_recompute)
    pipeline.run(stages, chunks)


if __name__ == "__main__":
    main()
