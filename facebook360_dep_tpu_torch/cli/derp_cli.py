"""DerpCLI equivalent: coarse-to-fine multi-view disparity estimation.

Flag names mirror the reference binary (``depth_estimation/DerpCLI.cpp:40-67``)
and the JAX package's CLI, including its three multi-host flags. Every
option runs: the background-constrained solve (``--use_foreground_masks``
with ``--background_disp``), the debug images, plotMatches and the
profiler trace. Only a coordinator address raises, until the multi-GPU
path exists.

    python -m facebook360_dep_tpu_torch.cli.derp_cli --input_root <root> \
        --output_root <out> [--min_depth_m 1 --max_depth_m 100 --resolution 2048]
    # a foreground solve over a static background's solve
    python -m facebook360_dep_tpu_torch.cli.derp_cli --input_root <root> \
        --output_root <out> --use_foreground_masks true \
        --background_disp <background out>/disparity_levels --first 000000 --last 000002
"""

from __future__ import annotations

import argparse
import logging

from ..depth.pipeline import DepthEstimator, DepthEstimatorOptions


def str2bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "y")


def add_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--input_root", required=True, help="path to input data")
    p.add_argument("--output_root", required=True, help="path to output directory")
    p.add_argument("--rig", default="", help="path to camera rig .json")
    p.add_argument("--color", default="", help="path to input color images")
    p.add_argument("--background_disp", default="", help="path to background disparities")
    p.add_argument("--background_frame", default="000000")
    p.add_argument("--foreground_masks", default="", help="path to foreground masks")
    p.add_argument("--cameras", default="", help="comma-separated destinations (empty = all)")
    p.add_argument("--first", default="000000", help="first frame to process (lexical)")
    p.add_argument("--last", default="000000", help="last frame to process (lexical)")
    p.add_argument("--level_start", type=int, default=-1, help="level to start at (-1 = coarsest)")
    p.add_argument("--level_end", type=int, default=-1, help="level to end at (-1 = finest)")
    p.add_argument("--num_levels", type=int, default=-1)
    p.add_argument("--min_depth_m", type=float, default=0.5)
    p.add_argument("--max_depth_m", type=float, default=1e4)
    p.add_argument("--mismatches_start_level", type=int, default=-1)
    p.add_argument("--output_formats", default="", help="png, pfm (comma separated)")
    p.add_argument("--partial_coverage", type=str2bool, default=False)
    p.add_argument("--ping_pong_iterations", type=int, default=1)
    p.add_argument("--random_proposals", type=int, default=2)
    p.add_argument("--fast_fine_levels", type=int, default=0,
                   help="N finest levels use the convergence-aware schedule "
                        "(axis-only star + --fast_fine_random_proposals); "
                        "0 = reference-shaped schedule everywhere")
    p.add_argument("--fast_fine_random_proposals", type=int, default=1)
    p.add_argument("--resolution", type=int, default=2048, help="output resolution (width px)")
    p.add_argument("--use_foreground_masks", type=str2bool, default=False)
    p.add_argument("--var_high_thresh", type=float, default=1e-3)
    p.add_argument("--var_noise_floor", type=float, default=4e-5)
    p.add_argument("--do_bilateral_filter", type=str2bool, default=True)
    p.add_argument("--do_median_filter", type=str2bool, default=True)
    p.add_argument("--save_debug_images", type=str2bool, default=False)
    p.add_argument("--debug_dir", default="", help="plotMatches output dir (Derp.cpp:28-70)")
    p.add_argument("--debug_plot_match_dst", default="")
    p.add_argument("--debug_plot_match_x", type=int, default=-1)
    p.add_argument("--debug_plot_match_y", type=int, default=-1)
    p.add_argument("--debug_plot_match_level", type=int, default=-1)
    p.add_argument("--threads", type=int, default=-1, help="accepted for flag parity (unused)")
    p.add_argument("--profile_dir", default="", help="torch.profiler chrome-trace directory")
    # multi-host flags (parallel/multihost.py in the JAX package)
    p.add_argument("--coordinator_address", default="",
                   help="host:port of process 0 for a multi-process run (not ported yet)")
    p.add_argument("--num_processes", type=int, default=-1, help="total processes (-1 = auto)")
    p.add_argument("--process_id", type=int, default=-1, help="this process's rank (-1 = auto)")


def options_from_args(args) -> DepthEstimatorOptions:
    fields = DepthEstimatorOptions.__dataclass_fields__
    return DepthEstimatorOptions(**{k: v for k, v in vars(args).items() if k in fields})


def main(argv=None, *, device=None) -> DepthEstimator:
    """Parse ``argv``, run the estimator on ``device`` (None: the card), and
    return it (its ``level_seconds`` holds the per-level wall times)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    add_flags(p)
    args = p.parse_args(argv)
    if args.coordinator_address:
        raise NotImplementedError("--coordinator_address: the multi-GPU path is not ported yet")
    estimator = DepthEstimator(options_from_args(args), device=device)
    estimator.run()
    return estimator


if __name__ == "__main__":
    main()
