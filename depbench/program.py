"""The system under test: one ``derp_cli`` frame job of the PyTorch/CUDA port.

The only module of the benchmark that imports the program. A job is what a
farm worker runs for each chunk it is given: ``derp_cli.main`` over the
frames ``first``..``last`` of a project tree, every level from the coarsest
to the finest solved, to the last PFM written.
"""

from __future__ import annotations


def job(input_root: str, output_root: str, first: str, last: str, flags: list[str], device) -> dict:
    """Run one job; returns its per-level wall seconds (``DepthEstimator.level_seconds``)."""
    from facebook360_dep_tpu_torch.cli import derp_cli

    est = derp_cli.main(["--input_root", input_root, "--output_root", output_root,
                         "--first", first, "--last", last, *flags], device=device)
    return dict(est.level_seconds)
