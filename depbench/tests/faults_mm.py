"""Faults planted in the program's mismatch stage, underneath the timed path
of a mismatch cell: each leaves the rest of the solve as it is. Used by the
CPU tests of the stage and, at ``sphere16.mismatch2k``'s own size on the
card, by ``calibrate.py --harness-runs`` once :func:`register` has added
them to ``faults.FAULTS``. From the root of a checkout, in Python::

    from depbench.tests import faults_mm
    from depbench import calibrate
    faults_mm.register()
    calibrate.main(["--workload", "sphere16.mismatch2k", "--harness-runs", "mm_skipped:<seed>"])
"""

from __future__ import annotations

import math


def _skipped(patch):
    """The stage returns its input: no pixel is replaced."""
    import torch

    from facebook360_dep_tpu_torch.depth import solver

    def skipped(ctx, cfg, disparity, full_disparity=None):
        disparity = disparity.to(torch.float32)
        return disparity, torch.zeros(disparity.shape, dtype=torch.bool, device=disparity.device)

    patch(solver, "handle_mismatches", skipped)


def _near_median(patch):
    """The median of the mismatched disparities counted from the near end of
    their sorted lanes, not from the far end."""
    import torch

    from facebook360_dep_tpu_torch.depth import solver
    from facebook360_dep_tpu_torch.ops import cost as cost_ops

    def near(ctx, disp, d_srcs, valid, dsts):
        # the program's _replace_mismatches but for the median's index
        frac = 0.1
        disp, d_srcs = disp[dsts], d_srcs[dsts]
        n = d_srcs.shape[1]
        lanes = torch.arange(n, device=disp.device)[None, :, None, None]
        self_idx = torch.as_tensor(ctx.dst2src[dsts], device=disp.device)[:, None, None, None]
        valids = valid[dsts] & (lanes != self_idx) & torch.isfinite(d_srcs)
        lo, hi = ((1 - frac) * disp)[:, None], ((1 + frac) * disp)[:, None]
        is_match = valids & (d_srcs >= lo) & (d_srcs <= hi)
        is_mismatch = valids & ~is_match
        num_match = is_match.sum(dim=1)
        num_mismatch = is_mismatch.sum(dim=1)
        total = num_match + num_mismatch
        mm_sorted = torch.sort(torch.where(is_mismatch, d_srcs, math.inf), dim=1).values
        closer = (is_mismatch & (d_srcs < disp[:, None])).sum(dim=1)
        median_idx = torch.clamp(num_mismatch - 1 - closer // 2, 0, n - 1)
        median_val = torch.gather(mm_sorted, 1, median_idx[:, None])[:, 0]
        variance = ctx.dst_variance[dsts]
        keep = ((total == 0) | (num_match >= cost_ops.MIN_OVERLAPPING_CAMS - 1)
                | (variance > ctx.var_high_thresh) | (variance < ctx.var_noise_floor))
        replace = ~keep & ctx.dst_fov_masks[dsts] & ctx.dst_fg_masks[dsts]
        return torch.where(replace, torch.minimum(disp, median_val), disp), replace

    patch(solver, "_replace_mismatches", near)


def _no_variance_gate(patch):
    """The variance band is dropped: a pixel is replaced whatever its variance."""
    from facebook360_dep_tpu_torch.depth import solver

    orig = solver.handle_mismatches

    def ungated(ctx, cfg, disparity, full_disparity=None):
        return orig(ctx._replace(var_noise_floor=-math.inf, var_high_thresh=math.inf), cfg, disparity,
                    full_disparity)

    patch(solver, "handle_mismatches", ungated)


FAULTS = {"mm_skipped": _skipped, "mm_near_median": _near_median, "mm_no_variance_gate": _no_variance_gate}


def plant(name: str, patch) -> None:
    """Plant fault ``name`` with ``patch(obj, attribute, value)`` (pytest's ``monkeypatch.setattr``)."""
    FAULTS[name](patch)


def register() -> None:
    """Add these faults to ``faults.FAULTS``, where ``calibrate.py --harness-runs`` finds them by name."""
    from depbench.tests import faults

    faults.FAULTS.update(FAULTS)
