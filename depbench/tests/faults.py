"""Faults planted in the program underneath the timed path, once for each a
cell of one chip can have: a step that returns its state unchanged, half of
the batch left out with the mean of the rest in its place, an answer altered
where it is produced. The exchange between chips does not exist in these
cells. Used by ``test_depbench_faults.py`` and, at a cell's own size on the
card, by ``calibrate.py --harness-runs``."""

from __future__ import annotations

import numpy as np
import torch


def _unchanged_step(patch):
    """Ping-pong returns its state unchanged."""
    from facebook360_dep_tpu_torch.depth import solver

    patch(solver, "ping_pong", lambda ctx, cfg, d, c, f: (d, c, f))


def _half_batch(patch):
    """Half of the destinations solved, the other half given the mean of theirs."""
    from facebook360_dep_tpu_torch.depth import solver

    orig = solver.process_level

    def half(ctx, cfg, init_disparity=None, **kw):
        d = len(ctx.dst2src)
        keep = list(range((d + 1) // 2))
        out = orig(solver.select_destinations(ctx, keep), cfg,
                   None if init_disparity is None else init_disparity[keep], **kw)
        res = {}
        for k, v in out.items():
            fill = v.to(torch.float32).nanmean(dim=0, keepdim=True).expand((d - len(keep),) + v.shape[1:])
            res[k] = torch.cat([v, fill.to(v.dtype)])
        return res

    patch(solver, "process_level", half)


def _altered_answer(patch):
    """One destination's finest map written 5% off."""
    from facebook360_dep_tpu_torch.depth import pipeline

    orig = pipeline.DepthEstimator.save_results

    def altered(self, level, frame, result):
        if level == 0:
            d = np.array(result["disparity"])
            d[0] *= np.float32(1.05)
            result = {**result, "disparity": d}
        orig(self, level, frame, result)

    patch(pipeline.DepthEstimator, "save_results", altered)


FAULTS = {"unchanged_step": _unchanged_step, "half_batch": _half_batch, "altered_answer": _altered_answer}


def plant(name: str, patch) -> None:
    """Plant fault ``name`` with ``patch(obj, attribute, value)`` (pytest's ``monkeypatch.setattr``)."""
    FAULTS[name](patch)
