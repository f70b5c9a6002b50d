"""Faults planted in the foreground branches of the program, underneath the
timed path of a foreground cell: each leaves the rest of the solve as it is.
Used by ``test_depbench_fg.py`` and, at ``sphere16.fg2k``'s own size on the
card, by ``calibrate.py --harness-runs`` once :func:`register` has added
them to ``faults.FAULTS``. From the root of a checkout, in Python::

    from depbench.tests import faults_fg
    from depbench import calibrate
    faults_fg.register()
    calibrate.main(["--workload", "sphere16.fg2k", "--harness-runs", "fg_holes_from_plate:<seed>"])

Dropping the proposals' plate floor changes no map of ``sphere_disk`` (no
proposal is accepted inside its masks), so the check cannot see that one;
``test_depbench_fg.py`` says so."""

from __future__ import annotations

import numpy as np


def _no_plate_floor(patch):
    """The random proposals draw from 1 / max depth up, not from the plate up."""
    from facebook360_dep_tpu_torch.depth import solver

    orig = solver.random_proposals

    def unfloored(ctx, cfg, *args, **kw):
        # outside the masks the proposals keep their init, which is the plate there
        return orig(ctx, cfg._replace(has_fg_masks=False), *args, **kw)

    patch(solver, "random_proposals", unfloored)


def _no_ping_pong_floor(patch):
    """Ping-pong takes a neighbour's disparity even where it lies behind the plate."""
    from facebook360_dep_tpu_torch.depth import solver

    orig = solver.ping_pong

    def unfloored(ctx, cfg, *args, **kw):
        # outside the masks ping-pong keeps what the proposals left, which is the plate there
        return orig(ctx, cfg._replace(has_fg_masks=False), *args, **kw)

    patch(solver, "ping_pong", unfloored)


def _holes_from_plate(patch):
    """The holes of the masks keep no value after the upsample, so the plate fills them, not the chamfer."""
    from facebook360_dep_tpu_torch.depth import pipeline

    def own_pixel(valid):
        valid = np.asarray(valid, bool)
        h, w = valid.shape[-2:]
        iy, ix = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        shape = valid.shape
        return np.zeros(shape, np.float32), (np.broadcast_to(iy, shape), np.broadcast_to(ix, shape))

    patch(pipeline, "_nearest_valid_index", own_pixel)


FAULTS = {"fg_no_plate_floor": _no_plate_floor, "fg_no_ping_pong_floor": _no_ping_pong_floor,
          "fg_holes_from_plate": _holes_from_plate}


def plant(name: str, patch) -> None:
    """Plant fault ``name`` with ``patch(obj, attribute, value)`` (pytest's ``monkeypatch.setattr``)."""
    FAULTS[name](patch)


def register() -> None:
    """Add these faults to ``faults.FAULTS``, where ``calibrate.py --harness-runs`` finds them by name."""
    from depbench.tests import faults

    faults.FAULTS.update(FAULTS)
