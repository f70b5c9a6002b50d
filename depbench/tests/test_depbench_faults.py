"""The check that decides ``correct``: a run whose timed path is broken underneath comes out
not correct, once for each fault a cell of one chip can have, and the control fails it too.

The cells' exchange between chips does not exist (every cell runs on one chip), so that
fault has no test here. The limits are those of the cells in ``cells/``.
"""

from __future__ import annotations

import json
import os

import pytest

from depbench.tests import faults, helpers

CELLS = sorted(os.listdir(os.path.join(helpers.ROOT, "depbench", "cells")))


def _limits(cell_file):
    with open(os.path.join(helpers.ROOT, "depbench", "cells", cell_file)) as f:
        return json.load(f)["compare"]["limits"]


@pytest.mark.parametrize("cell_file", CELLS)
def test_sound_run_is_correct(cell_file):
    assert helpers.run_cpu("tiny4.small", limits=_limits(cell_file))["correct"] is True


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell_file", CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, fault, cell_file):
    faults.plant(fault, monkeypatch.setattr)
    r = helpers.run_cpu("tiny4.small", limits=_limits(cell_file))
    assert r["correct"] is False and r["failed"] >= 1, r["compared"]


@pytest.mark.parametrize("cell_file", CELLS)
def test_control_in_bfloat16_is_not_correct(monkeypatch, cell_file):
    """The reference computed in bfloat16, put in the program's place, drives the whole run and is not correct."""
    from depbench import control, harness

    monkeypatch.setattr(harness, "solve", control.solve)
    r = helpers.run_cpu("tiny4.small", limits=_limits(cell_file))
    assert r["correct"] is False and r["failed"] >= 1, r["compared"]
