"""The control of ``correct``: the plain reference in the program's place, one precision below.

The configurations state float32, so the control is the reference computed
in bfloat16. :func:`solve` has the signature of ``harness.solve``: put in
its place, a run drives the control through the window, the read-back and
the judgement exactly as it drives the program, and has to come out not
correct (``tests/test_depbench_faults.py``; ``calibrate.py --harness-runs``
on the card).
"""

from __future__ import annotations

import os

import torch

from depbench import harness, pngio


def solve(c, tree, out: str, frame: str, device, dtype=torch.bfloat16) -> dict:
    """The reference in ``dtype`` solves ``frame`` and writes the judged levels' maps into ``out``."""
    ref = harness.load_module(os.path.join(harness.BASE, "reference", c.cell["reference"] + ".py"))
    solved = c.frames[0] if frame == harness.WARMUP_FRAME else frame
    maps = ref.solve_pyramid(tree.cams_norm, tree.colors[solved], {lv: c.size(lv) for lv in c.levels},
                             tree.full_height, float(c.config["min_depth_m"]), float(c.config["max_depth_m"]),
                             device, dtype, keep=c.judged, **harness.reference_inputs(c, tree, solved))
    for level, m in maps.items():
        for i, cid in enumerate(tree.ids):
            d = os.path.join(out, "disparity_levels", f"level_{level}", cid)
            os.makedirs(d, exist_ok=True)
            pngio.write_pfm(os.path.join(d, f"{frame}.pfm"), m[i])
    return {lv: 0.0 for lv in c.levels}
