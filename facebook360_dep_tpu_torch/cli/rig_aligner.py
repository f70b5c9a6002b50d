"""RigAligner equivalent (rig/RigAligner.cpp:34-100): fit a similarity
transform (R, t, s) onto a reference rig, with an optional randomize mode for
self-testing. The port of ``facebook360_dep_tpu/cli/rig_aligner.py``: host
code, with no device.

    python -m facebook360_dep_tpu_torch.cli.rig_aligner --rig_in <rig.json> \\
        --rig_reference <reference.json> --rig_out <aligned.json>
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from ..calib import ba, rig_tools
from ..core import camera as cam

log = logging.getLogger("rig_aligner")


def randomize_rig(rig: cam.Rig, seed: int) -> cam.Rig:
    rng = np.random.RandomState(seed)
    rotvec = rng.uniform(0, np.pi, 3)
    translation = rng.randint(-100, 101, 3).astype(np.float64)
    scale = rng.uniform(0.5, 2.0)
    rotation = ba.rodrigues(torch.as_tensor(rotvec)).numpy()
    log.info("random rotation %s translation %s scale %.4f", rotvec, translation, scale)
    # apply the inverse transform so aligning recovers the original
    inv_rot = rotation.T
    inv_scale = 1.0 / scale
    inv_trans = -inv_scale * inv_rot @ translation
    return rig_tools.transform_rig(rig, inv_rot, inv_trans, inv_scale)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rig_in", required=True)
    p.add_argument("--rig_reference", required=True)
    p.add_argument("--rig_out", required=True)
    p.add_argument("--lock_rotation", type=lambda v: str(v).lower() in ("1", "true"), default=False)
    p.add_argument("--lock_scale", type=lambda v: str(v).lower() in ("1", "true"), default=False)
    p.add_argument("--lock_translation", type=lambda v: str(v).lower() in ("1", "true"), default=False)
    p.add_argument("--randomize_rig", type=lambda v: str(v).lower() in ("1", "true"), default=False)
    p.add_argument("--rng_seed", type=int, default=1)
    p.add_argument("--transformed_rig", default="")
    args = p.parse_args(argv)

    rig = cam.load_rig(args.rig_in)
    reference = cam.load_rig(args.rig_reference)
    if args.randomize_rig:
        rig = randomize_rig(rig, args.rng_seed)
        if args.transformed_rig:
            cam.save_rig(args.transformed_rig, rig)
    aligned = rig_tools.align_rig(
        rig, reference, args.lock_rotation, args.lock_translation, args.lock_scale
    )
    cam.save_rig(args.rig_out, aligned)
    # final cost: mean position distance after alignment (the metric the
    # reference test asserts on, translator.json RigAlignerTest)
    avg = rig_tools.compare_rigs(aligned, reference)
    log.info("final cost: %.6f", avg["position"])


if __name__ == "__main__":
    main()
