"""RigCompare equivalent (rig/RigCompare.cpp:30-72). The port of
``facebook360_dep_tpu/cli/rig_compare.py``: host code, with no device.

    python -m facebook360_dep_tpu_torch.cli.rig_compare --rig <rig.json> --reference <reference.json>
"""

from __future__ import annotations

import argparse
import logging

from ..calib import rig_tools
from ..core import camera as cam


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rig", required=True)
    p.add_argument("--reference", required=True)
    p.add_argument("--skip_align", type=lambda v: str(v).lower() in ("1", "true"), default=False)
    args = p.parse_args(argv)
    rig = cam.load_rig(args.rig)
    reference = cam.load_rig(args.reference)
    if not args.skip_align:
        rig = rig_tools.align_rig(rig, reference)
    rig_tools.compare_rigs(rig, reference)


if __name__ == "__main__":
    main()
