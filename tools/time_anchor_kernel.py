"""Time the anchor kernel (warp_cuda.tile_windows, csrc/tile_windows.cu) of
a checkout on the card, at the shapes the TPU-semantics solve launches it
with, and digest its outputs.

    python3 tools/time_anchor_kernel.py [--repo DIR]

imports the port from DIR (default: this repository; another checkout,
e.g. one unpacked with ``git archive`` under ``_checkout/``, compares two
versions of the kernel in one call, run in turns: parent, change, change,
parent) and the inputs, timers and work counts from this repository's
chip_smoke.py (``level_inputs``: step 3's mixed 16-camera rig; ``level_row``:
CUDA events a launch and in a CUDA graph; ``tile_windows_work``: the least
work). Prints one JSON line: a row a shape (ms, graph_ms, bound_ms,
share of the bound) and the SHA-256 of each shape's anchors, equal across
checkouts where the anchors are equal bits, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (width, maps, reflect): the anchors of the K1 levels (edge padding, one
# launch for all 16 maps), and of the K3 levels (reflect padding) on the 4
# maps step 16 times and on all 16, the launch a 2K cost evaluation makes
CASES = ((256, 16, False), (512, 4, True), (2048, 4, True), (2048, 16, True))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=HERE, help="checkout whose facebook360_dep_tpu_torch is timed")
    parser.add_argument("--reps", type=int, default=20, help="launches timed a shape (and in the graph)")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.repo))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    if not torch.cuda.is_available():
        print("time_anchor_kernel: no CUDA device", file=sys.stderr)
        return 1
    from facebook360_dep_tpu_torch.ops import warp_cuda as wc

    dev = torch.device("cuda:0")
    smi = smoke.smi_line()
    rows = []
    for width, maps, reflect in CASES:
        ctx, disp, _, _ = smoke.level_inputs(width, dev)
        src_hw = tuple(ctx.src_imgs.shape[1:3])
        call = (ctx.src_params, ctx.dst_cams.position[:maps], disp[:maps], ctx.dst_rays[:maps])
        h, w = disp.shape[1:]
        anchors = wc.tile_windows(*call, src_hw, reflect=reflect)
        row = smoke.level_row(f"anchors ({maps} maps, {'reflect' if reflect else 'edge'})", h, w,
                              lambda: wc.tile_windows(*call, src_hw, reflect=reflect),
                              smoke.tile_windows_work(ctx.src_params.shape[0], call[2], call[3]), args.reps,
                              args.reps)
        row.update(maps=maps, reflect=reflect,
                   digest=hashlib.sha256(anchors.cpu().numpy().tobytes()).hexdigest())
        rows.append(row)
        del ctx, disp, call, anchors
        torch.cuda.empty_cache()
    print(json.dumps({"repo": os.path.relpath(os.path.abspath(args.repo), HERE), "module": wc.__file__,
                      "rows": rows, "device": torch.cuda.get_device_name(0), "smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
