#!/usr/bin/env python3
"""Where the port's ISP on the card parts from the same ISP on the CPU.

    python3 tools/isp_card_cpu_diff.py [--width 2048 --height 1536 --device cuda]

Runs ``isp.process`` with chip_smoke.py's full config (every stage away from
identity, stuck pixels with r = 1) in each demosaic mode, on the CPU and on
``--device``, for two mosaics: camera 0 of chip_smoke.py's 16-camera sphere
scene with a stuck sensel every 97th, and uniform noise from ``--seed``. It
does so twice: with the pipeline as it is, and with its divisions by a
number (``isp._divide``) made the plain ``x / d`` of a Python divisor, which
the card computes as a multiply by the float32 reciprocal. For each run it
prints one JSON line: the largest absolute difference, the pixels that
differ by more than 1e-6, the worst pixel, and for EDGE_AWARE the
homogeneity votes (dH <= dV) that differ between the devices and the share
of differing pixels within the vote's window of such a flip. The last line
is the card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from facebook360_dep_tpu_torch.isp import pipeline as isp  # noqa: E402
from facebook360_dep_tpu_torch.render import synthetic  # noqa: E402

VOTE_RADIUS = 4  # demosaic_edge_aware's homogeneity_radius


def run(raw: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor | None]:
    """process() on ``raw``'s device, with the homogeneity vote it took."""
    votes = []
    box_mean = isp._box_mean

    def recording(img, radius):
        if radius == VOTE_RADIUS and not votes:
            votes.append(img.bool().cpu())
        return box_mean(img, radius)

    isp._box_mean = recording
    try:
        out = isp.process(raw, cfg)
    finally:
        isp._box_mean = box_mean
    return out.cpu(), (votes[0] if votes else None)


def compare(name: str, raw: torch.Tensor, device: torch.device, formation: str) -> dict:
    rows = []
    for mode in isp.DEMOSAIC_FILTERS:
        cfg = isp.IspConfig(**chip_smoke.ISP_FULL_CONFIG, demosaic_filter=mode)
        cpu, vote_cpu = run(raw, cfg)
        card, vote_card = run(raw.to(device), cfg)
        diff = (card - cpu).abs()
        worst = [int(i) for i in torch.unravel_index(diff.argmax(), diff.shape)]
        row = dict(input=name, formation=formation, mode=mode, max_abs_diff=float(diff.max()),
                   pixels_over_1e6=int((diff > 1e-6).any(-1).sum()), worst_yxc=worst)
        if vote_cpu is not None:
            flips = vote_cpu != vote_card
            near = F.max_pool2d(flips[None, None].float(), 2 * VOTE_RADIUS + 1, 1, VOTE_RADIUS)[0, 0] > 0
            differing = (diff > 1e-6).any(-1)
            row.update(votes_flipped=int(flips.sum()),
                       differing_near_a_flip=(float((differing & near).sum() / differing.sum())
                                              if differing.any() else None))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--height", type=int, default=1536)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    device = torch.device(args.device)

    rig = synthetic.make_test_rig(chip_smoke.NUM_CAMERAS, (args.width, args.height), ring_radius=0.3)
    colors, _ = synthetic.render_sphere_scene(rig, (args.width, args.height), radius=5.0, device=device)
    sphere = isp.mosaic(colors[0], chip_smoke.ISP_PATTERN).cpu()
    del colors
    sphere.view(-1)[::97] = 1.0
    noise = torch.from_numpy(np.random.default_rng(args.seed).random((args.height, args.width), dtype=np.float32))

    divide = isp._divide
    for formation in ("tensor divisor", "python divisor"):
        if formation == "python divisor":
            isp._divide = lambda x, d: x / d
        try:
            for name, raw in (("sphere camera 0", sphere), ("uniform noise", noise)):
                compare(name, raw, device, formation)
        finally:
            isp._divide = divide
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()
        print(smi)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
