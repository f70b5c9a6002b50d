"""CorrectVignetting equivalent: undo lens vignetting in a single image, on
the card.

Flags mirror ``isp/CorrectVignetting.cpp:30-35``: comma-separated Bezier
control values for the x and y rolloff curves, evaluated around the
principal point and divided out of the image.

    python -m facebook360_dep_tpu_torch.cli.correct_vignetting --raw in.png --out out.png \\
        --vignetting_x 0.6,1,1,0.6 --vignetting_y 0.7,1,1,0.7
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from ..core import io
from ..isp import pipeline as isp
from . import resolve_device

log = logging.getLogger("correct_vignetting")


def correct_vignetting(img: torch.Tensor, vx, vy, principal=None) -> torch.Tensor:
    """Divide out the separable Bezier rolloff on ``img``'s device. The
    curves are parameterized over [0,1] across the image, recentered on the
    principal point (the reference evaluates distance from the principal; a
    recentred separable curve matches its tables)."""
    h, w = img.shape[:2]
    px = principal[0] if principal and principal[0] >= 0 else w / 2.0
    py = principal[1] if principal and principal[1] >= 0 else h / 2.0
    # parameter 0 at the left/top edge, 0.5 at the principal, 1 at right/bottom
    # (float64 on the host, then float32, as the JAX package forms it)
    tx = np.clip((np.arange(w) - px) / max(w, 1) + 0.5, 0.0, 1.0).astype(np.float32)
    ty = np.clip((np.arange(h) - py) / max(h, 1) + 0.5, 0.0, 1.0).astype(np.float32)

    def roll(ctrl, t):
        ctrl = torch.tensor(np.asarray(ctrl, np.float32)[:, None], device=img.device)
        return isp.bezier(ctrl, torch.from_numpy(t).to(img.device))[:, 0]

    gain = roll(vy, ty)[:, None] * roll(vx, tx)[None, :]
    if img.ndim == 3:
        gain = gain[..., None]
    return (img / torch.clamp(gain, min=1e-6)).clamp(0.0, 1.0)


def main(argv=None, *, device=None):
    """Parse ``argv`` and correct the image on ``device`` (None: the card)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--raw", required=True, help="path to input image")
    p.add_argument("--out", required=True, help="path to output image")
    p.add_argument("--principal_x", type=float, default=-1)
    p.add_argument("--principal_y", type=float, default=-1)
    p.add_argument("--vignetting_x", required=True, help="comma-separated Bezier controls")
    p.add_argument("--vignetting_y", required=True)
    args = p.parse_args(argv)
    dev = resolve_device(device)

    img = torch.from_numpy(io.read_color(args.raw)).to(dev)
    vx = [float(v) for v in args.vignetting_x.split(",")]
    vy = [float(v) for v in args.vignetting_y.split(",")]
    out = correct_vignetting(img, vx, vy, (args.principal_x, args.principal_y))
    io.write_color(args.out, out.cpu().numpy())
    log.info("%s -> %s", args.raw, args.out)


if __name__ == "__main__":
    main()
