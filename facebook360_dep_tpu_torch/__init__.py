"""PyTorch + CUDA port of facebook360_dep_tpu for one NVIDIA H100.

Mirrors the JAX package's sub-packages (``core``, ``ops``, ``depth``,
``render``, ``cli``). Plain tensor code is PyTorch; the Pallas kernels of the
depth-estimation hot path are hand-written CUDA C++ under ``csrc/``, built at
first use by :mod:`facebook360_dep_tpu_torch.ops._build`.
"""

import torch


def default_device() -> torch.device:
    """``cuda`` when a card is visible, else ``cpu`` (the JAX package's
    default-backend rule, depth/pipeline.py)."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")
