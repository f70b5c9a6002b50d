"""PyTorch + CUDA port of facebook360_dep_tpu for one NVIDIA H100.

Mirrors the JAX package's sub-packages (``core``, ``ops``, ``depth``,
``render``, ``stream``, ``calib``, ``cli``). Plain tensor code is PyTorch; the Pallas kernels of the
depth-estimation hot path are hand-written CUDA C++ under ``csrc/``, built at
first use by :mod:`facebook360_dep_tpu_torch.ops._build`; the host codecs of
the publish path (``stream/_native/*.cpp``) build with g++ at first use by
:mod:`facebook360_dep_tpu_torch.stream.native`.

The entry points (each CLI's ``main`` and ``DepthEstimator``) run on the card.
Where none is visible they raise; a caller that wants the CPU, as the tests
do, passes ``device="cpu"``.
"""

import torch


def default_device() -> torch.device:
    """``cuda``; raises ``RuntimeError`` where no card is visible, so that a
    run never carries on silently on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: the port runs on the card; "
                           "pass device='cpu' to an entry point to run it on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """An entry point's ``device`` argument: None means the card."""
    return default_device() if device is None else torch.device(device)
