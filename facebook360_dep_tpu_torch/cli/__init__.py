"""The port's command-line entry points, each run as ``python -m
facebook360_dep_tpu_torch.cli.<name>`` or called as ``main(argv)`` with the
JAX CLI's flags (those that compute on a device also take ``device``, None
meaning the card): derp_cli; compute_rephotography_errors and
simple_mesh_renderer; generate_foreground_masks, resize_images,
temporal_bilateral_filter, upsample_disparity and layer_disparities;
convert_to_binary and view_fused (the 6DoF publish and playback path);
calibration (main, main_match_corners, main_geometric), align_point_cloud
and align_colors, with rig_aligner and rig_compare on the host (rig
calibration); raw_to_rgb and correct_vignetting (the ISP); and the project
driver dep over render_pipeline and the farm, with verify_data and
log_reader on the host.

Importing the package sets a CLI process up as the JAX package's does
(util/SystemUtil.h:36-41 initDep): faulthandler for the fatal signals, a
stack dump on SIGTERM, and the allocator tuning of ``core/hostmem.py``.

A CLI's device: ``main(argv, device=...)`` where the caller names one;
else the environment variable ``DEP_TORCH_DEVICE``: unset or empty means
the card (which raises where none is visible), ``cpu`` the CPU, and any
other value raises. The farm's subprocess stages take it from their
parent's environment, so ``DEP_TORCH_DEVICE=cpu`` runs a whole project on
the CPU, as the tests do.
"""

import faulthandler as _faulthandler
import os as _os
import signal as _signal
import sys as _sys

import torch as _torch

from .. import resolve_device as _resolve_device
from ..core.hostmem import tune_malloc as _tune_malloc

DEVICE_ENV = "DEP_TORCH_DEVICE"

if not _faulthandler.is_enabled():
    _faulthandler.enable()
if hasattr(_faulthandler, "register") and hasattr(_signal, "SIGTERM"):
    try:  # dump and continue: an orchestrator's soft kill leaves a trace of where the process was
        _faulthandler.register(_signal.SIGTERM, file=_sys.stderr, chain=True)
    except (ValueError, OSError):  # not the main thread
        pass
_tune_malloc()


def resolve_device(device=None) -> _torch.device:
    """A CLI's device: ``device`` where given, else ``DEP_TORCH_DEVICE``
    (unset or empty: the card, raising without one; ``cpu``: the CPU)."""
    if device is not None:
        return _torch.device(device)
    name = _os.environ.get(DEVICE_ENV, "")
    if name == "":
        return _resolve_device(None)
    if name == "cpu":
        return _torch.device("cpu")
    raise ValueError(f"{DEVICE_ENV}={name!r}: unset (the card) or 'cpu' only")
