#!/usr/bin/env python3
"""chip_smoke.py with the CLI package's allocator tuning left out.

    python3 tools/chip_smoke_without_tune_malloc.py [chip_smoke.py's flags]

Importing ``facebook360_dep_tpu_torch.cli`` calls ``core.hostmem.tune_malloc``,
which raises glibc's mmap and trim thresholds to 1 GiB for the whole
process. This script makes that call a no-op before anything imports the
CLI package, then runs ``chip_smoke.main``: run it beside ``python3
chip_smoke.py`` in one call on one card, and the two runs' phase times
(steps 4-11, which run in chip_smoke's own process) tell what the tuning is
worth. The subprocesses that step 12's farm starts import the CLI package
afresh and are tuned in both runs.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from facebook360_dep_tpu_torch.core import hostmem  # noqa: E402

hostmem.tune_malloc = lambda threshold_bytes=1 << 30: False

import chip_smoke  # noqa: E402

if __name__ == "__main__":
    assert "facebook360_dep_tpu_torch.cli" not in sys.modules
    raise SystemExit(chip_smoke.main())
