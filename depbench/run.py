"""Run one cell of the port's benchmark once.

    python3 depbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks for
(``BENCHMARK.json``). Prints the result as the last line of standard output;
exits non-zero, with no result, where no CUDA device is visible.
"""

import os
import sys
import time


def _process_age_s() -> float:
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            return max(0.0, float(f.read().split()[0]) - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


STARTED = time.perf_counter() - _process_age_s()

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from depbench import harness

    sys.exit(harness.main(sys.argv[1:], STARTED))
