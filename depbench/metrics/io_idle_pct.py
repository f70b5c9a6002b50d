"""Share of the traced window, in percent, in which no device interval
runs while the host is inside a ``derp.io.*`` span: the time the card
waits on host IO. Nothing to read without device intervals or such spans."""

import bisect

from depbench import trace
from depbench.metrics import host_io_s


def idle_pct(t, names):
    """Percent of the window that lies in the union of the spans in ``names`` and outside ``t.busy``."""
    spans = [(s, e) for n, s, e in t.host_ops if host_io_s.matches(n, names)]
    if t.window_ns() <= 0 or not t.busy or not spans:
        return None
    ends = [e for _, e in t.busy]  # busy is sorted and disjoint
    idle = 0
    for lo, hi in t.window:
        for s, e in trace.merge(spans, lo, hi):
            idle += e - s
            i = bisect.bisect_right(ends, s)
            while i < len(t.busy) and t.busy[i][0] < e:
                idle -= min(t.busy[i][1], e) - max(t.busy[i][0], s)
                i += 1
    return 100.0 * idle / t.window_ns()


def read(t):
    return idle_pct(t, host_io_s.IO)
