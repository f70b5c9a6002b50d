"""Share of the traced window, in percent, in which no device interval
runs while the host is inside a ``derp.stage.*`` span (set-up, the search
stages, the filters): the time the card waits on the host's issue of the
solve. Nothing to read without device intervals or such spans."""

from depbench.metrics import io_idle_pct


def read(t):
    return io_idle_pct.idle_pct(t, ("derp.stage.",))
