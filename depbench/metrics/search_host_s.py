"""Host seconds a frame inside the solver's four search stages (brute
force, random proposals, ping-pong, mismatches): Python and the issue of
their launches, over the traced jobs."""

from depbench.metrics import host_io_s

SEARCH = ("derp.stage.brute_force", "derp.stage.proposals", "derp.stage.ping_pong", "derp.stage.mismatches")


def read(t):
    return host_io_s.seconds(t, SEARCH)
