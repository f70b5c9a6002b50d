"""Host seconds a frame inside the solver's two filters
(``derp.stage.bilateral``, ``derp.stage.median``, the latter with the FOV
mask): Python and the issue of their launches, over the traced jobs."""

from depbench.metrics import host_io_s


def read(t):
    return host_io_s.seconds(t, ("derp.stage.bilateral", "derp.stage.median"))
