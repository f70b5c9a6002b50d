"""Host seconds a frame inside the program's copies between host and card:
``derp.upload`` (the colours, pageable) and ``derp.readback`` (the wait for
the card's queue and the copy of the result maps), over the traced jobs."""

from depbench.metrics import host_io_s


def read(t):
    return host_io_s.seconds(t, ("derp.upload", "derp.readback"))
