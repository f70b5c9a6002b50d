"""Host seconds a frame inside the mismatch stage (``derp.stage.mismatches``:
the K1 launch on the cameras' disparity maps and the decision's chunks),
over the traced jobs. Nothing to read where the program opens no such span."""

from depbench.metrics import host_io_s


def read(t):
    return host_io_s.seconds(t, ("derp.stage.mismatches",))
