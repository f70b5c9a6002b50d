"""Host seconds a frame inside the foreground pass's reads
(``derp.io.read_fg``: each level's masks and the plate's disparity, and the
coarser level's masks for the init), over the traced jobs. Nothing to read
where the program opens no such span."""

from depbench.metrics import host_io_s


def read(t):
    return host_io_s.seconds(t, ("derp.io.read_fg",))
