"""Host seconds a frame inside the foreground pass's init between levels
(``derp.stage.fg_init``: the nearest upsample, the chamfer fill of the
holes in the masks, the plate, the copy to the card), over the traced
jobs. Nothing to read where the program opens no such span."""

from depbench.metrics import host_io_s


def read(t):
    return host_io_s.seconds(t, ("derp.stage.fg_init",))
