"""K2's share of its roofline over the traced window, in percent: the
sum of each launch's least time (its level's shape, frozen work functions in
depbench/roofline.py) over the sum of its device times. Nothing to read where
the kernel did not run."""

from depbench import kernelnames as kernels


def read(t):
    return kernels.roofline_pct(t, "k2")
