"""K1's share of its roofline over the traced window, in percent: the
sum of each launch's least time (what its level's geometry needs,
depbench/coverage.py) over the sum of its device times. Nothing to read where
the kernel did not run."""

from depbench import kernelnames as kernels


def read(t):
    return kernels.roofline_pct(t, "k1")
