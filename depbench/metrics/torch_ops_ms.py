"""Device milliseconds a frame of every kernel that is not K1, K2 or K3:
the solver stages and filters as PyTorch runs them."""

from depbench import kernelnames as kernels


def read(t):
    if not t.kernels or t.frames <= 0:
        return None
    ns = sum(d for n, _, d in t.kernels if kernels.which(n) is None)
    return ns / 1e6 / t.frames
