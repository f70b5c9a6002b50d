"""Kernels the card ran a frame, counted from the device trace (so a
kernel replayed from a CUDA graph counts too)."""


def read(t):
    if not t.kernels or t.frames <= 0:
        return None
    return len(t.kernels) / t.frames
