"""Thousand pixels a frame that the mismatch stage replaced: the program's
counter ``derp.mismatch.replaced_px`` (the set pixels of the level's
read-back mismatch masks), which a trace holds as empty host ranges named
``derp.mismatch.replaced_px=<n>``, summed over the ranges that start inside
the traced jobs. Nothing to read where the program records no such counter."""

COUNTER = "derp.mismatch.replaced_px="


def read(t):
    found = [int(n[len(COUNTER):]) for n, s, _ in t.host_ops
             if n.startswith(COUNTER) and any(lo <= s <= hi for lo, hi in t.window)]
    if not found or t.frames <= 0:
        return None
    return sum(found) / 1e3 / t.frames
