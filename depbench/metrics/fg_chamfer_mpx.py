"""Million pixels a frame that the foreground init's chamfer swept: the
program's counter ``derp.fg.chamfer_px`` (maps chamfered times their
pixels), which a trace holds as empty host ranges named
``derp.fg.chamfer_px=<n>``, summed over the ranges that start inside the
traced jobs. Nothing to read where the program records no such counter."""

COUNTER = "derp.fg.chamfer_px="


def read(t):
    found = [int(n[len(COUNTER):]) for n, s, _ in t.host_ops
             if n.startswith(COUNTER) and any(lo <= s <= hi for lo, hi in t.window)]
    if not found or t.frames <= 0:
        return None
    return sum(found) / 1e6 / t.frames
