"""Host seconds a frame inside the program's ``derp.io.*`` spans (PNG16
decodes, PFM reads and writes, debug images), summed over the traced jobs.
Nothing to read where the program opens no such span."""

IO = ("derp.io.",)


def matches(name: str, names) -> bool:
    """Whether a host range is one of ``names`` (a name ending in "." is a prefix)."""
    return name.startswith("derp.") and any(name == p or (p[-1] == "." and name.startswith(p)) for p in names)


def seconds(t, names):
    """Seconds a frame of the spans in ``names`` that start inside the traced jobs, or None."""
    found = [e - s for n, s, e in t.host_ops
             if matches(n, names) and any(lo <= s <= hi for lo, hi in t.window)]
    if not found or t.frames <= 0:
        return None
    return sum(found) / 1e9 / t.frames


def read(t):
    return seconds(t, IO)
