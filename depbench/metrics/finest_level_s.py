"""Wall seconds a frame of the finest solved level: the program's own
``DepthEstimator.level_seconds`` (host IO and the level's solve, ending after
its outputs are written), summed over the traced jobs."""


def read(t):
    if not t.level_seconds or t.frames <= 0:
        return None
    return sum(ls[t.finest_level] for ls in t.level_seconds) / t.frames
