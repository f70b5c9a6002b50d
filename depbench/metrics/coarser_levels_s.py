"""Wall seconds a frame of every level but the finest (``level_seconds``),
summed over the traced jobs."""


def read(t):
    if not t.level_seconds or t.frames <= 0:
        return None
    return sum(s for ls in t.level_seconds for lv, s in ls.items() if lv != t.finest_level) / t.frames
