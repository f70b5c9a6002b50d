"""Share of the traced window in which no device operation ran, in percent."""


def read(t):
    if t.window_ns() <= 0 or not t.busy:
        return None
    return 100.0 * (1.0 - t.busy_ns() / t.window_ns())
