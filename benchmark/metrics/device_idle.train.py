"""The share of the profiled training window in which no operation ran
on the device."""


def read(m):
    t = m.trace
    if t is None or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
