"""Share of the traced window in which no kernel, memcpy or memset ran
on the device, in % (the union of the trace's device intervals). None
when the trace holds no device operation."""


def read(r):
    if r.busy_s is None or not r.window_s:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
