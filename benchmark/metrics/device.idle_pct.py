"""device.idle_pct: 100 x (1 - the union of the device's busy intervals
over the traced window).  The profiler slows the host, so this is an upper
bound on the untraced idle share."""


def read(obs):
    t = obs.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
