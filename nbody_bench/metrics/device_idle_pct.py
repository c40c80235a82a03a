"""device_idle_pct: the share of the traced segment in which no operation
ran on the device, in percent."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return (1.0 - t.busy_s / t.window_s) * 100.0
