"""The share of the profiled call's host-clock window in which no device
operation ran (the union of the device intervals)."""


def read(out):
    if out.trace is None or out.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - out.trace.busy_s() / out.trace.window_s)
