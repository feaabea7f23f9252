"""Percent of the traced window in which no device activity ran on any
stream: 100 (1 - union of the activities' intervals / window)."""

from portbench.yardstick import device_trace


def read(run):
    t = device_trace(run, "train")
    if t is None:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
