"""Percent of the device's busy time (union over streams) that the nets'
layers would need at their roofline: the sum over a train step's layers of
max(flops / peak, bytes / HBM bandwidth) from shapes (portbench/flops.py)
x steps / busy seconds of the traced window."""

from portbench.yardstick import device_trace


def read(run):
    t = device_trace(run, "train")
    if t is None:
        return None
    busy = t.busy_s()
    if busy <= 0:
        return None
    return 100.0 * run.stats["bound_s_per_step"] * run.stats["steps_traced"] / busy
