"""Percent of the H100's bf16 dense peak (989 TFLOP/s) that the nets' model
flops reach over the traced window: flops of one train step from the
configuration's layer shapes (portbench/flops.py) x steps / window."""

from portbench.flops import PEAKS
from portbench.yardstick import device_trace


def read(run):
    t = device_trace(run, "train")
    if t is None:
        return None
    return 100.0 * run.stats["flops_per_step"] * run.stats["steps_traced"] / t.window_s \
        / PEAKS["bf16"]
