"""Median host milliseconds of the program's ``solver.frame`` spans in the
traced window: one frame's control write, K4 solve, two advections and
bucket accounting, as the host enqueues them."""

from portbench.program_spans import durations_ms
from portbench.yardstick import device_trace, percentile


def read(run):
    t = device_trace(run, "rollout")
    ms = durations_ms(t, ("solver.frame",)) if t is not None else []
    return percentile(ms, 50) if ms else None
