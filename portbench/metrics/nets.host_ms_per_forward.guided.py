"""Median host milliseconds of the program's net forward spans
(``nets.unet2d.forward`` / ``nets.unet3d.forward``) in the traced window:
the enqueue cost of one forward, both nets of a step pooled."""

from portbench.program_spans import FORWARDS, durations_ms
from portbench.yardstick import device_trace, percentile


def read(run):
    t = device_trace(run, "guided")
    ms = durations_ms(t, FORWARDS) if t is not None else []
    return percentile(ms, 50) if ms else None
