"""Percent of the traced window in which no device activity ran on any
stream and no program net forward span (``nets.unet2d.forward`` /
``nets.unet3d.forward``) was open: 100 (1 - union of the activities' and
the forwards' intervals / window). The part of ``device.idle_share.guided``
the host spent outside the nets."""

from portbench.program_spans import FORWARDS, intervals
from portbench.yardstick import device_trace, union_length


def read(run):
    t = device_trace(run, "guided")
    fwd = intervals(t, FORWARDS) if t is not None else []
    if not fwd:
        return None
    busy = union_length([(s, e) for _, s, e in t.device] + fwd, *t.window)
    return 100.0 * (1.0 - busy / (t.window[1] - t.window[0]))
