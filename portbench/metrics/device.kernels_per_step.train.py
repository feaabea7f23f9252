"""Device kernels in the traced window (all streams, library kernels
included) per train step."""

from portbench.yardstick import device_trace


def read(run):
    t = device_trace(run, "train")
    if t is None:
        return None
    return t.n_kernels() / run.stats["steps_traced"]
