"""Device kernels in the traced window (all streams) per solver frame."""

from portbench.yardstick import device_trace


def read(run):
    t = device_trace(run, "rollout")
    if t is None:
        return None
    return t.n_kernels() / run.stats["steps_traced"]
