"""Median self time of the program's step spans (``sampler.ddpm_step`` /
``sampler.ddim_step``) in the traced window: each step's host milliseconds
minus the part its nets' forward spans (``nets.unet2d.forward`` /
``nets.unet3d.forward``) cover. The sampler's own host work a step: pinning,
guidance, the posterior update, the join of the two forwards."""

from portbench.program_spans import FORWARDS, STEPS, self_ms
from portbench.yardstick import device_trace, percentile


def read(run):
    t = device_trace(run, "guided")
    ms = self_ms(t, STEPS, FORWARDS) if t is not None else []
    return percentile(ms, 50) if ms else None
