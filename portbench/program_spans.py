"""The program's own spans in a traced window (``diffphycon_tpu_torch/utils/
profiling.py: SPANS``), for the per-layer readers that use them. A program
without them (an older commit, or the reference standing in for it in a
control run) gives no spans, and each reader returns None."""

from __future__ import annotations

from portbench.yardstick import union_length

STEPS = ("sampler.ddpm_step", "sampler.ddim_step")
FORWARDS = ("nets.unet2d.forward", "nets.unet3d.forward")


def intervals(t, names) -> list:
    """(start, end) in microseconds of the spans named ``names`` that lie in
    the window of Trace ``t``."""
    lo, hi = t.window
    return [(s, e) for n, s, e in t.spans if n in names and lo <= s and e <= hi]


def durations_ms(t, names) -> list:
    return [(e - s) / 1e3 for s, e in intervals(t, names)]


def self_ms(t, parents, children) -> list:
    """For each ``parents`` span, its duration minus the union of the
    ``children`` spans' intervals within it, in ms."""
    kids = intervals(t, children)
    return [(e - s - union_length(kids, s, e)) / 1e3 for s, e in intervals(t, parents)]
