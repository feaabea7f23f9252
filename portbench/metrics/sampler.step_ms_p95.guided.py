"""95th percentile of the gaps between CUDA events recorded after each guided
step, over every step of the window."""

from portbench.yardstick import percentile


def read(run):
    gaps = run.stats.get("event_gap_ms")
    return percentile(gaps, 95) if gaps and run.stats.get("kind") == "guided" else None
