"""Median host milliseconds of one guided step's call, no synchronise (the
enqueue cost), over every step of the window."""

from portbench.yardstick import percentile


def read(run):
    ms = run.stats.get("host_ms")
    return percentile(ms, 50) if ms and run.stats.get("kind") == "guided" else None
