"""The benchmark's arithmetic: rates, percentiles, spreads, the union of
device intervals and the reduction of a profiler trace to busy time,
kernel counts and a breakdown."""

from __future__ import annotations

import bisect
import math
from collections import defaultdict

NAME_CHARS = 120  # kernel names (C++ signatures) are cut to this many characters
# span names the benchmark records around the layers it calls (record_function)
SPAN_PREFIXES = ("portbench.", "sampler.", "nets.", "trainer.", "solver.")


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def gaps(stamps) -> list:
    """Consecutive differences of a sorted sequence of time stamps."""
    return [b - a for a, b in zip(stamps, stamps[1:])]


def union_length(intervals, lo: float = -math.inf, hi: float = math.inf) -> float:
    """Length of the union of (start, end) intervals, clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals, lo: float, hi: float) -> list:
    """The union of intervals clipped to [lo, hi] as sorted disjoint
    (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


WINDOW_SPAN = "portbench.window"


def traced(device: str, body) -> "Trace":
    """Run body() under torch.profiler (host ops; device activities on a
    CUDA device) inside the window span, synchronised before it closes."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            body()
            if device == "cuda":
                torch.cuda.synchronize()
    return Trace.from_profiler(prof)


def device_trace(run, kind: str):
    """The run's Trace when it holds device activity of a ``kind`` cell,
    else None (a CPU run reads no device metric)."""
    t = run.trace_data
    if t is None or not t.device or run.stats.get("kind") != kind:
        return None
    return t


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


class Trace:
    """A profiled window: device activities (name, start us, end us) on all
    streams, the host's ops and the benchmark's spans, and the window
    [start, end] in microseconds on the profiler's clock."""

    def __init__(self, device_events, cpu_events, window):
        self.device = device_events
        self.spans = [e for e in cpu_events if e[0].startswith(SPAN_PREFIXES)]
        self.cpu = sorted((e for e in cpu_events if not e[0].startswith(SPAN_PREFIXES)),
                          key=lambda e: e[1])
        self.window = window
        self._starts = [e[1] for e in self.cpu]

    @classmethod
    def from_profiler(cls, prof, window_span: str = WINDOW_SPAN) -> "Trace":
        from torch.autograd import DeviceType

        device, cpu, window = [], [], None
        for e in prof.events():
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                if getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIXES):
                    continue
                device.append((e.name, float(tr.start), float(tr.end)))
            elif e.name == window_span:
                window = (float(tr.start), float(tr.end))
            else:
                cpu.append((e.name, float(tr.start), float(tr.end)))
        if window is None:
            raise RuntimeError(f"the trace holds no span {window_span!r}")
        return cls(device, cpu, window)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds of the window in which some device activity ran (the union
        of intervals over all streams: overlap counts once)."""
        return union_length([(s, e) for _, s, e in self.device], *self.window) / 1e6

    def summed_s(self) -> float:
        """The device activities' durations summed (overlap counted twice)."""
        return sum(min(e, self.window[1]) - max(s, self.window[0])
                   for _, s, e in self.device if e > self.window[0] and s < self.window[1]) / 1e6

    def n_kernels(self) -> int:
        return sum(1 for n, s, e in self.device
                   if is_kernel(n) and self.window[0] <= s < self.window[1])

    def top_ops(self, k: int = 10) -> list:
        by = defaultdict(float)
        for n, s, e in self.device:
            by[n[:NAME_CHARS]] += (e - s) / 1e6
        return sorted(([n, v] for n, v in by.items()), key=lambda r: -r[1])[:k]

    def _host_at(self, t: float) -> str:
        """'<innermost benchmark span>: <innermost host op>' running at t."""
        around = [(s, name) for name, s, e in self.spans if s <= t <= e]
        span = max(around)[1] if around else "no span"
        i = bisect.bisect_right(self._starts, t)
        op, op_start = "no host op", -math.inf
        for name, s, e in reversed(self.cpu[max(0, i - 4000):i]):
            if e >= t and s > op_start:
                op, op_start = name, s
        return f"{span}: {op}"

    def idle_gaps(self, k: int = 10, longest: int = 400) -> list:
        """The idle time of the window by what the host was doing when each
        gap began: the ``longest`` gaps grouped by that label, the k labels
        with the most idle seconds."""
        busy = merged([(s, e) for _, s, e in self.device], *self.window)
        edges = [self.window[0]] + [x for iv in busy for x in iv] + [self.window[1]]
        holes = [(edges[j], edges[j + 1]) for j in range(0, len(edges), 2)
                 if edges[j + 1] > edges[j]]
        holes.sort(key=lambda h: h[0] - h[1])
        by = defaultdict(float)
        for s, e in holes[:longest]:
            by[self._host_at(s)] += (e - s) / 1e6
        return sorted(([n, v] for n, v in by.items()), key=lambda r: -r[1])[:k]
