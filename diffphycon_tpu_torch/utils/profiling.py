"""Tracing and step timing (port of ``diffphycon_tpu/utils/profiling.py``):
a ``torch.profiler`` context that writes a Chrome trace, a step timer that
synchronises CUDA before it reads the clock, and named trace regions."""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str, cuda: Optional[bool] = None):
    """Profile the block (CPU, and CUDA when available or ``cuda`` is True)
    and write ``<logdir>/trace.json``, a Chrome / Perfetto trace. Yields the
    profiler (``key_averages()`` for sums by op)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() if cuda is None else cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Rolling-average step timer:

        timer = StepTimer(avg_window=20)
        for ...:
            out = step(...)
            dt = timer.tick(out)   # seconds since the last tick

    ``tick`` synchronises every CUDA device given among its arguments (the
    current one when any argument is a CUDA tensor) before reading the
    clock, so a step's queued device work is counted in it."""

    def __init__(self, avg_window: int = 20):
        self._window = deque(maxlen=avg_window)
        self._last: Optional[float] = None

    def tick(self, *sync_on) -> float:
        for dev in {t.device for t in sync_on if isinstance(t, torch.Tensor) and t.is_cuda}:
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return 0.0
        dt = now - self._last
        self._last = now
        self._window.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self._window) / len(self._window) if self._window else 0.0

    @property
    def steps_per_sec(self) -> float:
        m = self.mean
        return 1.0 / m if m > 0 else 0.0


def annotate(name: str):
    """A named region in the profiler's timeline:

        with annotate("denoise_step"): ..."""
    return record_function(name)
