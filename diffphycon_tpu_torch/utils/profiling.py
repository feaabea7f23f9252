"""Tracing: named host spans over the program's layers, and a context that
records them, with the device's kernels, into a Chrome / Perfetto trace.

    with profiling.trace("runs/trace"):
        gd.ddpm_step(...)

writes ``runs/trace/trace.json``; each span of :data:`SPANS` shows over the
kernels its host work launched. :func:`span` is a ``record_function`` range
while a ``torch.profiler`` records, on the profiler's clock (the device
trace's), and otherwise one flag check and a shared null context: no
profiler op runs. Spans are host-side only; none is recorded inside a
kernel or a captured CUDA graph.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# every span name the program emits, by layer
SPANS = (
    "sampler.ddpm_step", "sampler.ddim_step", "sampler.two_forwards", "sampler.guidance",
    "nets.unet2d.forward", "nets.unet3d.forward", "nets.unet3d.host_tables",
    "nets.block.resblock", "nets.block.downsample", "nets.block.conv",
    "nets.block.linear_attention", "nets.block.attention",
    "nets.block.resnet", "nets.block.temporal_attention",
    "trainer.forward", "trainer.backward", "trainer.optimizer",
    "solver.frame", "solver.advect", "solver.pressure",
)

_NULL = contextlib.nullcontext()
recording = torch._C._autograd._profiler_enabled  # True while a torch.profiler records


def span(name: str):
    """``with span("sampler.ddpm_step"): ...``: a named range in the
    profiler's timeline while one records, else a no-op."""
    if not recording():
        return _NULL
    return record_function(name)


def in_span(name: str, fn, *args, **kw):
    """fn(*args, **kw) inside ``span(name)``."""
    with span(name):
        return fn(*args, **kw)


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
