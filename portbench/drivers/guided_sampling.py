"""Closed-loop guided sampling: denoise steps of one batch back to back.

A job is the configuration's whole sampling schedule on one batch; when it
ends the next job starts on a new batch drawn from the seed. The system
module (``systems/<config's system>.py``) builds the port's sampler and
steps it; this driver warms it up, runs the measured window, optionally a
traced window, and hands the steps it recorded to the system's reference
check.

Traffic parameters (``traffic/<name>.json``):
  batch          samples per job
  warm_steps     steps of a warm-up job before the window (set-up)
  check_steps    steps of the window whose inputs and outputs are kept for
                 the reference check, drawn from the seed among the first
                 ``check_within`` steps of the window
  trace_steps    steps of the traced window (``--trace 1`` runs only)
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import flops as pf
from portbench.harness import system
from portbench.weights import sub_seed
from portbench.yardstick import gaps, traced


def check_positions(seed: int, within: int, n: int) -> set:
    rng = np.random.default_rng(sub_seed(seed, 9))
    return set(int(i) for i in rng.choice(within, size=min(n, within), replace=False))


def run(run) -> None:
    tr = run.traffic
    sysm = system(run.cfg["system"])
    prog = sysm.Guided(run)
    sync = torch.cuda.synchronize if run.device == "cuda" else (lambda: None)

    prog.start_job(-1)  # warm-up: every shape of the window, outside it
    for pos in range(tr["warm_steps"]):
        prog.step(pos, record=False)
    sync()
    n_sched = len(prog.schedule)
    keep = check_positions(run.seed, tr["check_within"], tr["check_steps"])
    events = [] if run.trace and run.device == "cuda" else None
    host_ms = []
    run.e2e["setup_s"] = time.perf_counter() - run.t_start
    if run.device == "cuda":
        torch.cuda.reset_peak_memory_stats()

    i = 0
    t0 = time.perf_counter()
    while True:
        job, pos = divmod(i, n_sched)
        if pos == 0:
            prog.start_job(job)
        h0 = time.perf_counter()
        prog.step(pos, record=i in keep)
        h1 = time.perf_counter()
        host_ms.append(1e3 * (h1 - h0))
        if events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        i += 1
        if h1 - t0 >= run.seconds and i >= max(keep) + 1:
            break
    sync()
    span = time.perf_counter() - t0
    run.attempted = i
    run.e2e["guided_steps_per_s"] = i / span
    run.stats["host_ms"] = host_ms
    if events is not None:
        run.stats["event_gap_ms"] = gaps([events[0].elapsed_time(e) for e in events])

    if run.trace:
        def body():
            nonlocal i
            for _ in range(tr["trace_steps"]):
                job, pos = divmod(i, n_sched)
                if pos == 0:
                    prog.start_job(job)
                with torch.profiler.record_function("sampler.step"):
                    prog.step(pos, record=False)
                i += 1

        prog.spans = True
        run.trace_data = traced(run.device, body)
        prog.spans = False
        run.stats["steps_traced"] = tr["trace_steps"]
    layers = prog.layers()
    run.stats["flops_per_step"], run.stats["bound_s_per_step"] = pf.totals(layers)
    run.stats["kind"] = "guided"

    if run.device == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    records = prog.records
    prog.free()
    run.checks = prog.check(records)
    run.failed = prog.failed
