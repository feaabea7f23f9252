"""Closed-loop training: optimizer steps back to back on seeded batches.

The system module (``systems/<config's system>.py``, class ``Train``)
builds one trainer; set-up drives it through its first ``check_steps``
steps (the reference check follows them), and the measured window goes on
with the same trainer over a pool of ``batch_pool`` batches made on the
device from the seed.

Traffic parameters: batch, batch_pool, check_steps, trace_steps,
reference_chunks (the reference's blocks of rows).
"""

from __future__ import annotations

import time

import torch

from portbench import flops as pf
from portbench.harness import system
from portbench.yardstick import traced


def run(run) -> None:
    tr = run.traffic
    prog = system(run.cfg["system"]).Train(run)
    sync = torch.cuda.synchronize if run.device == "cuda" else (lambda: None)
    n0 = tr["check_steps"]
    prog.first_steps(n0)
    sync()
    run.e2e["setup_s"] = time.perf_counter() - run.t_start
    if run.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    i = n0
    t0 = time.perf_counter()
    while True:
        prog.step(i)
        i += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    sync()
    span = time.perf_counter() - t0
    run.attempted = i - n0
    run.e2e["train_samples_per_s"] = (i - n0) * tr["batch"] / span

    if run.trace:
        def body():
            for k in range(tr["trace_steps"]):
                with torch.profiler.record_function("trainer.step"):
                    prog.step(i + k)

        run.trace_data = traced(run.device, body)
        run.stats["steps_traced"] = tr["trace_steps"]
    layers = prog.layers()
    flops, bound = pf.totals(layers)
    # forward + backward = 3 forwards; the bytes of the backward (read dy, x
    # and w, write dx and dw) ~ 2 forwards'; remat's recompute is not counted
    run.stats["flops_per_step"], run.stats["bound_s_per_step"] = 3 * flops, 3 * bound
    run.stats["kind"] = "train"

    if run.device == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    prog.free()
    run.checks = prog.check()
    run.failed = prog.failed
    run.stats["uncompared"] = prog.uncompared
