"""Closed-loop solver re-simulation: whole rollouts of one batch back to back.

A job is one rollout of the configuration's solver frames on a batch of
controls and initial densities drawn from the seed. The system module's
``Rollout`` runs it; the check follows ``check_frames`` frames of the
window's first job, drawn from the seed.

Traffic parameters: batch, check_frames, trace_jobs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import system
from portbench.weights import sub_seed
from portbench.yardstick import traced


def run(run) -> None:
    tr = run.traffic
    prog = system(run.cfg["system"]).Rollout(run)
    sync = torch.cuda.synchronize if run.device == "cuda" else (lambda: None)
    prog.start_job(-1)  # warm-up: one whole job
    prog.rollout()
    sync()
    n_frames = run.cfg["solver"]["frames"] - 1
    rng = np.random.default_rng(sub_seed(run.seed, 9))
    keep = sorted(int(k) for k in rng.choice(n_frames, tr["check_frames"], replace=False))
    run.e2e["setup_s"] = time.perf_counter() - run.t_start
    if run.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    frames, job = 0, 0
    t0 = time.perf_counter()
    while True:
        prog.start_job(job)
        frames += prog.rollout(keep if job == 0 else ())
        job += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    sync()
    span = time.perf_counter() - t0
    run.attempted = frames
    run.e2e["rollout_frames_per_s"] = frames * tr["batch"] / span
    run.stats["kind"] = "rollout"

    if run.trace:
        frames = []

        def body():
            for k in range(tr["trace_jobs"]):
                prog.start_job(job + k)
                with torch.profiler.record_function("solver.rollout"):
                    frames.append(prog.rollout())

        run.trace_data = traced(run.device, body)
        run.stats["steps_traced"] = sum(frames)

    if run.device == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    prog.free()
    run.checks = prog.check()
    run.failed = prog.failed
