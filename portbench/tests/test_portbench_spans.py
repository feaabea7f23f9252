"""The readers of the program's spans and counters on a hand-built trace
(microseconds): two sampler steps whose net forwards overlap, rollout
frames, and K4's counters."""

from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench import yardstick as ys

DEVICE = [("k", 100.0, 200.0), ("k", 300.0, 350.0), ("k2", 600.0, 700.0)]
GUIDED = [("sampler.step", 0.0, 400.0), ("sampler.ddpm_step", 0.0, 400.0),
          ("nets.forward.joint", 40.0, 160.0), ("nets.unet2d.forward", 50.0, 150.0),
          ("nets.unet2d.forward", 120.0, 250.0), ("aten::mul", 400.0, 450.0),
          ("sampler.step", 500.0, 1000.0), ("sampler.ddpm_step", 500.0, 1000.0),
          ("nets.unet2d.forward", 550.0, 650.0)]
ROLLOUT = [("solver.rollout", 0.0, 1000.0), ("solver.frame", 0.0, 300.0),
           ("solver.frame", 300.0, 700.0), ("solver.frame", 700.0, 800.0),
           ("solver.frame", 900.0, 1100.0)]  # the last one leaves the window


def _run(kind, cpu, mode="program"):
    return SimpleNamespace(trace_data=ys.Trace(DEVICE, cpu, (0.0, 1000.0)),
                           stats={"kind": kind}, mode=mode)


def _read(name, run):
    return harness.load_reader(name)(run)


def test_sampler_self_time_and_forward_time():
    run = _run("guided", GUIDED)
    # step 1: 400 - union(50..150, 120..250) = 200; step 2: 500 - 100 = 400
    assert _read("sampler.self_host_ms.guided", run) == pytest.approx(0.3)
    # forwards 100, 130, 100 (the benchmark's nets.forward.joint is not one)
    assert _read("nets.host_ms_per_forward.guided", run) == pytest.approx(0.1)


def test_idle_outside_nets_is_part_of_the_idle_share():
    run = _run("guided", GUIDED)
    # union of the device's and the forwards' intervals: 50..250, 300..350, 550..700
    outside = _read("device.idle_share_outside_nets.guided", run)
    assert outside == pytest.approx(60.0)
    assert _read("device.idle_share.guided", run) == pytest.approx(75.0)
    assert outside <= _read("device.idle_share.guided", run)


def test_frame_time_counts_frames_in_the_window():
    assert _read("solver.host_ms_per_frame.rollout", _run("rollout", ROLLOUT)) == \
        pytest.approx(0.3)


def test_cg_iterations_per_solve_from_the_counters():
    from diffphycon_tpu_torch import kernels

    kernels.reset_counters()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            kernels.count("solver.cg_iterations", torch.tensor([300, 200], dtype=torch.int32))
            kernels.count("solver.cg_solves", 2)
            kernels.count("solver.cg_iterations", torch.tensor([250], dtype=torch.int32))
            kernels.count("solver.cg_solves", 1)
        run = _run("rollout", ROLLOUT)
        assert _read("solver.cg_iterations_per_solve.rollout", run) == pytest.approx(250.0)
        assert _read("solver.cg_iterations_per_solve.rollout",
                     _run("rollout", ROLLOUT, mode="control")) is None
    finally:
        kernels.reset_counters()
    assert _read("solver.cg_iterations_per_solve.rollout", _run("rollout", ROLLOUT)) is None


@pytest.mark.parametrize("name,kind", [
    ("sampler.self_host_ms.guided", "guided"), ("nets.host_ms_per_forward.guided", "guided"),
    ("device.idle_share_outside_nets.guided", "guided"),
    ("solver.host_ms_per_frame.rollout", "rollout")])
def test_no_program_spans_read_nothing(name, kind):
    ours = ("sampler.step", "nets.forward", "solver.rollout")  # the benchmark's own spans
    benchmark_only = [e for e in GUIDED + ROLLOUT if e[0].startswith(ours)]
    assert _read(name, _run(kind, benchmark_only)) is None
    assert _read(name, _run("train", GUIDED + ROLLOUT)) is None
