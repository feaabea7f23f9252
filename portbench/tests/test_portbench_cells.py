"""Each cell at a tiny size on the CPU, through the port (its plain
versions) and the reference: the program is correct, the control (the
reference a precision lower in the program's place) and every planted fault
are not."""

import pytest
import torch

from portbench import faults, harness
from tiny import TINY, tiny_run

CELLS = sorted(TINY)
FAULT_CASES = [(c, f) for c in CELLS
               for f in faults.FAULTS[harness.load_cell(c).traffic["kind"]]]


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(name):
    run, res = tiny_run(name)
    assert res["correct"], run.checks
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in run.cell.end_to_end}
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    run, res = tiny_run(name, mode="control")
    assert not res["correct"], run.checks


@pytest.mark.parametrize("name,fault", FAULT_CASES)
def test_planted_fault_is_not_correct(name, fault):
    with faults.planted(harness.load_cell(name).traffic["kind"], fault):
        run, res = tiny_run(name)
    assert not res["correct"], run.checks


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_its_per_layer_metrics(name):
    run, res = tiny_run(name, trace=True)
    assert res["correct"]
    host = {"sampler.host_ms_per_step.guided"}  # the CPU run has no device trace
    assert host & {m["name"] for m in run.cell.per_layer} <= set(res["metrics"])
    assert run.trace_data is not None and run.trace_data.window_s > 0


def test_the_same_seed_gives_the_same_inputs():
    a, _ = tiny_run("burgers-guided-ddpm-b50", seed=2**31 + 5)
    b, _ = tiny_run("burgers-guided-ddpm-b50", seed=2**31 + 5)
    assert a.checks == b.checks
