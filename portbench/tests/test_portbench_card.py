"""On the card: each cell at its own size with a short window is correct,
and its control is not. Skips without a CUDA device.

    python -m pytest portbench/tests -q -m cuda
"""

import json
import time

import pytest

from portbench import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"] if w["chips"] == 1]


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["program", "control"])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, mode):
    _card()
    harness.set_cache_dirs()
    run = harness.Run(cell=harness.load_cell(name), seed=2**31 + 17, seconds=2.0,
                      trace=mode == "program", device="cuda", t_start=time.perf_counter(),
                      mode=mode)
    res = harness.execute(run)
    assert res["correct"] == (mode == "program"), run.checks
    if mode == "program":
        assert set(res["metrics"]) == {m["name"] for m in run.cell.per_layer}
        assert 0 < run.trace_data.busy_s() <= run.trace_data.window_s
    assert not harness.forbidden_modules()
