"""Every name in BENCHMARK.json resolves to its files, within the contract's
limits."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"] and SPEC["command"][1] == "portbench/run.py"
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
    assert len(names) == len(set(names))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_configs_are_files_under_paths():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert (ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = harness.load_cell(name)
    assert harness.driver(cell.traffic["kind"]).run
    assert harness.system(cell.cfg["system"])
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(harness.load_reader(m["name"]))
    assert cell.limits and all(v > 0 for v in cell.limits.values())


def test_every_per_layer_metric_has_a_reader_and_a_layer():
    layers = {}
    for m in SPEC["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        layers.setdefault(m["layer"], 0)
    assert set(layers) <= {"sampler", "trainer", "nets", "blocks", "kernels", "solver", "device"}


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell("no-such-cell")
