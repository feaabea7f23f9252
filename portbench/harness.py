"""The benchmark's driver: find a cell by name, check the device, run it, read
its metrics, judge its outputs and print the result line.

Everything particular to a cell lives in files found by name:
``BENCHMARK.json`` (the cell's configuration, traffic, chips and metrics),
``configs/<config>.json`` (the configuration as run), ``traffic/<traffic>.json``
(the mix: its ``kind`` names the general generator in ``drivers/``, the rest
are its parameters), ``workloads/<cell>.json`` (the cell's correctness
limits) and ``metrics/<metric>.py`` (one reader per per-layer metric). The
configuration's ``system`` names the module in ``systems/`` that wires the
port and the plain reference for it.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "diffphycon_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, benchmark: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files and the metrics it
    reports: an end-to-end metric without ``workloads`` applies to every
    cell, a per-layer metric without it to every cell that reports the
    end-to-end metric it moves."""
    spec = load_json(benchmark)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {benchmark} (have {sorted(cells)})")
    w = cells[name]
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}

    def applies(m):
        return name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names

    layer = [m for m in spec["per_layer"] if applies(m)]
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                chips=w["chips"],
                cfg=load_json(HERE / "configs" / f"{w['config']}.json"),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "workloads" / f"{name}.json")["limits"],
                end_to_end=e2e, per_layer=layer)


def load_reader(metric: str):
    """metrics/<metric>.py's ``read(run) -> float | None``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """One run of a cell: its arguments, and what the driver measured."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    mode: str = "program"  # "control": the reference in a lower precision stands in
    attempted: int = 0
    failed: int = 0
    e2e: dict = dataclasses.field(default_factory=dict)
    stats: dict = dataclasses.field(default_factory=dict)
    checks: list = dataclasses.field(default_factory=list)  # (name, value, limit)
    memory_peak_bytes: int = 0
    trace_data: object = None  # yardstick.Trace of the traced window

    @property
    def cfg(self):
        return self.cell.cfg

    @property
    def traffic(self):
        return self.cell.traffic


def driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


def system(name: str):
    return importlib.import_module(f"portbench.systems.{name}")


def set_cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout, so that only a
    checkout's first run builds (the port's own nvcc build lands in
    build/diffphycon_tpu_torch/<source hash>/ there by itself)."""
    cache = ROOT / "build" / "portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(run: Run) -> dict:
    """Run the cell's driver, then its per-layer readers (traced runs);
    returns the result line's object (without the device block)."""
    driver(run.traffic["kind"]).run(run)
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in run.checks) and bool(run.checks)
    if run.trace:
        metrics = {}
        for m in run.cell.per_layer:
            value = load_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": run.e2e[m["name"]], "unit": m["unit"]}
                   for m in run.cell.end_to_end}
    return {"correct": ok, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = load_cell(args.workload)
    set_cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"cuda available {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    run = Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              device="cuda", t_start=t_start)
    result = execute(run)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}: the port must not import JAX "
              "or the JAX package", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    if run.trace:
        device["busy_s"] = run.trace_data.busy_s()
        device["window_s"] = run.trace_data.window_s
        result["breakdown"] = {"device_ops": run.trace_data.top_ops(10),
                               "idle_gaps": run.trace_data.idle_gaps(10)}
    result["device"] = device
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in run.checks}
    if run.trace:  # the union of the streams' intervals beside their plain sum
        t = run.trace_data
        print(f"trace: window_s {t.window_s!r} busy_union_s {t.busy_s()!r} "
              f"busy_summed_s {t.summed_s()!r} steps {run.stats['steps_traced']}",
              file=sys.stderr)
    for name, v in run.stats.get("uncompared", {}).items():
        print(f"reading {name} (not compared): {v!r}", file=sys.stderr)
    for name, v, lim in run.checks:
        print(f"check {name}: {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
