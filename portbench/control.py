"""Readings of the correctness check's control, or of the program, on seeds.

    python3 portbench/control.py --workload <name> --seeds 1 2 3 [--seconds 5]
        [--mode control | --mode program | --fault unchanged|half_batch|altered]

For each seed, one run of the cell (a short window at the cell's own size)
in which the plain reference, computed in the precision below the one the
configuration states (float8 e4m3 for bfloat16), stands in the program's
place (``--mode control``), the program itself (``--mode program``), or the
program with a fault planted under it (``--fault``, portbench/faults.py). It
prints each run's compared numbers and its ``correct``; the control's and
the faults' have to come out false. The benchmark's own runs never run
them.
"""

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import faults, harness  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--mode", choices=("control", "program"), default="control")
    p.add_argument("--fault", choices=("unchanged", "half_batch", "altered"), default=None,
                   help="run the program with this fault planted (portbench/faults.py)")
    args = p.parse_args(argv)
    if args.fault:
        args.mode = "program"
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        cell = harness.load_cell(args.workload)
        run = harness.Run(cell=cell, seed=seed, seconds=args.seconds, trace=False,
                          device="cuda", t_start=time.perf_counter(), mode=args.mode)
        with (faults.planted(cell.traffic["kind"], args.fault) if args.fault
              else contextlib.nullcontext()):
            res = harness.execute(run)
        print(json.dumps({"workload": args.workload, "mode": args.mode, "fault": args.fault,
                          "seed": seed,
                          "correct": res["correct"], "attempted": res["attempted"],
                          "checks": {n: v for n, v, _ in run.checks}}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
