#!/usr/bin/env python
"""Time every tile plan of K1 and K2 (``csrc/igemm_tc.cuh``) at the K1/K2
shapes of one Burgers UNet2D forward at batch 50, on one NVIDIA GPU, and fit
the plan model of ``unet2d_blocks.tile_plan`` to the times.

For each signature: the plan ``tile_plan`` picks, every plan of
``plan_candidates`` and cuDNN's ``F.conv2d`` (TF32 off), each the median of
CUDA-event-timed calls (one call per event pair, as ``chip_smoke.py`` phase
3 times them). Prints one JSON line per signature, then a ``fit`` line: the
least-squares fit, in relative error, of the model's costs (per tile: us per
ring slice and per CTA; us per million split-K floats) plus a constant per
call that no plan changes; the per-forward sums of the plans the module's
costs pick, of those the fitted costs would pick, of the fastest plan per
signature and of cuDNN. ``TC_TILES`` and ``SPLIT_US_PER_MFLOAT`` are set
from that line.

Run from the repository root:
``python3 -m diffphycon_tpu_torch.tools.sweep_igemm_tc``.
"""

import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke as cs
from diffphycon_tpu_torch.kernels import unet2d_blocks as kb


def time_plans(kern, m, n, k):
    """{plan: ms} of kern under every candidate plan, forced through
    ``kb.tile_plan`` (restored after)."""
    planner = kb.tile_plan
    times = {}
    try:
        for plan in kb.plan_candidates(n, k):
            kb.tile_plan = lambda *_, plan=plan: plan
            times[plan] = cs.timed(torch, kern, n=10)
    finally:
        kb.tile_plan = planner
    return times


def fit_costs(rows):
    """Per-tile (us per slice, us per CTA), us per million split-K floats
    and us per call, fitted to rows of ((m, n, k), {plan: ms})."""
    tiles = list(kb.TC_TILES)
    a, y = [], []
    for (m, n, _), times in rows:
        for plan, ms in times.items():
            row = np.zeros(2 * len(tiles) + 2)
            i = tiles.index((plan.bm, plan.bn))
            waves = kb.plan_waves(plan, m, n)
            row[2 * i], row[2 * i + 1] = waves * plan.per, waves
            row[-2], row[-1] = plan.workspace_floats(m, n) / 1e6, 1.0
            a.append(row / (1e3 * ms))  # relative error
            y.append(1.0)
    sol = np.linalg.lstsq(np.array(a), np.array(y), rcond=None)[0]
    fitted = {t: (float(sol[2 * i]), float(sol[2 * i + 1]), kb.TC_TILES[t][2])
              for i, t in enumerate(tiles)}
    return fitted, float(sol[-2]), float(sol[-1])


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    per_fwd = {}
    for name, args, _ in cs.main_path_calls(cs.DIM, cs.MULTS, cs.B):
        if name in cs.TC_KERNELS:
            per_fwd[(name, args)] = per_fwd.get((name, args), 0) + 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, libs = [], []
    with torch.no_grad():
        for (name, args), count in per_fwd.items():
            kern, _, library, _, _, _ = cs.kernel_case(torch, F, kb, gen, name, args)
            mnk = cs.gemm_dims(name, args)
            times = time_plans(kern, *mnk)
            lib_ms = cs.timed(torch, library, n=10)
            pick = kb.tile_plan(*mnk)
            rows.append((mnk, times))
            libs.append(lib_ms)
            print(json.dumps({"kernel": name, "args": list(args), "per_forward": count,
                              "mnk": list(mnk), "picked": pick._asdict(),
                              "picked_ms": times[pick], "library_ms": lib_ms,
                              "plans_ms": {f"{p.bm}x{p.bn}s{p.splits}": t
                                           for p, t in times.items()}}), flush=True)
    tiles, split_us, call_us = fit_costs(rows)
    counts = list(per_fwd.values())
    total = {"picked_ms": 0.0, "fit_picked_ms": 0.0, "fastest_ms": 0.0, "library_ms": 0.0}
    for count, (mnk, times), lib_ms in zip(counts, rows, libs):
        total["picked_ms"] += count * times[kb.tile_plan(*mnk)]
        total["fit_picked_ms"] += count * times[kb.pick_plan(*mnk, tiles, split_us)]
        total["fastest_ms"] += count * min(times.values())
        total["library_ms"] += count * lib_ms
    print(json.dumps({"fit": {"TC_TILES": {f"{bm}x{bn}": [round(s, 2), round(c, 2)]
                                           for (bm, bn), (s, c, _) in tiles.items()},
                              "SPLIT_US_PER_MFLOAT": round(split_us, 2),
                              "us_per_call": round(call_us, 2)},
                      "per_forward": total, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
