#!/usr/bin/env python
"""Time K5a (``csrc/linear_attention_tc.cu``) at the K5 sites of one Burgers
UNet2D forward at batch 50, on one NVIDIA GPU, with its heads over one CTA
(head groups 1) and over two (head groups 2).

For each site (B, H, W, C): the device time alone of K5a and of the whole
block (``chip_smoke.timed_graph``: 20 calls in a CUDA graph, its replay
timed by two events) with ``attention.la_head_groups`` forced to 1, then to
2, and the max |err| of the block against the plain version under each.
Each site is timed in the order 1, 2, 2, 1, and each time is the mean of
its two readings. Prints one JSON line per site and a ``total`` line:
device ms per forward under each head-group count and under the plan.

Run from the repository root:
``python3 -m diffphycon_tpu_torch.tools.sweep_la_head_groups``.
"""

import json
import sys

import torch

import chip_smoke as cs
from diffphycon_tpu_torch.kernels import attention as ka

GROUPS = (1, 2)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from diffphycon_tpu_torch.kernels import unet2d_blocks as kb

    gen = torch.Generator(device="cuda").manual_seed(0)
    counts = {}
    for kind, args, _ in cs.main_path_calls(cs.DIM, cs.MULTS, cs.B):
        if kind == "linear_attention_block":
            counts[args] = counts.get(args, 0) + 1
    planner = ka.la_head_groups
    totals = {f"{what}_{g}": 0.0 for what in ("k5a", "block") for g in GROUPS}
    totals.update({"k5a_plan": 0.0, "block_plan": 0.0})
    with torch.no_grad():
        for args, count in sorted(counts.items()):
            kern, plain, _, _, _, extra = cs.kernel_case(torch, F, kb, gen,
                                                         "linear_attention_block", args)
            ref = plain()
            b, h, w, _ = args
            plan = planner(b, ka.la_chunk_plan(b, h * w)[1])
            runs = {g: {"k5a": [], "block": [], "max_abs_err": 0.0} for g in GROUPS}
            try:
                for g in GROUPS + GROUPS[::-1]:
                    ka.la_head_groups = lambda B, S, g=g: g
                    ka._linear_shapes.cache_clear()
                    r = runs[g]
                    r["max_abs_err"] = max(r["max_abs_err"], (kern() - ref).abs().max().item())
                    for key, fn in (("k5a", extra["k5a"]), ("block", kern)):
                        ms, why = cs.timed_graph(torch, fn)
                        if why is not None:
                            print(json.dumps({"site": list(args), "head_groups": g,
                                              "error": why}), flush=True)
                            return 1
                        r[key].append(ms)
            finally:
                ka.la_head_groups = planner
                ka._linear_shapes.cache_clear()
            line = {"site": list(args), "per_forward": count, "plan": plan}
            for g in GROUPS:
                r = runs[g]
                k5a, block = sum(r["k5a"]) / 2, sum(r["block"]) / 2
                line[f"head_groups_{g}"] = {"k5a_device_us": 1e3 * k5a,
                                            "block_device_us": 1e3 * block,
                                            "readings_us": [1e3 * t for t in r["k5a"]],
                                            "max_abs_err": r["max_abs_err"]}
                totals[f"k5a_{g}"] += count * k5a
                totals[f"block_{g}"] += count * block
                if g == plan:
                    totals["k5a_plan"] += count * k5a
                    totals["block_plan"] += count * block
            print(json.dumps(line), flush=True)
    print(json.dumps({"total": "device ms per forward at batch 50", **totals}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
