#!/usr/bin/env python
"""Time K3 (``csrc/group_norm_act.cu``) at the K3 signatures of one Burgers
UNet2D forward at batch 50, on one NVIDIA GPU, under every cluster size.

For each signature (B, H, W, C, FiLM): the device time alone of one call
(``chip_smoke.timed_graph``: 20 calls in a CUDA graph, its replay timed by
two events) with the cluster forced to 1, 2, 4 and 8 CTAs, and the max |err|
against the plain version under each; then, under the plan
``unet2d_blocks.gn_cluster_plan`` picks, one call per event pair
(``chip_smoke.timed``, host and device) and the host's enqueue time per call
(50 calls back to back on the host's clock). Prints one JSON line per
signature and a ``total`` line: device ms per forward under each forced
cluster size and under the plan.

Run from the repository root:
``python3 -m diffphycon_tpu_torch.tools.sweep_gn_cluster``.
"""

import json
import sys
import time

import torch

import chip_smoke as cs
from diffphycon_tpu_torch.kernels import unet2d_blocks as kb

CLUSTERS = (1, 2, 4, 8)


def host_us(fn, n=50):
    """Host microseconds per call of fn, n calls enqueued back to back."""
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(n):
        fn()
    us = 1e6 * (time.perf_counter() - tic) / n
    torch.cuda.synchronize()
    return us


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    counts = {}
    for kind, args, _ in cs.main_path_calls(cs.DIM, cs.MULTS, cs.B):
        if kind == "group_norm_act":
            counts[args] = counts.get(args, 0) + 1
    planner = kb.gn_cluster_plan
    totals = {c: 0.0 for c in CLUSTERS}
    totals["plan"] = 0.0
    with torch.no_grad():
        for (b, h, w, c, film), count in sorted(counts.items()):
            x = torch.randn(b, h, w, c, generator=gen, device="cuda")
            gamma = torch.randn(c, generator=gen, device="cuda")
            beta = torch.randn(c, generator=gen, device="cuda")
            ss = torch.randn(b, 2 * c, generator=gen, device="cuda") if film else None
            res = None if film else torch.randn(b, h, w, c, generator=gen, device="cuda")

            def fn():
                return kb.group_norm_act(x, gamma, beta, 1, ss=ss, res=res)

            ref = kb.group_norm_act_plain(x, gamma, beta, 1, ss=ss, res=res)
            by_cluster = {}
            try:
                for cluster in CLUSTERS:
                    kb.gn_cluster_plan = lambda rows, length, cluster=cluster: cluster
                    kb._gn_plan.cache_clear()
                    err = (fn() - ref).abs().max().item()
                    dev_ms, why = cs.timed_graph(torch, fn)
                    by_cluster[cluster] = {"device_us": None if dev_ms is None else 1e3 * dev_ms,
                                           "max_abs_err": err, **({"error": why} if why else {})}
                    totals[cluster] += count * (dev_ms or float("nan"))
            finally:
                kb.gn_cluster_plan = planner
                kb._gn_plan.cache_clear()
            dev_ms, _ = cs.timed_graph(torch, fn)
            totals["plan"] += count * (dev_ms or float("nan"))
            print(json.dumps({"signature": [b, h, w, c, film], "per_forward": count,
                              "plan": planner(b, h * w * c), "by_cluster": by_cluster,
                              "device_us": None if dev_ms is None else 1e3 * dev_ms,
                              "event_pair_us": 1e3 * cs.timed(torch, fn, n=50),
                              "host_enqueue_us": host_us(fn)}), flush=True)
    print(json.dumps({"total": "device ms per forward at batch 50",
                      **{str(k): v for k, v in totals.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
