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

``--bf16`` times the bf16 variant (bf16 ``wqkv`` and ``wo``) the same way
over every chunk of ``attention.LA_CHUNKS`` too: each site in the order
(chunk, head groups) as listed, then reversed, head groups 1 left out where
C > 256 (the variant's resident k | v columns would not fit), and the
``total`` line per (chunk, head groups) choice and under the plan
(``la_chunk_plan``, ``la_head_groups(..., bf16=True)``).

Run from the repository root:
``python3 -m diffphycon_tpu_torch.tools.sweep_la_head_groups [--bf16]``.
"""

import argparse
import json
import sys

import torch

import chip_smoke as cs
from diffphycon_tpu_torch.kernels import attention as ka

GROUPS = (1, 2)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bf16", action="store_true", help="the bf16 variant, every chunk too")
    args_ = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    counts = {}
    for kind, args, _ in cs.main_path_calls(cs.DIM, cs.MULTS, cs.B):
        if kind == "linear_attention_block":
            counts[args] = counts.get(args, 0) + 1
    planner, chunker = ka.la_head_groups, ka.la_chunk_plan
    totals = {"k5a_plan": 0.0, "block_plan": 0.0}
    wdt = torch.bfloat16 if args_.bf16 else torch.float32

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale + shift

    with torch.no_grad():
        for args, count in sorted(counts.items()):
            b, h, w, c = args
            n = h * w
            x = rnd(b, h, w, c)
            p = {"norm_g": rnd(c, scale=0.1, shift=1.0),
                 "wqkv": rnd(c, 384, scale=c ** -0.5).to(wdt),
                 "wo": rnd(128, c, scale=128 ** -0.5).to(wdt), "bo": rnd(c, scale=0.1),
                 "out_g": rnd(c, scale=0.1, shift=1.0)}
            ref = ka.linear_attention_block_plain(x, p)
            chunk0, s0 = chunker(b, n)
            plan = (chunk0, planner(b, s0, C=c, bf16=args_.bf16))
            chunks = ka.LA_CHUNKS if args_.bf16 else (chunk0,)
            choices = [(ch, g) for ch in chunks for g in GROUPS
                       if not (args_.bf16 and g == 1 and c > 256)]
            runs = {v: {"k5a": [], "block": [], "max_abs_err": 0.0} for v in choices}
            try:
                for ch, g in choices + choices[::-1]:
                    ka.la_head_groups = lambda B, S, *a, g=g, **k: g
                    ka.la_chunk_plan = lambda B, n_, *a, ch=ch: (ch, -(-n_ // ch))
                    ka._linear_shapes.cache_clear()
                    # the stages' scratch is sized under the forced plan
                    k5a = ka.linear_attention_stages(x, p)[0]
                    r = runs[(ch, g)]
                    out = ka.linear_attention_block(x, p)
                    r["max_abs_err"] = max(r["max_abs_err"], (out - ref).abs().max().item())
                    for key, fn in (("k5a", k5a),
                                    ("block", lambda: ka.linear_attention_block(x, p))):
                        ms, why = cs.timed_graph(torch, fn)
                        if why is not None:
                            print(json.dumps({"site": list(args), "chunk": ch, "head_groups": g,
                                              "error": why}), flush=True)
                            return 1
                        r[key].append(ms)
            finally:
                ka.la_head_groups, ka.la_chunk_plan = planner, chunker
                ka._linear_shapes.cache_clear()
            line = {"site": list(args), "per_forward": count, "bf16": args_.bf16,
                    "plan": {"chunk": plan[0], "head_groups": plan[1]}}
            for ch, g in choices:
                r = runs[(ch, g)]
                k5a, block = sum(r["k5a"]) / 2, sum(r["block"]) / 2
                name = f"chunk_{ch}_head_groups_{g}" if args_.bf16 else f"head_groups_{g}"
                line[name] = {"k5a_device_us": 1e3 * k5a, "block_device_us": 1e3 * block,
                              "readings_us": [1e3 * t for t in r["k5a"]],
                              "max_abs_err": r["max_abs_err"]}
                for key, v in (("k5a", k5a), ("block", block)):
                    totals[f"{key}_{name}"] = totals.get(f"{key}_{name}", 0.0) + count * v
                if (ch, g) == plan:
                    totals["k5a_plan"] += count * k5a
                    totals["block_plan"] += count * block
            print(json.dumps(line), flush=True)
    print(json.dumps({"total": "device ms per forward at batch 50", **totals}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
