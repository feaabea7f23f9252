#!/usr/bin/env python
"""Where K8's time goes, on one NVIDIA GPU: SM clocks per stage of the
persistent kernel (``csrc/unet2d_persistent.cuh``), summed by op class over
one forward.

``nsys`` and ``ncu`` do not run on the machines the port is measured on, so
the kernel carries ``MEGA_STAMP`` marks: thread 0 of each CTA writes
clock64() when a stage starts, when its work ends and when its grid
barrier ends. They compile to nothing unless ``MEGA_PHASE_CLOCKS`` is
defined; this tool builds that variant (``_build.build``, a directory of
its own beside the plain build) and launches it through ctypes on the
full-width Burgers UNet2D (dim 64, mults (1, 2, 4, 8), seeded weights) at
batch 50 (``--batch``), on the inputs ``UNet2D.forward_mega`` gives it.

With ``--pairs`` it does the same for K7 (``resblock_pair``) at
``chip_smoke.py``'s five pair shapes. With ``--bf16`` the weights are
bf16 (``BurgersConfig(bf16=True)``; K7's conv weights rounded to bf16), so
the kernel's bf16 instantiation runs.

Prints JSON lines: the launch's time (median of 5 event pairs) and the
card; per op class (conv, conv with split-K, down, GroupNorm statistics and
apply, linear attention context and output, full attention, barrier wait)
the stages, the SM clocks summed over the forward's stages of the mean over
CTAs, their share of the forward's clocks, and that share of the launch's
time; the ten stages with the most work clocks. The stamps add a store per
stage and CTA; the build with them is timed beside the plain one.

Run from the repository root:
``python3 -m diffphycon_tpu_torch.tools.mega_stage_clocks [--batch B] [--pairs] [--bf16]``.
"""

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from diffphycon_tpu_torch.kernels import _build
from diffphycon_tpu_torch.kernels import unet2d_mega as km

STAMP_GRID = 256  # CTAs per stage in the stamp array (unet2d_persistent.cuh: kStampGrid)
STAMP_STAGES = 1024
CLASSES = ("conv", "conv_split_k", "down", "gn_stats", "gn_apply", "la_context", "la_output",
           "attention", "barrier_wait")


def op_class(stage) -> str:
    name = km.OP_NAMES[stage.op]
    if name in ("conv", "down") and stage.ints.get("splits", 1) > 1:
        return "conv_split_k"
    if name.startswith("att_"):
        return "attention"
    return name


def build() -> ctypes.CDLL:
    dll = ctypes.CDLL(str(_build.build(("MEGA_PHASE_CLOCKS",))))
    for name, argtypes in _build.SIGNATURES.items():
        getattr(dll, name).argtypes = argtypes
        getattr(dll, name).restype = ctypes.c_int
    for name in ("mega_stamps_read", "mega_stamps_read_bf16"):  # per instance
        getattr(dll, name).argtypes = [ctypes.c_void_p, ctypes.c_int]
    return dll


def stage_clocks(torch, cs, dll, grid, plan, inputs, kernel_call, label):
    """Launch `plan` once through the clocks build and print its rows (see
    the module docstring). inputs: the plan's bound tensors; kernel_call:
    the same launch through the plain build, for its time and the
    bit-equality check."""
    n = len(plan.stages)
    if n > STAMP_STAGES or grid > STAMP_GRID:
        raise SystemExit("mega_stage_clocks: the stamp array is too small")
    out = torch.empty(plan.out_shape, device="cuda")

    def launch():
        km._launch(plan, inputs, out, lib=dll)

    ms = cs.timed(torch, launch, n=5)
    plain_ms = cs.timed(torch, kernel_call, n=5)
    launch()
    torch.cuda.synchronize()
    bit_equal = torch.equal(out, kernel_call())
    raw = np.zeros(STAMP_STAGES * STAMP_GRID * 3, np.int64)
    read = (dll.mega_stamps_read_bf16 if plan.weight_dtype == torch.bfloat16
            else dll.mega_stamps_read)
    _build.check(read(raw.ctypes.data, raw.size), "mega_stamps_read")
    st = raw.reshape(STAMP_STAGES, STAMP_GRID, 3)[:n, :grid].astype(np.float64)
    work = (st[:, :, 1] - st[:, :, 0]).mean(axis=1)  # per stage, mean over CTAs
    wait = (st[:, :, 2] - st[:, :, 1]).mean(axis=1)
    total = float((st[n - 1, :, 2] - st[0, :, 0]).mean())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"tool": "mega_stage_clocks", **label,
                      "weight_dtype": str(plan.weight_dtype),
                      "grid": grid, "stages": n,
                      "barriers": plan.barriers(), "launch_ms_clocks_build": ms,
                      "launch_ms_plain_build": plain_ms, "bit_equal_to_plain_build": bit_equal,
                      "launch_clocks": total, "nvidia_smi": smi}), flush=True)
    # wait_after: clocks in the barriers that close this class's stages (the
    # CTAs that finished early wait for the slowest)
    rows = {c: {"stages": 0, "clocks": 0.0, "wait_after": 0.0} for c in CLASSES}
    for i, stage in enumerate(plan.stages):
        r = rows[op_class(stage)]
        r["stages"] += 1
        r["clocks"] += float(work[i])
        if stage.sync:
            r["wait_after"] += float(wait[i])
            rows["barrier_wait"]["stages"] += 1
            rows["barrier_wait"]["clocks"] += float(wait[i])
    for c, r in rows.items():
        if r["stages"]:
            share = r["clocks"] / total
            print(json.dumps({**label, "class": c, **r, "share": share,
                              "ms_at_share": share * ms}), flush=True)
    top = np.argsort(-work)[:10]
    print(json.dumps({**label, "top_stages": [
        {"stage": int(i), "op": km.OP_NAMES[plan.stages[i].op],
         "ints": {k: v for k, v in plan.stages[i].ints.items() if v},
         "clocks": float(work[i]), "barrier_wait": float(wait[i])} for i in top]}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=50)
    ap.add_argument("--pairs", action="store_true",
                    help="K7 at chip_smoke.py's five pair shapes instead of K8")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 weights: the kernel's bf16 instantiation")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mega_stage_clocks: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from diffphycon_tpu_torch.benchmarks import burgers as bench
    from diffphycon_tpu_torch.nets import unet2d as tunet

    dll = build()
    grid = ctypes.c_int(0)
    _build.check(dll.unet2d_persistent_grid(ctypes.byref(grid)), "unet2d_persistent_grid")
    gen = torch.Generator(device="cuda").manual_seed(10)
    B = args.batch
    with torch.no_grad():
        if args.pairs:
            for h, w, c in cs.PAIR_SHAPES:
                x = torch.randn(B, h, w, c, generator=gen, device="cuda")
                ss = [0.5 * torch.randn(B, 2 * c, generator=gen, device="cuda") for _ in "ab"]
                p = [cs._res_pack(torch, gen, c) for _ in "ab"]
                if args.bf16:
                    p = [cs._bf16_pair_pack(torch, q) for q in p]
                plan = km._pair_plan(tuple(x.shape), (2 * c, 2 * c), 1, *p, x.device)
                stage_clocks(torch, cs, dll, grid.value, plan, (x, *ss),
                             lambda: km.resblock_pair_launch(x, *ss, *p, 1)[0],
                             {"kernel": "resblock_pair", "shape": [B, h, w, c]})
            return 0
        cfg = bench.BurgersConfig(is_condition_u0=True, is_condition_uT=True, bf16=args.bf16,
                                  impl="pallas")
        net = bench.init_params(cfg, seed=0, device="cuda")
        x = torch.randn(B, cfg.pad_t, cfg.nx, 2, generator=gen, device="cuda")
        t = torch.linspace(0, 999, B, device="cuda")
        packs = net._kernel_pack()
        film = net._film(t, packs)
        x0 = tunet._conv_nchw(x, net.init_conv, net.weight_dtype)
        plan = km.mega_plan(packs, x0.shape, net.groups, cs.HEADS, cs.DIM_HEAD, x0.device,
                            grid=grid.value)
        stage_clocks(torch, cs, dll, grid.value, plan, (x0, film),
                     lambda: km.unet2d_mega(x0, film, packs, plan),
                     {"kernel": "unet2d_mega", "batch": B})
    return 0


if __name__ == "__main__":
    sys.exit(main())
