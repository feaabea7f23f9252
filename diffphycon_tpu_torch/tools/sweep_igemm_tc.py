#!/usr/bin/env python
"""Time every tile plan of K1 and K2 at the K1/K2 shapes of one Burgers
UNet2D forward at batch 50, on one NVIDIA GPU, and fit the plan model of
``unet2d_blocks.tile_plan`` to the times.

Without flags: the 3xTF32 core (``csrc/igemm_tc.cuh``), every plan of
``plan_candidates`` over ``TC_TILES`` beside cuDNN's ``F.conv2d`` (TF32
off), each time the median of CUDA-event-timed calls (one call per event
pair, as ``chip_smoke.py`` times them). ``--bf16``: the bf16 variants on
the bf16 core (``csrc/igemm_bf16.cuh``), bf16 weights, every plan over
``TC_TILES_BF16`` in 64-deep stages beside cuDNN's bf16 conv on operands
cast outside the timing (as ``chip_smoke.py`` phase 16 times it), each time
the device's alone (20 calls in a CUDA graph): the host's ~20-30 us per
call, which no plan changes, varied between two runs by more than the
plans differ; beside each plan's time its error relative to max(1, max
|ref|) against the plain bf16 version (float32 sums), so that the deepest
conv's one-split plans show how far one accumulation chain of all its
stages strays. Prints one JSON line per signature, then a ``fit`` line:
the least-squares fit, in relative error, of the model's costs (per tile: us per ring stage and per CTA; us
per million split-K floats) plus a constant per call that no plan changes;
the per-forward sums of the plans the module's costs pick, of those the
fitted costs would pick under the module's rule (``--bf16``: the modelled
time alone; and, under ``full_wave_first_ms``, with the plans that fill a
wave first), of the fastest plan per signature and of cuDNN.
``TC_TILES`` and ``SPLIT_US_PER_MFLOAT`` (``--bf16``: ``TC_TILES_BF16``
and ``SPLIT_US_PER_MFLOAT_BF16``) are set from that line.

``--clocks`` (with ``--bf16``) times the phases of the bf16 core's stages
instead: it builds the kernels with ``-DIGEMM_BF16_CLOCKS`` (clock64() at
each phase of every stage of block (0, 0, 0), lane 0 of each warpgroup) and
prints for a few batch-50 signatures and plans, and for one GEMM of them
with its channels split between two sources off the 64-channel blocks (so
that its A tiles come by the cp.async gather, not by TMA boxes), the mean
clocks per stage of each phase (issue: the products issued; mma_wait: the
previous stage's products; cp_wait: this thread's gather copies; barrier;
loads: the next copies issued; frags: the next stage's mbarrier and A
fragments; to_next: the loop) beside the device ms of the launch (CUDA
graph).

Run from the repository root:
``python3 -m diffphycon_tpu_torch.tools.sweep_igemm_tc [--bf16 [--clocks]]``.
"""

import argparse
import ctypes
import json
import math
import sys

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke as cs
from diffphycon_tpu_torch.kernels import _build
from diffphycon_tpu_torch.kernels import unet2d_blocks as kb

def forced(plan):
    """A stand-in for ``kb.tile_plan`` that returns `plan` for any GEMM."""
    return lambda *_, plan=plan: plan


def timer(bf16):
    """ms of one call: the median of event-pair-timed calls (3xTF32), or
    with bf16 the device time alone (20 calls in a CUDA graph)."""
    if bf16:
        return lambda fn: cs.timed_graph(torch, fn)[0]
    return lambda fn: cs.timed(torch, fn, n=10)


def time_plans(kern, plain, m, n, k, bf16):
    """({plan: ms}, {plan: relative error}) of kern under every candidate
    plan, forced through ``kb.tile_plan`` (restored after); the errors
    (``bf16`` only) against plain."""
    tiles, bk = (kb.TC_TILES_BF16, kb.TC_BK_BF16) if bf16 else (kb.TC_TILES, kb.TC_BK)
    planner, ms = kb.tile_plan, timer(bf16)
    ref = plain() if bf16 else None
    scale = max(1.0, ref.abs().max().item()) if bf16 else None
    times, errs = {}, {}
    try:
        for plan in kb.plan_candidates(n, k, tiles, bk):
            kb.tile_plan = forced(plan)
            times[plan] = ms(kern)
            if bf16:
                errs[plan] = (kern() - ref).abs().max().item() / scale
    finally:
        kb.tile_plan = planner
    return times, errs


def fit_costs(rows, tiles):
    """Per-tile (us per stage, us per CTA), us per million split-K floats
    and us per call, fitted to rows of ((m, n, k), {plan: ms})."""
    names = list(tiles)
    a, y = [], []
    for (m, n, _), times in rows:
        for plan, ms in times.items():
            row = np.zeros(2 * len(names) + 2)
            i = names.index((plan.bm, plan.bn))
            waves = kb.plan_waves(plan, m, n, tiles)
            row[2 * i], row[2 * i + 1] = waves * plan.per, waves
            row[-2], row[-1] = plan.workspace_floats(m, n) / 1e6, 1.0
            a.append(row / (1e3 * ms))  # relative error
            y.append(1.0)
    sol = np.linalg.lstsq(np.array(a), np.array(y), rcond=None)[0]
    fitted = {t: (float(sol[2 * i]), float(sol[2 * i + 1]), tiles[t][2])
              for i, t in enumerate(names)}
    return fitted, float(sol[-2]), float(sol[-1])


def sweep(bf16: bool) -> None:
    tiles, bk = (kb.TC_TILES_BF16, kb.TC_BK_BF16) if bf16 else (kb.TC_TILES, kb.TC_BK)
    split_us = kb.SPLIT_US_PER_MFLOAT_BF16 if bf16 else kb.SPLIT_US_PER_MFLOAT
    per_fwd = {}
    for name, args, _ in cs.main_path_calls(cs.DIM, cs.MULTS, cs.B):
        if name in cs.TC_KERNELS:
            per_fwd[(name, args)] = per_fwd.get((name, args), 0) + 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, libs = [], []
    with torch.no_grad():
        for (name, args), count in per_fwd.items():
            kern, plain, library, flops, _, _ = cs.kernel_case(torch, F, kb, gen, name, args,
                                                               bf16=bf16)
            mnk = cs.gemm_dims(name, args)
            times, errs = time_plans(kern, plain, *mnk, bf16)
            lib_ms = timer(bf16)(library)
            pick = kb.tile_plan(*mnk, bf16)
            rows.append((mnk, times))
            libs.append(lib_ms)
            print(json.dumps({"kernel": name, "args": list(args), "per_forward": count,
                              "mnk": list(mnk), "picked": pick._asdict(),
                              "picked_ms": times[pick], "library_ms": lib_ms,
                              "picked_tflop_per_s": flops / times[pick] / 1e9,
                              "plans_ms": {f"{p.bm}x{p.bn}s{p.splits}": t
                                           for p, t in times.items()},
                              "plans_rel_err": {f"{p.bm}x{p.bn}s{p.splits}": e
                                                for p, e in errs.items()} or None}),
                  flush=True)
    fit, fit_split_us, call_us = fit_costs(rows, tiles)
    counts = list(per_fwd.values())
    total = {"picked_ms": 0.0, "fit_picked_ms": 0.0, "fastest_ms": 0.0, "library_ms": 0.0}
    if bf16:
        total["full_wave_first_ms"] = 0.0
    for count, (mnk, times), lib_ms in zip(counts, rows, libs):
        total["picked_ms"] += count * times[kb.tile_plan(*mnk, bf16)]
        # the module's rule: tile_plan(bf16=True) picks by the modelled time alone
        total["fit_picked_ms"] += count * times[kb.pick_plan(*mnk, fit, fit_split_us, bk=bk,
                                                             fill_first=not bf16)]
        if bf16:
            total["full_wave_first_ms"] += count * times[kb.pick_plan(*mnk, fit, fit_split_us,
                                                                      bk=bk)]
        total["fastest_ms"] += count * min(times.values())
        total["library_ms"] += count * lib_ms
    key = "TC_TILES_BF16" if bf16 else "TC_TILES"
    print(json.dumps({"fit": {key: {f"{bm}x{bn}": [round(s, 3), round(c, 3)]
                                    for (bm, bn), (s, c, _) in fit.items()},
                              key.replace("TC_TILES", "SPLIT_US_PER_MFLOAT"):
                                  round(fit_split_us, 3),
                              "us_per_call": round(call_us, 2)},
                      "module": {key: {f"{bm}x{bn}": list(v) for (bm, bn), v in tiles.items()},
                                 "split_us": split_us},
                      "per_forward": total,
                      "timing": "device, CUDA graph" if bf16 else "event pairs",
                      "device": torch.cuda.get_device_name(0)}))


# (kernel, signature, (bm, bn, splits), how the A tiles come): the last is
# the 8 x 64 conv's GEMM with its 128 channels as 96 + 32 from two sources
CLOCK_CASES = (("conv2d_nhwc", (50, 2, 16, 512, 256, 512, 3, False), (128, 128, 1), "boxes"),
               ("conv2d_nhwc", (50, 16, 128, 64, 0, 64, 3, False), (64, 64, 1), "boxes"),
               ("conv2d_nhwc", (50, 8, 64, 128, 0, 128, 3, False), (128, 128, 1), "boxes"),
               ("conv2d_nhwc", (50, 8, 64, 128, 0, 64, 3, True), (128, 64, 1), "boxes"),
               ("conv2d_nhwc", (50, 8, 64, 96, 32, 128, 3, False), (128, 128, 1), "gather"))
PHASES = ("issue", "mma_wait", "cp_wait", "barrier", "loads", "frags", "to_next")


def stage_clocks() -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(name, args, kb.TilePlan(bm, bn, sp, math.ceil(
                 math.ceil(cs.gemm_dims(name, args)[2] / kb.TC_BK_BF16) / sp)),
              cs.kernel_case(torch, F, kb, gen, name, args, bf16=True)[0], a_tiles)
             for name, args, (bm, bn, sp), a_tiles in CLOCK_CASES]
    loader, planner = _build.load_library, kb.tile_plan
    try:
        lib = ctypes.CDLL(str(_build.build(("IGEMM_BF16_CLOCKS",), only=("conv2d_nhwc.cu",))))
        lib.conv2d_nhwc_bf16.argtypes = _build.SIGNATURES["conv2d_nhwc_bf16"]
        lib.igemm_bf16_clocks_read.argtypes = [ctypes.c_void_p]
        _build.load_library = lambda lib=lib: lib
        for name, args, plan, kern, a_tiles in cases:
            kb.tile_plan = forced(plan)
            with torch.no_grad():
                kern()
                torch.cuda.synchronize()
                dev_ms = cs.timed_graph(torch, kern)[0]
                kern()
                torch.cuda.synchronize()
            buf = (ctypes.c_longlong * (2 * 256 * 8))()
            if lib.igemm_bf16_clocks_read(ctypes.addressof(buf)) != 0:
                raise RuntimeError("igemm_bf16_clocks_read failed")
            stages = min(plan.per + plan.per % 2, 256)
            wgs = {}
            for wg in range(plan.bm // 64):
                st = [[buf[(wg * 256 + i) * 8 + p] for p in range(7)] for i in range(stages)]
                rows = range(1, stages - 2)  # steady stages: past the first, before the last two
                d = {ph: 0 for ph in PHASES}
                for i in rows:
                    r, nxt = st[i], st[i + 1]
                    for j, ph in enumerate(PHASES[:-1]):
                        d[ph] += r[j + 1] - r[j]
                    d["to_next"] += nxt[0] - r[6]
                wgs[f"wg{wg}"] = {ph: round(v / len(rows)) for ph, v in d.items()}
                wgs[f"wg{wg}"]["per_stage"] = round((st[stages - 2][0] - st[1][0])
                                                    / (stages - 3))
            print(json.dumps({"a_tiles": a_tiles, "kernel": name, "args": list(args),
                              "tile_plan": plan._asdict(), "device_ms": dev_ms,
                              "clocks_per_stage": wgs,
                              "device": torch.cuda.get_device_name(0)}), flush=True)
    finally:
        _build.load_library, kb.tile_plan = loader, planner


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bf16", action="store_true", help="the bf16 core and its plan")
    ap.add_argument("--clocks", action="store_true",
                    help="with --bf16: the phases of each stage, TMA boxes against the gather")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    if args.clocks and not args.bf16:
        raise SystemExit("--clocks needs --bf16")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.clocks:
        stage_clocks()
    else:
        sweep(args.bf16)
    return 0


if __name__ == "__main__":
    sys.exit(main())
