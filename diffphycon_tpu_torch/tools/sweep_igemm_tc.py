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

``--bf16act`` times K1c and K2c (``csrc/igemm_bf16act.cu``: K1 and K2 on
bf16 activations, flax ``dtype=bfloat16``) at ``chip_smoke.kernel_case_bf16act``'s
inputs, drawn per signature from a CUDA generator seeded 2100 + its index
among the forward's distinct K1 / K2 signatures: one JSON line per
signature with the device ms under the checkout's plan, its path
(``unet2d_blocks.bf16act_path``; with a halo also ``boxes_device_ms``, the
same launch with ``BF16ACT_HALO`` off), the digest of the output (the first
16 hex digits of the SHA-256 of its bytes, so that two checkouts' lines show
whether they are bit-equal), the error against the plain version, cuDNN's
bf16 conv on bf16 tensors and the bound; then a ``total`` line, device ms a
forward per kernel and output level. ``--plans`` also times every candidate
plan (``TC_TILES_BF16ACT``, or a checkout's ``TC_TILES_BF16`` before it) and
prints the fit of the persistent walk's costs (``TC_TILES_BF16ACT``,
``SPLIT_US_PER_MFLOAT_BF16ACT``: per tile, us a stage and us a tile of the
busiest CTA's walk, ``act_rounds``) with the per-forward sums of the
picked, the fit-picked and the fastest plans. ``--bf16act --clocks`` builds
the checkout's ``igemm_bf16act.cu`` alone with its clock macro (the old core's
``IGEMM_BF16_CLOCKS`` stamps, or the persistent tile's
``IGEMM_BF16ACT_CLOCKS``: ``ACT_CLK`` in ``csrc/igemm_bf16act.cuh``) beside
a reader of the stamps, and prints for a few batch-50 signatures the mean
clocks of each phase of CTA 0. ``--root DIR`` (with ``--bf16act``) imports
``diffphycon_tpu_torch`` and ``chip_smoke`` from another checkout (the
parent unpacked with ``git archive`` into a git-ignored directory) and
builds its kernels there; compare two checkouts in turns, each a process of
its own.

Run from the repository root:
``python3 diffphycon_tpu_torch/tools/sweep_igemm_tc.py [--bf16 [--clocks]]``,
``[--bf16act [--plans | --clocks] [--root DIR]]`` (as a script, so that
``--root`` can put another checkout's package first).
"""

import argparse
import ctypes
import hashlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this file
# imported in main(), from the checkout that --root names
torch = F = cs = _build = kb = None

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


# --bf16act: K1c and K2c (csrc/igemm_bf16act.cu) on bf16 activations

def _act_plan(mnk):
    """The checkout's own plan of one bf16-activation GEMM (a checkout
    without the bf16-activation plan runs the weight-only bf16 one)."""
    if hasattr(kb, "TC_TILES_BF16ACT"):
        return kb.tile_plan(*mnk, True, True)
    return kb.tile_plan(*mnk, True)


def _act_tiles():
    return getattr(kb, "TC_TILES_BF16ACT", kb.TC_TILES_BF16)


def _level(name, args):
    """The output grid (h, w) of one K1 or K2 signature."""
    h, w = args[1], args[2]
    if name == "downsample_nhwc":
        return h // 2, w // 2
    return (2 * h, 2 * w) if args[7] else (h, w)


def _digest(t):
    return hashlib.sha256(t.contiguous().view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]


def _smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def act_signatures():
    """{(kernel, args): launches per forward} of K1 and K2 at batch 50."""
    per_fwd = {}
    for name, args, _ in cs.main_path_calls(cs.DIM, cs.MULTS, cs.B):
        if name in cs.TC_KERNELS:
            per_fwd[(name, args)] = per_fwd.get((name, args), 0) + 1
    return per_fwd


def act_fit(rows):
    """Per-tile (us per stage, us per tile) of the persistent walk, us per
    million split-K floats and us per call, fitted (relative error) to rows
    of ((m, n, k), {plan: ms}) under ``unet2d_blocks.act_rounds``."""
    tiles = _act_tiles()
    names = list(tiles)
    a = []
    for (m, n, _), times in rows:
        for plan, ms in times.items():
            row = np.zeros(2 * len(names) + 2)
            i = names.index((plan.bm, plan.bn))
            rounds = kb.act_rounds(plan, m, n)
            row[2 * i], row[2 * i + 1] = rounds * plan.per, rounds
            row[-2], row[-1] = plan.workspace_floats(m, n) / 1e6, 1.0
            a.append(row / (1e3 * ms))
    sol = np.linalg.lstsq(np.array(a), np.ones(len(a)), rcond=None)[0]
    fitted = {t: (float(sol[2 * i]), float(sol[2 * i + 1]), 1) for i, t in enumerate(names)}
    return fitted, float(sol[-2]), float(sol[-1])


def sweep_act(root, all_plans) -> None:
    """Device ms of K1c / K2c per signature under the checkout's plan (and
    with ``all_plans`` under every candidate plan), the output's digest, the
    error against the plain version, cuDNN's bf16 conv on bf16 tensors and
    the bound; then the totals a forward, per kernel and output level."""
    tiles, new = _act_tiles(), hasattr(kb, "TC_TILES_BF16ACT")
    rows, total = [], {}
    planner = kb.tile_plan
    for i, ((name, args), count) in enumerate(act_signatures().items()):
        # the inputs of chip_smoke's phase 18 (BF16ACT_TC_SEED + i)
        gen = torch.Generator(device="cuda").manual_seed(2100 + i)
        kern, plain, library, flops, nbytes, _ = cs.kernel_case_bf16act(torch, F, kb, gen, name,
                                                                         args)
        mnk = cs.gemm_dims(name, args)
        pick = _act_plan(mnk)
        with torch.no_grad():
            out, ref = kern(), plain()
            scale = max(1.0, ref.float().abs().max().item())
            err = (out.float() - ref.float()).abs().max().item() / scale
            digest = _digest(out)
            dev_ms = cs.timed_graph(torch, kern)[0]
            lib_ms = cs.timed_graph(torch, library)[0]
            boxes_ms = None  # a halo signature with the halo off: per-tap boxes
            if new and kb.bf16act_layout(name, args, pick)["mode"] == "halo":
                try:
                    kb.BF16ACT_HALO = False
                    boxes_ms = cs.timed_graph(torch, kern)[0]
                finally:
                    kb.BF16ACT_HALO = True
            times = {}
            if all_plans:
                try:
                    for plan in kb.plan_candidates(mnk[1], mnk[2], tiles, kb.TC_BK_BF16):
                        kb.tile_plan = forced(plan)
                        times[plan] = cs.timed_graph(torch, kern)[0]
                finally:
                    kb.tile_plan = planner
        b_ms, b_by = cs.bound(flops, nbytes, cs.BF16_PEAK)
        level = "x".join(map(str, _level(name, args)))
        path = kb.bf16act_path(name, args, pick) if new else None
        rows.append((mnk, times))
        key = f"{name}@{level}"
        t = total.setdefault(key, {"launches": 0, "device_ms": 0.0, "bound_ms": 0.0,
                                   "library_ms": 0.0})
        t["launches"] += count
        t["device_ms"] += count * dev_ms
        t["bound_ms"] += count * b_ms
        t["library_ms"] += count * lib_ms
        print(json.dumps({"kernel": name, "args": list(args), "level": level,
                          "per_forward": count, "mnk": list(mnk), "picked": pick._asdict(),
                          "path": path, "device_ms": dev_ms, "boxes_device_ms": boxes_ms,
                          "digest": digest,
                          "rel_err": err, "library_ms": lib_ms, "bound_ms": b_ms,
                          "bound_by": b_by,
                          "plans_ms": {f"{p.bm}x{p.bn}s{p.splits}": t
                                       for p, t in times.items()} or None}), flush=True)
        del out, ref
    sums = {k: sum(v[k] for v in total.values()) for k in ("device_ms", "bound_ms", "library_ms")}
    line = {"total": total, "per_forward": sums, "root": str(root),
            "timing": "device, CUDA graph of 20 calls", "device": torch.cuda.get_device_name(0),
            "nvidia_smi": _smi()}
    if all_plans and new:
        fit, fit_split_us, call_us = act_fit(rows)
        line["fit"] = {"TC_TILES_BF16ACT": {f"{bm}x{bn}": [round(s_, 3), round(c_, 3)]
                                            for (bm, bn), (s_, c_, _) in fit.items()},
                       "SPLIT_US_PER_MFLOAT_BF16ACT": round(fit_split_us, 3),
                       "us_per_call": round(call_us, 2)}
        picked = fastest = fit_picked = 0.0
        for count, (mnk, times) in zip(act_signatures().values(), rows):
            picked += count * times[_act_plan(mnk)]
            fastest += count * min(times.values())
            fit_picked += count * times[kb.pick_act_plan(*mnk, fit, fit_split_us)]
        line["per_forward_plans"] = {"picked_ms": picked, "fit_picked_ms": fit_picked,
                                     "fastest_ms": fastest}
    print(json.dumps(line), flush=True)


# --bf16act --clocks: the stamps of one CTA, from a build of the checkout's
# igemm_bf16act.cu alone with its clock macro; (kernel, signature, plan)
ACT_CLOCK_CASES = (("conv2d_nhwc", (50, 16, 128, 64, 0, 64, 3, False), (128, 64, 1)),
                   ("conv2d_nhwc", (50, 16, 128, 64, 64, 64, 3, False), (128, 64, 1)),
                   ("conv2d_nhwc", (50, 8, 64, 128, 0, 128, 3, False), (128, 128, 1)),
                   ("conv2d_nhwc", (50, 8, 64, 128, 0, 64, 3, True), (128, 64, 1)),
                   ("conv2d_nhwc", (50, 2, 16, 512, 0, 512, 3, False), (128, 256, 5)))


def _clocks_library(root):
    """A library of the checkout's igemm_bf16act.cu alone, built with its
    clock macro, and a reader of the stamps; (lib, new kernel?)."""
    csrc = Path(root) / "diffphycon_tpu_torch" / "csrc"
    new = (csrc / "igemm_bf16act.cuh").exists()
    macro, sym = (("IGEMM_BF16ACT_CLOCKS", "igemm_bf16act::clk") if new
                  else ("IGEMM_BF16_CLOCKS", "igemm_bf16::clk"))
    out = Path(root) / "build" / "sweep_igemm_tc_clocks"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "clocks.cu"
    src.write_text(f'#include "{csrc / "igemm_bf16act.cu"}"\n'
                   'extern "C" int act_clocks_read(long long* host) {\n'
                   f'  return (int)cudaMemcpyFromSymbol(host, {sym}, sizeof({sym}));\n}}\n')
    lib = out / f"libclocks_{'new' if new else 'old'}.so"
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, f"-D{macro}", "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-o", str(lib), str(src)], check=True)
    handle = ctypes.CDLL(str(lib))
    for fn in ("conv2d_nhwc_bf16act", "downsample_nhwc_bf16act"):
        getattr(handle, fn).argtypes = _build.SIGNATURES[fn]
        getattr(handle, fn).restype = ctypes.c_int
    handle.act_clocks_read.argtypes = [ctypes.c_void_p]
    return handle, new


def act_clocks(root) -> None:
    lib, new = _clocks_library(root)
    loader, planner = _build.load_library, kb.tile_plan
    words = 2 * 512 * 4 if new else 2 * 256 * 8
    try:
        _build.load_library = lambda lib=lib: lib
        for i, (name, args, (bm, bn, sp)) in enumerate(ACT_CLOCK_CASES):
            mnk = cs.gemm_dims(name, args)
            stages = math.ceil(mnk[2] / kb.TC_BK_BF16)
            plan = kb.TilePlan(bm, bn, math.ceil(stages / math.ceil(stages / sp)),
                               math.ceil(stages / sp))
            gen = torch.Generator(device="cuda").manual_seed(2200 + i)
            kern = cs.kernel_case_bf16act(torch, F, kb, gen, name, args)[0]
            kb.tile_plan = forced(plan)
            with torch.no_grad():
                kern()
                torch.cuda.synchronize()
                dev_ms = cs.timed_graph(torch, kern)[0]
                kern()
                torch.cuda.synchronize()
            buf = (ctypes.c_longlong * words)()
            if lib.act_clocks_read(ctypes.addressof(buf)) != 0:
                raise RuntimeError("act_clocks_read failed")
            rec = {"kernel": name, "args": list(args), "tile_plan": plan._asdict(),
                   "device_ms": dev_ms, "device": torch.cuda.get_device_name(0)}
            if new:
                rec.update(_new_clocks(buf))
            else:
                rec["clocks_per_stage"] = _old_clocks(buf, plan)
            print(json.dumps(rec), flush=True)
    finally:
        _build.load_library, kb.tile_plan = loader, planner


def _old_clocks(buf, plan):
    """The old core's mean clocks per stage and phase (igemm_bf16.cuh:
    IGEMM_BF16_CLK, as stage_clocks reads them)."""
    stages = min(plan.per + plan.per % 2, 256)
    wgs = {}
    for wg in range(plan.bm // 64):
        st = [[buf[(wg * 256 + i) * 8 + p] for p in range(7)] for i in range(stages)]
        rows = range(1, stages - 2)
        d = {ph: 0 for ph in PHASES}
        for i in rows:
            r, nxt = st[i], st[i + 1]
            for j, ph in enumerate(PHASES[:-1]):
                d[ph] += r[j + 1] - r[j]
            d["to_next"] += nxt[0] - r[6]
        wgs[f"wg{wg}"] = {ph: round(v / len(rows)) for ph, v in d.items()}
        wgs[f"wg{wg}"]["per_stage"] = round((st[stages - 2][0] - st[1][0]) / (stages - 3))
    return wgs


def _new_clocks(buf):
    """The persistent tile's stamps of CTA 0 (igemm_bf16act.cuh: ACT_CLK):
    role 0 the first consumer warpgroup, a record a stage with both
    warpgroups on a tile (after its waits, the products issued, the previous
    stage's retired, the slot released), a record a tile in turns (its turn
    come, the products issued, retired, the epilogue done); record 511 the
    end of the walk; role 1 the producer, a record a ring load (before the
    empty-barrier wait, after it, the copies issued). Mean clocks per phase
    (``wait``: from a record's last stamp to the next record's first) and
    the clocks from the first record to the last."""
    def rec(role, i):
        return [buf[(role * 512 + i) * 4 + p] for p in range(4)]

    cons = [rec(0, i) for i in range(511) if rec(0, i)[0]]
    prod = [rec(1, i) for i in range(511) if rec(1, i)[0]]
    out = {"consumer_records": len(cons), "producer_records": len(prod)}
    if len(cons) > 1:
        d = {"wait": 0, "issue": 0, "retire": 0, "release": 0}
        for r, nxt in zip(cons, cons[1:]):
            d["issue"] += r[1] - r[0]
            d["retire"] += r[2] - r[1]
            d["release"] += r[3] - r[2]
            d["wait"] += nxt[0] - r[3]
        out["consumer_mean_clocks"] = {k: round(v / (len(cons) - 1)) for k, v in d.items()}
        out["consumer_span"] = cons[-1][3] - cons[0][0]
    if len(prod) > 1:
        out["producer_mean_clocks"] = {
            "empty_wait": round(sum(r[1] - r[0] for r in prod) / len(prod)),
            "issue": round(sum(r[2] - r[1] for r in prod) / len(prod))}
    end = rec(0, 511)
    if end[0] and cons:
        out["walk_clocks"] = end[0] - cons[0][0]
    return out


def main() -> int:
    global torch, F, cs, _build, kb
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bf16", action="store_true", help="the bf16 core and its plan")
    ap.add_argument("--bf16act", action="store_true",
                    help="K1c and K2c on bf16 activations (csrc/igemm_bf16act.cu)")
    ap.add_argument("--plans", action="store_true",
                    help="with --bf16act: every candidate plan too, and the plan fit")
    ap.add_argument("--clocks", action="store_true",
                    help="with --bf16 or --bf16act: SM clocks of the stages from a clocks build")
    ap.add_argument("--root", default=str(HERE),
                    help="with --bf16act: the checkout whose diffphycon_tpu_torch is timed")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)  # the kernels build under that checkout
    import torch as _torch
    import torch.nn.functional as _F

    torch, F = _torch, _F
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    import chip_smoke as _cs
    from diffphycon_tpu_torch.kernels import _build as _b
    from diffphycon_tpu_torch.kernels import unet2d_blocks as _kb

    cs, _build, kb = _cs, _b, _kb
    if not Path(kb.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {kb.__file__}, not the port under {root}")
    if args.clocks and not (args.bf16 or args.bf16act):
        raise SystemExit("--clocks needs --bf16 or --bf16act")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.bf16act:
        if args.clocks:
            act_clocks(root)
        else:
            _build.load_library()
            sweep_act(root, args.plans)
    elif args.clocks:
        stage_clocks()
    else:
        sweep(args.bf16)
    return 0


if __name__ == "__main__":
    sys.exit(main())
