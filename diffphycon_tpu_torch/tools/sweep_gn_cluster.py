#!/usr/bin/env python
"""Time K3 (``csrc/group_norm_act.cu``) at the K3 signatures of one Burgers
UNet2D forward at batch 50, on one NVIDIA GPU, under every cluster size.

For each signature (B, H, W, C, FiLM): the device time alone of one call
(``chip_smoke.timed_graph``: 20 calls in a CUDA graph, its replay timed by
two events) with the cluster forced to 1, 2, 4 and 8 CTAs (``by_plan``
keys ``c1`` ... ``c8``), and the max |err| against the plain version under
each; then, under the plan ``unet2d_blocks._gn_plan`` picks (its cluster
size, ``gn_cluster_plan`` or ``gn_bf16_plan``), one call per event pair
(``chip_smoke.timed``, host and device) and the host's enqueue time per call
(the median of 15 batches of 40 calls enqueued back to back, on the host's
clock). Prints one JSON line per
signature and a ``total`` line: device ms per forward under each forced
cluster size and under the plan.

``--bf16act`` times the bf16-activation variant (``group_norm_act_bf16act``,
flax ``dtype=bfloat16``) the same way at
``chip_smoke.kernel_case_bf16act``'s inputs (a CUDA generator seeded per
signature), and prints the output's digest (the first 16 hex digits of the
SHA-256 of its bytes) under the plan, so that two checkouts' lines show
whether their outputs are bit-equal. A plan is forced by replacing
``unet2d_blocks._gn_plan``'s cluster size, so any checkout whose
``_gn_plan`` returns (B, H*W, C, cluster size) can be timed.
``--bf16act --clocks`` times nothing on the graph: it builds
``group_norm_act.cu`` alone with ``-DGN_PHASE_CLOCKS`` (``_build.build``, a
directory of its own beside the plain build), in which thread 0 of each CTA
stamps clock64() at the phase boundaries (``GN_STAMP``), calls the kernel
through ctypes at the (50, 16, 128, 64) and (50, 2, 16, 512) sites with
FiLM and with the residual under the plan, and prints per site the mean SM
clocks per phase and CTA (``GN_PHASES``) and the mean and largest clocks
from a CTA's first stamp to its last; then the ops a clock an SM of the
update's ingredients (fp32 FMA, the one-value and the packed fp32 -> bf16
conversion, MUFU ex2, bf16x2 FMA) from ``tools/op_rate.cu``, built alone.

``--root DIR`` imports ``diffphycon_tpu_torch`` and ``chip_smoke`` from
another checkout (e.g. the parent commit unpacked with ``git archive`` into
a git-ignored directory) and builds its kernels there; the timing code is
this file's. Compare two checkouts in turns, each run a process of its own.

Run from the repository root:
``python3 -m diffphycon_tpu_torch.tools.sweep_gn_cluster [--bf16act [--clocks]] [--root DIR]``.
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this file
CLUSTERS = (1, 2, 4, 8)
# group_norm_act.cu's GN_STAMP slots: the phase that ends at each stamp
GN_PHASES = ("slice_wait", "statistics", "cluster_barrier", "partials_read", "arrive", "merge",
             "coefficients", "update", "tail_barrier")
STAMP_SLOTS = 16  # group_norm_act.cu: kStampSlots
CLOCK_SITES = ((50, 16, 128, 64), (50, 2, 16, 512))


def host_us(torch, fn, calls=40, batches=15):
    """Median host microseconds per call of fn, over batches of calls that
    are enqueued with no synchronisation."""
    ts = []
    for _ in range(batches):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        for _ in range(calls):
            fn()
        ts.append(1e6 * (time.perf_counter() - tic) / calls)
    torch.cuda.synchronize()
    return sorted(ts)[batches // 2]


def digest(t) -> str:
    return hashlib.sha256(t.float().cpu().numpy().tobytes()).hexdigest()[:16]


def signatures(cs):
    counts = {}
    for kind, args, _ in cs.main_path_calls(cs.DIM, cs.MULTS, cs.B):
        if kind == "group_norm_act":
            counts[args] = counts.get(args, 0) + 1
    return sorted(counts.items())


def forced(kb, planner, cluster):
    """Make every K3 call take `cluster` CTAs a cluster: ``kb._gn_plan``
    becomes `planner` with its cluster size replaced (the caller restores
    `planner`)."""
    kb._gn_plan = lambda x_shape, groups, bf16=False: (*planner(x_shape, groups, bf16)[:3],
                                                       cluster)


def sweep(torch, cs, kb, bf16act: bool) -> int:
    import torch.nn.functional as F

    planner = kb._gn_plan
    totals = {f"c{cluster}": 0.0 for cluster in CLUSTERS}
    totals["plan"] = totals["plan_event_pair"] = 0.0
    with torch.no_grad():
        for i, ((b, h, w, c, film), count) in enumerate(signatures(cs)):
            gen = torch.Generator(device="cuda").manual_seed(i)
            if bf16act:
                fn, plain = cs.kernel_case_bf16act(torch, F, kb, gen, "group_norm_act",
                                                   (b, h, w, c, film))[:2]
            else:
                x = torch.randn(b, h, w, c, generator=gen, device="cuda")
                gamma = torch.randn(c, generator=gen, device="cuda")
                beta = torch.randn(c, generator=gen, device="cuda")
                ss = torch.randn(b, 2 * c, generator=gen, device="cuda") if film else None
                res = None if film else torch.randn(b, h, w, c, generator=gen, device="cuda")

                def fn(x=x, gamma=gamma, beta=beta, ss=ss, res=res):
                    return kb.group_norm_act(x, gamma, beta, 1, ss=ss, res=res)

                def plain(x=x, gamma=gamma, beta=beta, ss=ss, res=res):
                    return kb.group_norm_act_plain(x, gamma, beta, 1, ss=ss, res=res)

            ref = plain().float()
            by_plan = {}
            try:
                for cluster in CLUSTERS:
                    key = f"c{cluster}"
                    forced(kb, planner, cluster)
                    try:
                        err = (fn().float() - ref).abs().max().item()
                    except (RuntimeError, ValueError) as e:
                        by_plan[key] = {"error": str(e)[:120]}
                        totals[key] = float("nan")
                        continue
                    dev_ms, why = cs.timed_graph(torch, fn)
                    by_plan[key] = {"device_us": None if dev_ms is None else 1e3 * dev_ms,
                                    "max_abs_err": err, **({"error": why} if why else {})}
                    totals[key] += count * (dev_ms or float("nan"))
            finally:
                kb._gn_plan = planner
            out = fn()
            torch.cuda.synchronize()
            dev_ms, _ = cs.timed_graph(torch, fn)
            pair_ms = cs.timed(torch, fn, n=50)
            totals["plan"] += count * (dev_ms or float("nan"))
            totals["plan_event_pair"] += count * pair_ms
            print(json.dumps({"signature": [b, h, w, c, film], "per_forward": count,
                              "cluster": planner((b, h, w, c), 1, bf16act)[3],
                              "by_plan": by_plan,
                              "device_us": None if dev_ms is None else 1e3 * dev_ms,
                              "event_pair_us": 1e3 * pair_ms,
                              "max_abs_err": (out.float() - ref).abs().max().item(),
                              "digest": digest(out), "host_enqueue_us": host_us(torch, fn)}),
                  flush=True)
    print(json.dumps({"total": "device ms per forward at batch 50", "bf16act": bf16act,
                      **{str(k): v for k, v in totals.items()}}), flush=True)
    return 0


def clocks(torch, cs, kb) -> int:
    """--bf16act --clocks: see the module docstring."""
    import numpy as np

    from diffphycon_tpu_torch.kernels import _build

    name = "group_norm_act_bf16act"
    dll = ctypes.CDLL(str(_build.build(("GN_PHASE_CLOCKS",), only=("group_norm_act.cu",))))
    getattr(dll, name).argtypes = _build.SIGNATURES[name]
    dll.gn_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    slots = len(GN_PHASES) + 1
    for i, (site, film) in enumerate([(s, f) for s in CLOCK_SITES for f in (True, False)]):
        gen = torch.Generator(device="cuda").manual_seed(i)
        x, gamma, beta, ss, res = _k3_inputs(torch, gen, site, film)
        out = torch.empty_like(x)
        b_, hw, c, cluster = kb._gn_plan(tuple(x.shape), 1, True)
        ints = (b_, hw, c, 1, 0 if ss is None else ss.stride(0), cluster)
        dims = (ctypes.c_int * len(ints))(*ints)

        def call():
            err = getattr(dll, name)(
                x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                ss.data_ptr() if ss is not None else None,
                res.data_ptr() if res is not None else None, out.data_ptr(), dims,
                kb.GN_EPS, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"sweep_gn_cluster: cudaError {err}")

        ms = cs.timed_stream(torch, call)
        torch.cuda.synchronize()
        if dll.gn_stamps_clear():
            raise RuntimeError("sweep_gn_cluster: clearing the stamps failed")
        call()
        torch.cuda.synchronize()
        n = 1 << 20  # group_norm_act.cu: gn_stamps
        buf = np.zeros(n, np.int64)
        dll.gn_stamps_read(buf.ctypes.data, n)
        buf = buf.reshape(-1, STAMP_SLOTS)[:, :slots]
        buf = buf[buf.all(axis=1)].astype(np.float64)
        steps = np.diff(buf, axis=1)
        span = buf[:, -1] - buf[:, 0]
        print(json.dumps({"site": list(site), "film": film, "dims": list(ints), "ctas": len(buf),
                          "ms_back_to_back": ms,
                          "clocks_per_phase": dict(zip(GN_PHASES,
                                                       np.round(steps.mean(axis=0)).tolist())),
                          "cta_span_mean": float(np.round(span.mean())),
                          "cta_span_max": float(span.max())}), flush=True)
    op_rates(torch)
    return 0


OP_RATE_MODES = ("fp32_fma", "cvt_bf16_f32", "cvt_bf16x2_f32", "mufu_ex2", "bf16x2_fma")


def op_rates(torch):
    """Ops a clock an SM of the update's ingredients (``tools/op_rate.cu``:
    ``gn_op_rate``): one CTA of 1024 threads an SM, 8 independent chains of
    256 ops a thread, mean clocks over the SMs of a second launch."""
    from diffphycon_tpu_torch.kernels import _build

    lib = _build.BUILD_ROOT / "op_rate" / "libop_rate.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
                    "-fPIC", "-shared", str(Path(__file__).with_name("op_rate.cu")), "-o",
                    str(lib)], check=True)
    dll = ctypes.CDLL(str(lib))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clk = torch.zeros(sms, dtype=torch.int64, device="cuda")
    sink = torch.zeros(sms * 1024, device="cuda")
    rates = {}
    for mode, name in enumerate(OP_RATE_MODES):
        for _ in range(2):
            if dll.gn_op_rate(mode, sms, ctypes.c_void_p(clk.data_ptr()),
                              ctypes.c_void_p(sink.data_ptr())):
                raise RuntimeError("sweep_gn_cluster: gn_op_rate failed")
        rates[name] = 1024 * 256 * 8 / clk.double().mean().item()
    print(json.dumps({"ops_per_clock_per_sm": rates}), flush=True)


def _k3_inputs(torch, gen, site, film):
    """kernel_case_bf16act's K3 inputs, drawn in its order."""
    b_, h, w, c = site
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0, shift=0.0, dtype=bf):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale + shift).to(dtype)

    x = rnd(b_, h, w, c, scale=2.0, shift=0.5)
    gamma = rnd(c, scale=0.5, shift=1.0, dtype=torch.float32)
    beta = rnd(c, scale=0.1, dtype=torch.float32)
    ss = rnd(b_, 2 * c, scale=0.5) if film else None
    res = None if film else rnd(b_, h, w, c)
    return x, gamma, beta, ss, res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose diffphycon_tpu_torch is timed")
    ap.add_argument("--bf16act", action="store_true",
                    help="the bf16-activation variant (flax dtype=bf16)")
    ap.add_argument("--clocks", action="store_true",
                    help="with --bf16act: SM clocks per phase from a GN_PHASE_CLOCKS build")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)  # the kernels build under that checkout
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from diffphycon_tpu_torch.kernels import _build
    from diffphycon_tpu_torch.kernels import unet2d_blocks as kb

    if not Path(kb.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {kb.__file__}, not the port under {root}")
    if args.clocks:
        if not args.bf16act:
            raise SystemExit("--clocks needs --bf16act")
        return clocks(torch, cs, kb)
    _build.load_library()
    return sweep(torch, cs, kb, args.bf16act)


if __name__ == "__main__":
    sys.exit(main())
