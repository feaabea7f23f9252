#!/usr/bin/env python
"""Time K4 (``csrc/cg_pressure.cu``) under every cluster size, on one NVIDIA
GPU.

On the divergences of a smoke generator rollout (``chip_smoke.py`` phase 6,
``chip_smoke.rollout_divergence``) at batch 8 and at batch 1, for S = 4, 8
and 16 CTAs per element: the device time of one solve at accuracy 1e-6
(``chip_smoke.timed_stream``: solves back to back between two events) and
its iterations, and the time per iteration alone, from two runs at accuracy
0 (every element runs exactly 100 and 400 iterations: the difference over
300). Then the cost of one bare cluster barrier at S = 1, 2, 4, 8 and 16
(``cg_barrier_probe``: one cluster of 256-thread CTAs crosses 10,000
barriers, timed by the global timer), and the clusters the card holds at
once at each S (``cudaOccupancyMaxActiveClusters``, which the plan
``cg_pressure.cg_cluster_plan`` reads). Prints one JSON line per
measurement.

``--phase-clocks`` builds the kernel with ``CG_PHASE_CLOCKS`` (its own build
directory) and prints, per S at batch 8, the SM clocks per iteration of
each phase (thread 0 of each CTA, averaged over the CTAs): the x/r update,
the first reduction's push, cluster barrier and sums, the p update with its
CTA barrier, the stencil, and the second reduction's three parts.

Run from the repository root:
``python3 -m diffphycon_tpu_torch.tools.sweep_cg_cluster [--phase-clocks]``.
"""

import ctypes
import json
import subprocess
import sys

import torch

import chip_smoke as cs
from diffphycon_tpu_torch.kernels import _build
from diffphycon_tpu_torch.kernels import cg_pressure as kcg

CLUSTERS = (4, 8, 16)
PHASES = ("update", "r1_push", "r1_barrier", "r1_sums", "p_update", "stencil", "r2_push",
          "r2_barrier", "r2_sums")
SLOTS = 16  # stamps per CTA (cg_pressure.cu: kStampSlots)


def per_iteration_us(div, packed, cluster, launch=kcg.cg_launch):
    """Device us per CG iteration at S = cluster: solves of exactly 100 and
    400 iterations (accuracy 0), 5 of each back to back."""
    ms = {m: cs.timed_stream(torch, lambda m=m: launch(div, packed, 0.0, m, cluster), n=5,
                             warm=1) for m in (100, 400)}
    return 1e3 * (ms[400] - ms[100]) / 300


def barrier_us(lib, S, rounds=10000):
    ns = torch.zeros(1, dtype=torch.int64, device="cuda")
    _build.check(lib.cg_barrier_probe(S, rounds, ns.data_ptr(),
                                      torch.cuda.current_stream().cuda_stream),
                 "cg_barrier_probe")
    torch.cuda.synchronize()
    return ns.item() / rounds / 1e3


def phase_clocks(div, packed) -> None:
    dll = ctypes.CDLL(str(_build.build(("CG_PHASE_CLOCKS",))))
    dll.cg_pressure_f32.argtypes = _build.SIGNATURES["cg_pressure_f32"]
    dll.cg_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    B, H, W = div.shape

    def launch(d, pk, acc, maxit, cluster):
        out, iters = torch.empty_like(d), torch.empty(B, dtype=torch.int32, device="cuda")
        _build.check(dll.cg_pressure_f32(d.data_ptr(), pk.data_ptr(), out.data_ptr(),
                                         iters.data_ptr(), B, H, W, acc, maxit, cluster,
                                         torch.cuda.current_stream().cuda_stream),
                     "cg_pressure (phase clocks)")
        return out, iters

    for S in CLUSTERS:
        launch(div, packed, 1e-6, 500, S)
        torch.cuda.synchronize()
        ctas = B * S
        host = (ctypes.c_longlong * (ctas * SLOTS))()
        _build.check(dll.cg_stamps_read(host, ctas * SLOTS), "cg_stamps_read")
        rows = [host[i * SLOTS:(i + 1) * SLOTS] for i in range(ctas)]
        per_it = {name: sum(r[i] / max(1, r[9]) for r in rows) / ctas
                  for i, name in enumerate(PHASES)}
        print(json.dumps({"phase_clocks": "SM clocks per iteration, thread 0, mean over CTAs",
                          "batch": B, "S": S, **per_it,
                          "total": sum(per_it.values()),
                          "us_per_iteration_instrumented": per_iteration_us(
                              div, packed, S, launch)}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            timeout=60).stdout.strip()
    sim, _, div8 = cs.rollout_divergence(torch)
    packed = kcg.pack_coeffs(sim.coeffs)
    lib = _build.load_library()
    for B in (cs.SMOKE_B, 1):
        div = div8[:B].contiguous()
        for S in CLUSTERS:
            _, iters = kcg.cg_launch(div, packed, 1e-6, 500, S)
            ms = cs.timed_stream(torch, lambda: kcg.cg_launch(div, packed, 1e-6, 500, S),
                                 n=10, warm=2)
            print(json.dumps({"batch": B, "S": S, "resident_clusters": kcg._resident(127, 127, S),
                              "solve_ms": ms, "iterations": iters.tolist(),
                              "us_per_iteration": per_iteration_us(div, packed, S),
                              "plan": kcg._plan(B, 127, 127).cluster, "nvidia_smi": smi}),
                  flush=True)
    for S in (1, 2, 4, 8, 16):
        print(json.dumps({"bare_cluster_barrier_us": barrier_us(lib, S), "S": S}), flush=True)
    if "--phase-clocks" in sys.argv[1:]:
        phase_clocks(div8, packed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
