#!/usr/bin/env python
"""Where K5's time goes inside a CTA, on one NVIDIA GPU: clock64() stamps at
the phase boundaries of K5a and K5b (``csrc/linear_attention_tc.cu``).

``nsys`` and ``ncu`` do not run on the machines the port is measured on, so
the kernel carries ``LA_STAMP`` marks (thread 0 of each CTA writes clock64()
to a device array after each phase) that compile to nothing unless
``LA_PHASE_CLOCKS`` is defined. This tool builds the kernels with that
define (``_build.build``, a directory of its own beside the plain build)
and calls K5 through ctypes at the K5 sites of the Burgers UNet2D at batch
50 (K5a alone, then the merge with K5b, as
``attention.linear_attention_stages`` splits them). Prints one JSON line per
site and stage: the stage's time back to back (``chip_smoke.timed_stream``)
and the mean SM clocks per phase and CTA (K5a: per 64-token tile, averaged
over the chunk's tiles: x copy wait, ChanLN, the first projection pass (k;
or k|v of two heads), token softmax, the v pass (none with two heads per
CTA), context; K5b: the copies, ChanLN, q projection, head softmax, context
applied, out-projection, out-ChanLN and store). Two CTAs share an SM where
shared memory allows, so a phase's clocks include the other CTA's
interleaved work.

``--bf16`` times the bf16 variant (``linear_attention_tc_bf16``, bf16
``wqkv`` and ``wo``) with its own phase names. ``--bf16act`` times the
bf16-activation variant (``linear_attention_bf16act``, flax
``dtype=bfloat16``; ``csrc/attention_bf16act.cu`` built alone with the
define, its stamps in ``bfa_stamps``), each of its three launches alone
(the stages mask of its dims) on bf16 inputs: K5a per 64-token tile (the
wait for the x tile, ChanLN, the k | v projection, the stores and maxima),
K5b per cluster rank (the barrier set-up and the run's TMA issue, the
loads of the tile maxima, their reduction, the wait for the run, the exps
and the rank's sums, the sums over distributed shared memory, the
probabilities, the context product, the partials over distributed shared
memory), K5c per 64-token tile (the wait for the x tile and the context
tiles, ChanLN, the next tile's copies issued, the q projection, the head
softmax, the context applied, the out-projection, the out-ChanLN's
statistics, y and its stores); the tile phases averaged over each CTA's
first five tiles.

Run from the repository root:
``python3 -m diffphycon_tpu_torch.tools.k5_phase_clocks [--bf16 | --bf16act]``.
"""

import argparse
import ctypes
import json
import sys

import numpy as np
import torch

import chip_smoke as cs
from diffphycon_tpu_torch.kernels import _build
from diffphycon_tpu_torch.kernels import attention as ka

SLOTS = 48  # stamps per CTA (linear_attention_tc.cu: kStampSlots)
K5A_PHASES = ("x_copy", "chan_ln", "first_pass", "softmax", "v_pass", "context")
K5B_PHASES = ("copies", "chan_ln", "q_proj", "softmax", "context", "out_proj", "out_ln")
# the bf16 bodies (csrc/attention_bf16.cuh): K5a per tile the x tile's
# ChanLN into bf16, the k | v products (with the first tile's wait for the
# resident weights), k and v stored, the token softmax, the context; K5b per
# 64 flattened tokens the ChanLN (the first context's loads in flight), the
# q products, the head softmax, the context's tf32 tiles, the context
# applied, the out-projection, the out-ChanLN and the stores
K5A_PHASES_BF16 = ("ln_to_bf16", "kv_proj", "kv_store", "softmax", "context")
K5B_PHASES_BF16 = ("ln_to_bf16", "q_proj", "softmax", "ctx_tiles", "ctx_apply", "out_proj",
                   "out_ln")


BFA_SLOTS = 64  # stamps per CTA (attention_bf16act.cu: kStampSlots), 10 a tile
K5A_PHASES_BF16ACT = ("x_wait", "chan_ln", "kv_proj", "store_max")
K5B_PHASES_BF16ACT = ("prologue", "kmax_loads", "max_reduce", "run_wait", "exps",
                      "dsmem_sums", "probs", "context", "dsmem_partials")
K5C_PHASES_BF16ACT = ("x_wait_ctx_tiles", "chan_ln", "prefetch", "q_proj", "softmax",
                      "ctx_apply", "out_proj", "out_ln_stats", "y_store")


def tile_clocks(buf: np.ndarray, width: int, tiles: int = 5) -> list:
    """Mean clocks per phase over the tile stamps (slots 10 t .. 10 t + width
    - 1, t < tiles) that a CTA wrote (stamps cleared before the launch)."""
    rows = [np.diff(buf[c, 10 * t:10 * t + width]) for c in range(buf.shape[0])
            for t in range(tiles) if buf[c, 10 * t] and buf[c, 10 * t + width - 1]]
    return np.round(np.mean(rows, axis=0)).tolist()


def bf16act_main() -> int:
    """--bf16act: see the module docstring."""
    name = "linear_attention_bf16act"
    dll = ctypes.CDLL(str(_build.build(("LA_PHASE_CLOCKS",), only=("attention_bf16act.cu",))))
    getattr(dll, name).argtypes = _build.SIGNATURES[name]
    dll.bfa_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    gen = torch.Generator(device="cuda").manual_seed(0)
    sites = sorted({args for kind, args, _ in cs.main_path_calls(cs.DIM, cs.MULTS, cs.B)
                    if kind == "linear_attention_block"})
    max_ctas = 4000000 // BFA_SLOTS
    bf = torch.bfloat16
    for b, h, w, c in sites:
        n = h * w
        x = (2 * torch.randn(b, h, w, c, generator=gen, device="cuda") + 0.3).to(bf)
        p = [1 + 0.1 * torch.randn(c, generator=gen, device="cuda"),
             (torch.randn(c, 384, generator=gen, device="cuda") / c ** 0.5).to(bf),
             (torch.randn(128, c, generator=gen, device="cuda") / 128 ** 0.5).to(bf),
             0.1 * torch.randn(c, generator=gen, device="cuda"),
             1 + 0.1 * torch.randn(c, generator=gen, device="cuda")]
        ints, _, scratch = ka._bf16act_shapes(name, x.shape, True)
        part, out = x.new_empty(scratch), torch.empty_like(x)

        def call(stages):
            dims = (ctypes.c_int * 7)(*ints, stages)
            err = getattr(dll, name)(
                x.data_ptr(), *(t.data_ptr() for t in p), part.data_ptr(), out.data_ptr(),
                dims, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"k5_phase_clocks: cudaError {err}")

        call(7)
        for stage, label, phases in ((1, "K5a", K5A_PHASES_BF16ACT),
                                     (2, "K5b", K5B_PHASES_BF16ACT),
                                     (4, "K5c", K5C_PHASES_BF16ACT)):
            ms = cs.timed_stream(torch, lambda: call(stage))
            torch.cuda.synchronize()
            if dll.bfa_stamps_clear():
                raise RuntimeError("k5_phase_clocks: clearing the stamps failed")
            call(stage)
            torch.cuda.synchronize()
            buf = np.zeros(max_ctas * BFA_SLOTS, np.int64)
            dll.bfa_stamps_read(buf.ctypes.data, buf.size)
            buf = buf.reshape(max_ctas, BFA_SLOTS)
            ctas = int(np.count_nonzero(buf.any(axis=1)))
            buf = buf[:ctas].astype(np.float64)
            width = len(phases) + 1
            clk = tile_clocks(buf, width, 1 if stage == 2 else 5)
            print(json.dumps({"site": [b, h, w, c], "bf16act": True, "stage": label,
                              "plan": list(ints[3:]), "ctas": ctas, "ms": ms,
                              "clocks_per_phase": dict(zip(phases, clk))}), flush=True)
    return 0


def build() -> ctypes.CDLL:
    dll = ctypes.CDLL(str(_build.build(("LA_PHASE_CLOCKS",))))
    for name in ("linear_attention_tc_f32", "linear_attention_tc_bf16"):
        getattr(dll, name).argtypes = _build.SIGNATURES[name]
    dll.la_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return dll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bf16", action="store_true", help="time the bf16 variant")
    ap.add_argument("--bf16act", action="store_true",
                    help="time the bf16-activation variant (flax dtype=bfloat16)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.bf16act:
        return bf16act_main()
    dll = build()
    entry = dll.linear_attention_tc_bf16 if args.bf16 else dll.linear_attention_tc_f32
    wdt = torch.bfloat16 if args.bf16 else torch.float32
    gen = torch.Generator(device="cuda").manual_seed(0)
    sites = sorted({args for kind, args, _ in cs.main_path_calls(cs.DIM, cs.MULTS, cs.B)
                    if kind == "linear_attention_block"})
    for b, h, w, c in sites:
        n = h * w
        x = torch.randn(b, h, w, c, generator=gen, device="cuda")
        p = [1 + 0.1 * torch.randn(c, generator=gen, device="cuda"),
             (torch.randn(c, 384, generator=gen, device="cuda") / c ** 0.5).to(wdt),
             (torch.randn(128, c, generator=gen, device="cuda") / 128 ** 0.5).to(wdt),
             0.1 * torch.randn(c, generator=gen, device="cuda"),
             1 + 0.1 * torch.randn(c, generator=gen, device="cuda")]
        ints, _, part_floats = ka._linear_shapes(x.shape, args.bf16)
        chunk, n_chunks, groups = ints[4], ints[3], ints[5]
        part, out = x.new_empty(part_floats), torch.empty_like(x)

        tr, k5b_ctas = ka.la_output_plan(b, n, c) if args.bf16 else (64, b * -(-n // 64))
        k5b_tiles = -(-b * n // tr)

        def call(stages):
            dims = (ctypes.c_int * 9)(b, n, c, n_chunks, chunk, groups, stages, k5b_ctas, tr)
            err = entry(
                x.data_ptr(), *(t.data_ptr() for t in p), part.data_ptr(), out.data_ptr(),
                dims, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"k5_phase_clocks: cudaError {err}")

        call(1)
        k5a_phases, k5b_phases = ((K5A_PHASES_BF16, K5B_PHASES_BF16) if args.bf16
                                  else (K5A_PHASES, K5B_PHASES))
        for stages, name, ctas, phases in ((1, "K5a", b * n_chunks * groups, k5a_phases),
                                           (2, "merge+K5b", k5b_ctas, k5b_phases)):
            ms = cs.timed_stream(torch, lambda: call(stages))
            call(stages)
            torch.cuda.synchronize()
            buf = np.zeros(ctas * SLOTS, np.int64)
            dll.la_stamps_read(buf.ctypes.data, buf.size)
            buf = buf.reshape(ctas, SLOTS).astype(np.float64)
            width = len(phases) + 1
            if stages == 1:
                tiles = -(-min(chunk, n) // 64)
                clk = np.mean([np.diff(buf[:, 8 * t:8 * t + width], axis=1).mean(0)
                               for t in range(tiles)], axis=0)
                extra = {"tiles_per_cta": tiles, "chunk": chunk, "S": n_chunks,
                         "head_groups": groups}
            elif args.bf16:  # per 64-token tile, over each CTA's first (up to 6) tiles
                tiles = min(6, k5b_tiles // ctas)
                clk = np.mean([np.diff(buf[:, 8 * t:8 * t + width], axis=1).mean(0)
                               for t in range(tiles)], axis=0)
                extra = {"tiles_per_cta": k5b_tiles / ctas}
            else:
                clk = np.diff(buf[:, :width], axis=1).mean(0)
                extra = {}
            print(json.dumps({"site": [b, h, w, c], "bf16": args.bf16, "stage": name,
                              "ctas": ctas, "ms": ms,
                              "clocks_per_phase": dict(zip(phases, np.round(clk).tolist())),
                              **extra}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
