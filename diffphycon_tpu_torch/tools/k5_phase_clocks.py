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
``wqkv`` and ``wo``) with its own phase names.

Run from the repository root:
``python3 -m diffphycon_tpu_torch.tools.k5_phase_clocks [--bf16]``.
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


def build() -> ctypes.CDLL:
    dll = ctypes.CDLL(str(_build.build(("LA_PHASE_CLOCKS",))))
    for name in ("linear_attention_tc_f32", "linear_attention_tc_bf16"):
        getattr(dll, name).argtypes = _build.SIGNATURES[name]
    dll.la_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return dll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bf16", action="store_true", help="time the bf16 variant")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
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
