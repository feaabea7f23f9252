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

Run from the repository root:
``python3 -m diffphycon_tpu_torch.tools.k5_phase_clocks``.
"""

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


def build() -> ctypes.CDLL:
    dll = ctypes.CDLL(str(_build.build(("LA_PHASE_CLOCKS",))))
    dll.linear_attention_tc_f32.argtypes = _build.SIGNATURES["linear_attention_tc_f32"]
    dll.la_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return dll


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dll = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    sites = sorted({args for kind, args, _ in cs.main_path_calls(cs.DIM, cs.MULTS, cs.B)
                    if kind == "linear_attention_block"})
    for b, h, w, c in sites:
        n = h * w
        x = torch.randn(b, h, w, c, generator=gen, device="cuda")
        p = [1 + 0.1 * torch.randn(c, generator=gen, device="cuda"),
             torch.randn(c, 384, generator=gen, device="cuda") / c ** 0.5,
             torch.randn(128, c, generator=gen, device="cuda") / 128 ** 0.5,
             0.1 * torch.randn(c, generator=gen, device="cuda"),
             1 + 0.1 * torch.randn(c, generator=gen, device="cuda")]
        ints, _, part_floats = ka._linear_shapes(x.shape)
        chunk, n_chunks, groups = ints[4], ints[3], ints[5]
        part, out = x.new_empty(part_floats), torch.empty_like(x)

        def call(stages):
            dims = (ctypes.c_int * 7)(b, n, c, n_chunks, chunk, groups, stages)
            err = dll.linear_attention_tc_f32(
                x.data_ptr(), *(t.data_ptr() for t in p), part.data_ptr(), out.data_ptr(),
                dims, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"k5_phase_clocks: cudaError {err}")

        call(1)
        for stages, name, ctas, phases in ((1, "K5a", b * n_chunks * groups, K5A_PHASES),
                                           (2, "merge+K5b", b * -(-n // 64), K5B_PHASES)):
            ms = cs.timed_stream(torch, lambda: call(stages))
            call(stages)
            torch.cuda.synchronize()
            buf = np.zeros(ctas * SLOTS, np.int64)
            dll.la_stamps_read(buf.ctypes.data, buf.size)
            buf = buf.reshape(ctas, SLOTS).astype(np.float64)
            if stages == 1:
                tiles = -(-min(chunk, n) // 64)
                clk = np.mean([np.diff(buf[:, 8 * t:8 * t + 7], axis=1).mean(0)
                               for t in range(tiles)], axis=0)
                extra = {"tiles_per_cta": tiles, "chunk": chunk, "S": n_chunks,
                         "head_groups": groups}
            else:
                clk = np.diff(buf[:, :8], axis=1).mean(0)
                extra = {}
            print(json.dumps({"site": [b, h, w, c], "stage": name, "ctas": ctas, "ms": ms,
                              "clocks_per_phase": dict(zip(phases, np.round(clk).tolist())),
                              **extra}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
