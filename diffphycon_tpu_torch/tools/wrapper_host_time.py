#!/usr/bin/env python
"""Host time per call of the K1 and K2 wrappers (``conv2d_nhwc``,
``downsample_nhwc``) at the K1/K2 signatures of one Burgers UNet2D forward at
batch 50, on one NVIDIA GPU.

For each signature, of the wrapper and of cuDNN's ``F.conv2d`` on the same
inputs (NCHW, TF32 off): ``host_us``, the host's time per call (40 calls
enqueued with no synchronisation, on the host's clock, the median of 15 such
batches); ``event_ms``, one call per CUDA-event pair as ``chip_smoke.py``
phase 3 times it (the host's time up to the launch, then the device's);
``stream_ms``, 40 calls back to back between two events, per call (the
device's time once the host keeps ahead). A call slower than SLOW_MS per
event pair (cuDNN's slow algorithm picks) is timed per event pair only. Then
a line with the host time of two stream lookups
(``torch.cuda.current_stream().cuda_stream`` and the raw handle), the
per-forward sums, and ``forward_order_host_us``: the host's time for one
forward's K1/K2 wrapper calls made in the forward's order, each call with
inputs and a weight of its own as in the net (4 such forwards enqueued with
no synchronisation, the median of 15 batches). Repeating one signature
reuses whatever the wrapper caches per call (the bf16 core's tensor maps);
the forward's order shows what is left of that over a forward.

``--bf16`` times the bf16 variants (bf16 weights, beside cuDNN's bf16 conv
on operands cast outside the timing). ``--root DIR`` imports
``diffphycon_tpu_torch`` from another checkout (an earlier version of the
port), so one run on the card can time both; the inputs and the timing come
from this checkout's ``chip_smoke.py``. Run:
``python3 diffphycon_tpu_torch/tools/wrapper_host_time.py [--root DIR] [--bf16]``.
"""

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this file
SLOW_MS = 2.0  # a call slower than this per event pair gets no host_us or stream_ms


def host_us(torch, fn, calls=40, batches=15):
    """Median host microseconds per call of fn, over batches of calls that
    are enqueued with no synchronisation."""
    fn()
    ts = []
    for _ in range(batches):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        for _ in range(calls):
            fn()
        ts.append(1e6 * (time.perf_counter() - tic) / calls)
    torch.cuda.synchronize()
    return sorted(ts)[batches // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose diffphycon_tpu_torch is timed")
    ap.add_argument("--bf16", action="store_true", help="the bf16 variants (bf16 weights)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from diffphycon_tpu_torch.kernels import unet2d_blocks as kb

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    calls = [(name, sig) for name, sig, _ in cs.main_path_calls(cs.DIM, cs.MULTS, cs.B)
             if name in cs.TC_KERNELS]
    per_fwd = {}
    for call in calls:
        per_fwd[call] = per_fwd.get(call, 0) + 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    total = {}
    with torch.no_grad():
        for (name, sig), count in per_fwd.items():
            kern, _, library, _, _, _ = cs.kernel_case(torch, F, kb, gen, name, sig,
                                                       bf16=args.bf16)
            row = {"kernel": name, "args": list(sig), "per_forward": count}
            for key, fn in (("", kern), ("library_", library)):
                row[key + "event_ms"] = cs.timed(torch, fn)
                if row[key + "event_ms"] > SLOW_MS:  # cuDNN's slow picks: too long to repeat
                    row[key + "host_us"] = row[key + "stream_ms"] = None
                    continue
                row[key + "host_us"] = host_us(torch, fn)
                row[key + "stream_ms"] = cs.timed_stream(torch, fn, n=40)
            for key, v in row.items():
                if key.endswith(("_us", "_ms")) and v is not None:
                    total[key] = total.get(key, 0.0) + count * v
            print(json.dumps(row), flush=True)
        fwd = [cs.kernel_case(torch, F, kb, gen, name, sig, bf16=args.bf16)[0]
               for name, sig in calls]

        def forward():
            for fn in fwd:
                fn()

        forward_us = host_us(torch, forward, calls=4)
    x = torch.empty(4, device="cuda")
    print(json.dumps({
        "root": args.root, "bf16": args.bf16, "device": torch.cuda.get_device_name(0),
        "current_stream_us": host_us(torch, lambda: torch.cuda.current_stream(x.device).cuda_stream),
        "raw_stream_us": host_us(torch, lambda: torch._C._cuda_getCurrentRawStream(x.get_device())),
        "per_forward": total, "forward_order_calls": len(calls),
        "forward_order_host_us": forward_us}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
