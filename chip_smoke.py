#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``diffphycon_tpu_torch`` (never JAX) at full width on three paths:
Burgers sampling (UNet2D dim 64, mults (1, 2, 4, 8), batch 50, input (50,
16, 128, 2)), smoke indirect control (UNet3D dim 64, mults (1, 2, 4), batch
8, input (8, 32, 64, 64, 6); 128^2 fluid solver) and Burgers training (the
same UNet2D at batch 16).

Burgers:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compiles the CUDA kernels from ``diffphycon_tpu_torch/csrc``;
3. kernels: every hand-written kernel at every shape one UNet2D forward
   gives it (K1-K3 convs and norms, K5 at its 8 linear-attention sites, K6
   at the bottleneck), against its plain PyTorch version (max |err| <=
   KERNEL_RTOL * max(1, max |plain|)), with CUDA-event timings of the
   kernel, the plain version and the library call (cuDNN ``F.conv2d`` /
   ``F.group_norm``, TF32 off; none for K5 and K6, beside which
   ``F.scaled_dot_product_attention`` on K6's q, k, v is timed as a
   yardstick of its core), and the bound max(flops / fp32 peak, bytes / HBM
   rate);
4. UNet2D: kernel-backed forward against the plain forward, and the launch
   counts of one forward (K1, K2, K3, K5, K6) against those the
   architecture implies;
5. main path: the port's ``apps/infer_burgers.py`` ``main()`` with two
   seeded models, guidance wu=1000, u0/uT conditioning, 50 synthetic
   targets solved on the card, DDIM 50 steps at eta 0, then
   ``evaluate_samples``; then 20 timed steps of the 1000-step guided DDPM
   loop (guided denoise steps/s at batch 50, with a profiler breakdown) and
   3 DDIM steps from one x_T through the kernel-backed and the plain
   forwards.

Smoke:
6. K4: the CG pressure kernel against its plain version at batch 8 on the
   smoke domain (accuracy 1e-6, 500 iterations at most), on divergences of a
   real generator rollout step: max |err| <= KERNEL_RTOL * max(1, |plain|),
   iteration counts within 2%, the divergence left after projection; CUDA
   event times per solve and the bound for the iterations actually run;
7. main path: the port's ``apps/generate_smoke.py`` ``main()`` (8 test sims,
   one batch of 8, every scene accepted) and ``apps/infer_smoke.py``
   ``main()`` (two seeded UNet3Ds at full width, DDIM SMOKE_DDIM_STEPS steps
   at eta 1, calibration rows on); K4 must launch exactly 256 + 3 * 255
   times; then the UNet3D forward and one guided DDIM step at batch 8, timed,
   and a profiled evaluation rollout (K4's share of it).

Then it prints the ``kernels`` JSON line (K1-K3: per-forward sums of the
phase-3 times; K4: per solve at batch 8), and
``{"ok": true, "device": {...}}`` as the last line.

Any failed check exits non-zero before the last line. Run from the
repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

KERNEL_RTOL = 1e-4   # fp32 sums over up to 6912 terms in another order
# gradients through the kernel-backed forward vs the plain forward: the
# backward is the same plain code on both sides, so the gap is the forwards'
# ~1e-6 relative difference carried through it (~1e-5 at most); 1e-3 leaves
# two orders of margin and still fails on any wrong term. This checks the
# kernels' forwards and that gradients reach every parameter through the
# packed weights; the backward's arithmetic itself is held against jax.grad
# on the CPU (tests/test_torch_port_attention.py)
GRAD_RTOL = 1e-3
UNET_RTOL = 1e-4     # the same, compounded over ~40 blocks (GN renormalises)
# 3 guided DDIM steps from x_T: at t=999 x_start = x/sqrt(a) - sqrt(1/a - 1) eps
# with a = alphas_cumprod[999] ~ 1e-8, so the forwards' ~1e-6 gap in eps
# reaches x_start ~1e4-fold before sqrt(alphas_cumprod[979]) ~ 0.02 scales
# it back down: 1e-6 * 1e4 * 0.02 = 2e-4, times a 10x margin
DDIM_RTOL = 2e-3
CG_ITER_RTOL = 0.02  # iteration counts, kernel vs plain (summation order)
FP32_PEAK = 67e12    # H100 SXM fp32 FLOP/s outside the tensor cores
HBM_RATE = 3.35e12   # H100 SXM HBM3 bytes/s
B = 50
TRAIN_B = 16  # the train app's default batch
DIM, MULTS = 64, (1, 2, 4, 8)
HEADS, DIM_HEAD = 4, 32
SMOKE_B = 8
SMOKE_DDIM_STEPS = 5
# flops per cell per CG iteration in K4: x and r updates (4), <r,Ap> (2),
# |r| max (2), p update (2), stencil (5), <p,Ap> and <p,r> (4)
CG_FLOPS_PER_CELL = 19
REPLACES = {
    "conv2d_nhwc": "diffphycon_tpu/research/pallas_unet2d.py:288 (_conv_kernel); "
                   ":279 (_upsample_kernel); :304 (_concat_kernel); "
                   ":294 (_matmul_bias_kernel, k=1); :160 (_resblock_kernel convs)",
    "downsample_nhwc": "diffphycon_tpu/research/pallas_unet2d.py:259 (_downsample_kernel)",
    "group_norm_act": "diffphycon_tpu/research/pallas_unet2d.py:160 "
                      "(_resblock_kernel GroupNorm/FiLM/SiLU/residual)",
    "cg_pressure": "diffphycon_tpu/physics/fluids/pallas_cg.py:30 (_cg_kernel; "
                   "pallas_solve_pressure :81, pallas_call :121)",
    "linear_attention_block": "diffphycon_tpu/research/pallas_unet2d.py:194 "
                              "(_linear_attention_kernel; wrapper :447)",
    "attention_block": "diffphycon_tpu/research/pallas_unet2d.py:229 "
                       "(_attention_kernel; wrapper :459)",
}
SOURCES = {
    "conv2d_nhwc": ("cuda", "diffphycon_tpu_torch/csrc/conv2d_nhwc.cu"),
    "downsample_nhwc": ("cuda", "diffphycon_tpu_torch/csrc/downsample_nhwc.cu"),
    "group_norm_act": ("triton", "diffphycon_tpu_torch/kernels/group_norm_triton.py"),
    "linear_attention_block": ("cuda", "diffphycon_tpu_torch/csrc/linear_attention.cu"),
    "attention_block": ("cuda", "diffphycon_tpu_torch/csrc/attention.cu"),
}
SMOKE_SOURCES = {"cg_pressure": ("cuda", "diffphycon_tpu_torch/csrc/cg_pressure.cu")}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def main_path_calls(dim, mults, batch, H=16, W=128):
    """Every kernel call of one UNet2D forward, in order, from the
    architecture (phase 4 checks this list against the launch counters), as
    (kernel, args, Pallas kernel of pallas_unet2d.py it stands for).

    conv2d_nhwc: (B, h, w, Ca, Cb, Co, k, upsample) with (h, w) the source
    size; downsample_nhwc: (B, h, w, C, Co); group_norm_act: (B, h, w, C,
    film); linear_attention_block, attention_block: (B, h, w, C)."""
    dims = [dim] + [dim * m for m in mults]
    in_out = list(zip(dims[:-1], dims[1:]))
    n = len(in_out)
    calls = []

    def conv(h, w, ca, cb, co, k, up=False, row="_resblock_kernel"):
        calls.append(("conv2d_nhwc", (batch, h, w, ca, cb, co, k, up), row))

    def res(h, w, ca, cb, co):
        conv(h, w, ca, cb, co, 3)
        calls.append(("group_norm_act", (batch, h, w, co, True), "_resblock_kernel"))
        conv(h, w, co, 0, co, 3)
        if ca + cb != co:
            conv(h, w, ca, cb, co, 1)
        calls.append(("group_norm_act", (batch, h, w, co, False), "_resblock_kernel"))

    h, w, c = H, W, dim
    skips = []
    for i, (di, do) in enumerate(in_out):
        res(h, w, c, 0, di)
        skips.append(di)
        res(h, w, di, 0, di)
        calls.append(("linear_attention_block", (batch, h, w, di), "_linear_attention_kernel"))
        skips.append(di)
        if i < n - 1:
            calls.append(("downsample_nhwc", (batch, h, w, di, do), "_downsample_kernel"))
            h, w = h // 2, w // 2
        else:
            conv(h, w, di, 0, do, 3, row="_conv_kernel")
        c = do
    res(h, w, c, 0, c)
    calls.append(("attention_block", (batch, h, w, c), "_attention_kernel"))
    res(h, w, c, 0, c)
    for i, (di, do) in enumerate(reversed(in_out)):
        res(h, w, c, skips.pop(), do)
        res(h, w, do, skips.pop(), do)
        calls.append(("linear_attention_block", (batch, h, w, do), "_linear_attention_kernel"))
        if i < n - 1:
            conv(h, w, do, 0, di, 3, up=True, row="_upsample_kernel")
            h, w = 2 * h, 2 * w
        else:
            conv(h, w, do, 0, di, 3, row="_conv_kernel")
        c = di
    res(h, w, c, dim, dim)
    return calls


def expected_counts(calls):
    conv = [a for k, a, _ in calls if k == "conv2d_nhwc"]
    return {
        "conv2d_nhwc": len(conv),
        "conv2d_nhwc.dual": sum(a[4] > 0 for a in conv),
        "conv2d_nhwc.upsample": sum(a[7] for a in conv),
        "downsample_nhwc": sum(k == "downsample_nhwc" for k, _, _ in calls),
        "group_norm_act": sum(k == "group_norm_act" for k, _, _ in calls),
        "linear_attention_block": sum(k == "linear_attention_block" for k, _, _ in calls),
        "attention_block": sum(k == "attention_block" for k, _, _ in calls),
    }


def timed(torch, fn, n=20, warm=3):
    """Median ms of n CUDA-event-timed calls after `warm` untimed ones."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    ts.sort()
    return ts[len(ts) // 2]


def bound(flops, nbytes):
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attention_flops(kind, b_, n, c):
    """FLOPs of one attention block: the qkv projection, the out-projection,
    the per-head products (linear: k v^T and context^T q, 32x32 per token;
    full: q k^T and P v, n per token) and ~10 per element of the norms and
    softmaxes."""
    hidden = HEADS * DIM_HEAD
    proj = 2 * n * c * 3 * hidden + 2 * n * hidden * c
    core = 2 * 2 * n * HEADS * DIM_HEAD * (DIM_HEAD if kind == "linear_attention_block" else n)
    return b_ * (proj + core + 10 * n * (2 * c + hidden))


def kernel_case(torch, F, kb, gen, kind, args):
    """(kernel fn, plain fn, library fn or None, flops, bytes, extra timings)
    at one signature."""
    dev = "cuda"

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + shift

    if kind in ("linear_attention_block", "attention_block"):
        from diffphycon_tpu_torch.kernels import attention as ka

        b_, h, w, c = args
        hidden = HEADS * DIM_HEAD
        x = rnd(b_, h, w, c, scale=2.0, shift=0.3)
        p = {"norm_g": rnd(c, scale=0.1, shift=1.0),
             "wqkv": rnd(c, 3 * hidden, scale=c ** -0.5),
             "wo": rnd(hidden, c, scale=hidden ** -0.5), "bo": rnd(c, scale=0.1)}
        linear = kind == "linear_attention_block"
        if linear:
            p["out_g"] = rnd(c, scale=0.1, shift=1.0)
        kern = ka.linear_attention_block if linear else ka.attention_block
        plain = ka.linear_attention_block_plain if linear else ka.attention_block_plain
        n = h * w
        nbytes = 4 * (2 * x.numel() + c * 3 * hidden + hidden * c + 3 * c)
        extra = {}
        if not linear:  # yardstick of the core: SDPA on this block's q, k, v
            qkv = ka._qkv(x, p["norm_g"], p["wqkv"], HEADS, DIM_HEAD)
            q, k, v = (t.permute(0, 2, 1, 3).contiguous() for t in qkv.unbind(2))
            extra["sdpa_core"] = lambda: F.scaled_dot_product_attention(q, k, v)
        return (lambda: kern(x, p), lambda: plain(x, p), None,
                attention_flops(kind, b_, n, c), nbytes, extra)

    if kind == "conv2d_nhwc":
        b_, h, w, ca, cb, co, k, up = args
        ci = ca + cb
        xa = rnd(b_, h, w, ca)
        xb = rnd(b_, h, w, cb) if cb else None
        wt = rnd(k * k * ci, co, scale=1.0 / math.sqrt(k * k * ci))
        bias = rnd(co, scale=0.1)
        # cuDNN on its NCHW layout (the transposes are made outside the
        # timing; the concat and the upsample are timed)
        w_lib = wt.reshape(k, k, ci, co).permute(3, 2, 0, 1).contiguous()
        xa_l = xa.permute(0, 3, 1, 2).contiguous()
        xb_l = xb.permute(0, 3, 1, 2).contiguous() if cb else None

        def library():
            x = xa_l if xb_l is None else torch.cat([xa_l, xb_l], dim=1)
            if up:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            return F.conv2d(x, w_lib, bias, padding=k // 2)

        ho, wo = (2 * h, 2 * w) if up else (h, w)
        flops = 2 * b_ * ho * wo * co * k * k * ci
        nbytes = 4 * (xa.numel() + (xb.numel() if cb else 0) + wt.numel() + co
                      + b_ * ho * wo * co)
        return (lambda: kb.conv2d_nhwc(xa, wt, bias, x_b=xb, k=k, upsample=up),
                lambda: kb.conv2d_nhwc_plain(xa, wt, bias, x_b=xb, k=k, upsample=up),
                library, flops, nbytes, {})
    if kind == "downsample_nhwc":
        b_, h, w, c, co = args
        x = rnd(b_, h, w, c)
        wt = rnd(4 * c, co, scale=1.0 / math.sqrt(4 * c))
        bias = rnd(co, scale=0.1)
        w_lib = wt.reshape(2, 2, c, co).permute(3, 2, 0, 1).contiguous()
        x_l = x.permute(0, 3, 1, 2).contiguous()
        flops = 2 * b_ * (h // 2) * (w // 2) * co * 4 * c
        nbytes = 4 * (x.numel() + wt.numel() + co + b_ * (h // 2) * (w // 2) * co)
        return (lambda: kb.downsample_nhwc(x, wt, bias),
                lambda: kb.downsample_nhwc_plain(x, wt, bias),
                lambda: F.conv2d(x_l, w_lib, bias, stride=2),
                flops, nbytes, {})
    b_, h, w, c, film = args
    x = rnd(b_, h, w, c, scale=2.0, shift=0.5)
    gamma = rnd(c, scale=0.5, shift=1.0)
    beta = rnd(c, scale=0.1)
    ss = rnd(b_, 2 * c, scale=0.5) if film else None
    res = None if film else rnd(b_, h, w, c)

    x_l = x.permute(0, 3, 1, 2).contiguous()
    res_l = None if film else res.permute(0, 3, 1, 2).contiguous()

    def library():
        y = F.group_norm(x_l, 1, gamma, beta, eps=kb.GN_EPS)
        if film:
            y = y * (ss[:, :c, None, None] + 1.0) + ss[:, c:, None, None]
        y = F.silu(y)
        return y if film else y + res_l

    # per element: mean 1, variance 3, normalise+affine 4, SiLU 5, FiLM 3, res 1
    flops = x.numel() * (13 + (3 if film else 1))
    nbytes = 4 * (2 * x.numel() + 2 * c + (ss.numel() if film else res.numel()))
    return (lambda: kb.group_norm_act(x, gamma, beta, 1, ss=ss, res=res),
            lambda: kb.group_norm_act_plain(x, gamma, beta, 1, ss=ss, res=res),
            library, flops, nbytes, {})


def profile_window(torch, fn):
    """Device time by kernel over one call of fn: (wall ms, device ms, rows
    of (name, device ms))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
    rows = [(e.key, e.device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    if not rows:
        fail("torch.profiler recorded no device time")
    return wall * 1e3, sum(v for _, v in rows), sorted(rows, key=lambda r: -r[1])


def smoke_kernel_phase(torch, smi_line):
    """Phase 6: K4 against its plain version on real rollout divergences."""
    import numpy as np

    from diffphycon_tpu_torch.apps.generate_smoke import sample_waypoints, segment_schedule
    from diffphycon_tpu_torch.kernels import cg_pressure as kcg
    from diffphycon_tpu_torch.physics.fluids import grids
    from diffphycon_tpu_torch.physics.fluids import smoke_env

    t0 = time.time()
    sim = smoke_env.SmokeSim.create(accuracy=1e-6, max_iterations=500, device="cuda")
    rng = np.random.default_rng(0)
    dens0 = np.zeros((SMOKE_B, 128, 128), np.float32)
    seg_v = np.zeros((SMOKE_B, 4, 2), np.float32)
    seg_starts = np.zeros((SMOKE_B, 4), np.int32)
    for j in range(SMOKE_B):
        xs, ys = sample_waypoints(rng)
        dens0[j, ys[0] : ys[0] + 10, xs[0] : xs[0] + 10] = 1.0
        seg_v[j], seg_starts[j] = segment_schedule(rng, xs, ys)
    steps = 12
    with torch.no_grad():
        out = smoke_env.generator_rollout(
            sim, torch.from_numpy(dens0).cuda(), torch.from_numpy(seg_v),
            torch.from_numpy(seg_starts), num_steps=steps,
            generator=torch.Generator(device="cuda").manual_seed(0))
        k = steps - 1  # a carry-over step: previous velocity + noise on the ring
        ctrl = out["controls"][:, k]
        stag = smoke_env.controlled_velocity(out["velocitys"][:, k], ctrl[..., 0],
                                             ctrl[..., 1]) * sim.velocity_mask[None]
        div = grids.staggered_divergence(stag)[..., 0].contiguous()
        coeffs, acc, maxit = sim.coeffs, 1e-6, 500
        p, iters = kcg.cg_pressure(div, coeffs, acc, maxit)
        p_plain, iters_plain = kcg.cg_pressure_plain(div, coeffs, acc, maxit)
        torch.cuda.synchronize()
        err = (p - p_plain).abs().max().item()
        tol = KERNEL_RTOL * max(1.0, p_plain.abs().max().item())
        iter_gap = (iters - iters_plain).abs().float() / iters_plain.float().clamp(min=1)
        projected = stag - grids.staggered_gradient(p[..., None]) * sim.velocity_mask[None]
        active = torch.as_tensor(smoke_env.smoke_domain_128().active, device="cuda")
        div_after = (grids.staggered_divergence(projected)[..., 0] * active)[:, 1:-1, 1:-1]
        ms = timed(torch, lambda: kcg.cg_pressure(div, coeffs, acc, maxit), n=10, warm=2)
        plain_ms = timed(torch, lambda: kcg.cg_pressure_plain(div, coeffs, acc, maxit),
                         n=3, warm=1)
    n_cells = div.shape[1] * div.shape[2]
    total_iters = int(iters.sum().item())
    flops = CG_FLOPS_PER_CELL * n_cells * (total_iters + SMOKE_B)
    nbytes = 4 * (2 * div.numel() + 5 * n_cells + SMOKE_B)  # div, coeffs in; p, iters out
    b_ms, b_by = bound(flops, nbytes)
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": None}
    emit({"phase": "cg_kernel", "batch": SMOKE_B, "grid": list(div.shape[1:]),
          "accuracy": acc, "iterations": iters.tolist(),
          "plain_iterations": iters_plain.tolist(), "max_iter_gap": iter_gap.max().item(),
          "tol": tol, "max_div_after_projection": div_after.abs().max().item(),
          "max_div_before": div.abs().max().item(), "gflop": flops / 1e9,
          "mbytes": nbytes / 1e6, "us_per_iteration": 1e3 * ms / iters.max().item(),
          "nvidia_smi": smi_line, "seconds": round(time.time() - t0, 3), **row})
    if not err <= tol:
        fail(f"K4 differs from its plain version: {err} > {tol}")
    if not iter_gap.max().item() <= CG_ITER_RTOL:
        fail(f"K4 iteration counts {iters.tolist()} vs plain {iters_plain.tolist()}")
    if not div_after.abs().max().item() < 1e-4:
        fail("the projected velocity keeps divergence in the interior")
    return row


def unet3d_flops(torch, sbench, cfg):
    """Convolution and matmul FLOPs of one UNet3D forward at batch SMOKE_B,
    counted by torch's FlopCounterMode on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        net = sbench.UNet3D(dim=cfg.dim, dim_mults=tuple(cfg.dim_mults), channels=6,
                            out_dim=6)
        x = torch.empty(SMOKE_B, cfg.frames, cfg.image_size, cfg.image_size, 6)
        t = torch.empty(SMOKE_B)
    with FlopCounterMode(display=False) as counter:
        net(x, t)
    return counter.get_total_flops()


def smoke_main_path(torch, smi_line):
    """Phase 7: generate_smoke + infer_smoke main(), K4 launches, timings."""
    from diffphycon_tpu_torch.apps import generate_smoke, infer_smoke
    from diffphycon_tpu_torch.benchmarks import smoke as sbench
    from diffphycon_tpu_torch.kernels import cg_pressure as kcg
    from diffphycon_tpu_torch.kernels import unet2d_blocks as kb
    from diffphycon_tpu_torch.physics.fluids.smoke_env import SmokeSim
    from diffphycon_tpu_torch.training.data import load_smoke_dataset

    t0 = time.time()
    work = os.path.join("build", "chip_smoke")
    data_dir = os.path.join(work, "smoke_data")
    gen_args = generate_smoke.build_parser().parse_args([
        "--out", data_dir, "--n_test", str(SMOKE_B), "--n_train", "0",
        "--batch", str(SMOKE_B), "--filter_rate", "-1", "--min_sum_rate", "-1",
        "--max_sum_rate", "1e9"])
    inf_args = infer_smoke.build_parser().parse_args([
        "--dataset_path", data_dir, "--init_seed", "0", "--batch_size", str(SMOKE_B),
        "--n_test_samples", str(SMOKE_B), "--ddim_sampling_steps", str(SMOKE_DDIM_STEPS),
        "--ddim_eta", "1.0", "--calibrate", "True",
        "--inference_result_path", os.path.join(work, "smoke_results")])
    kb.reset_launch_counts()
    kcg.cg_pressure.launches = 0
    tic = time.perf_counter()
    generate_smoke.main(gen_args)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - tic
    agg = infer_smoke.main(inf_args)
    torch.cuda.synchronize()
    launches = kcg.cg_pressure.launches
    other = kb.launch_counts()
    want = 256 + 3 * 255  # generator rollout + evaluation and two calibration rows
    finite = all(math.isfinite(v) for v in agg.values())
    emit({"phase": "smoke_main_path",
          "apps": ["diffphycon_tpu_torch/apps/generate_smoke.py",
                   "diffphycon_tpu_torch/apps/infer_smoke.py"],
          "sampler": f"ddim {SMOKE_DDIM_STEPS} steps, eta 1, two UNet3Ds dim 64 "
                     f"(1, 2, 4), batch {SMOKE_B}, w_prob_exp 0.97, guidance 1e5",
          "result": agg, "finite": finite, "generate_seconds": gen_s,
          "cg_launches": launches, "cg_launches_expected": want,
          "unet2d_kernel_launches": other, "seconds": round(time.time() - t0, 3)})
    if not finite:
        fail(f"non-finite smoke metrics: {agg}")
    if launches != want:
        fail(f"K4 launched {launches} times on the smoke path, expected {want}")

    # the UNet3D forward, one guided DDIM step and one evaluation rollout at
    # batch 8, timed apart from the app
    t0 = time.time()
    cfg = sbench.SmokeConfig(ddim_sampling_steps=SMOKE_DDIM_STEPS)
    net = sbench.init_params(cfg, seed=0, device="cuda")
    net_w = sbench.init_params(sbench.SmokeConfig(is_w_model=True), seed=1, device="cuda")
    data = torch.from_numpy(load_smoke_dataset(data_dir, "test")[:SMOKE_B]).cuda()
    x = torch.randn(SMOKE_B, 32, 64, 64, 6, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    tt = torch.full((SMOKE_B,), 500.0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        fwd_ms = timed(torch, lambda: net(x, tt), n=5, warm=1)
        fwd_flops = unet3d_flops(torch, sbench, cfg)
        gd = sbench.build_diffusion(cfg, net, model_w=net_w, device="cuda")
        guidance = sbench.build_guidance(cfg, device="cuda")
        cond = {"init": data[:, 0, :, :, 0] / float(sbench.RESCALER[0])}
        gen = torch.Generator(device="cuda").manual_seed(4)
        step_ms = timed(torch, lambda: gd.ddim_step(x, 999, 799, cond, guidance, gen),
                        n=3, warm=1)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        sim = SmokeSim.create(accuracy=1e-6, device="cuda")
        pred = (data[:, :32] / torch.as_tensor(sbench.RESCALER, device="cuda")).contiguous()
        kcg.cg_pressure.launches = 0
        wall_ms, dev_ms, rows = profile_window(
            torch, lambda: sbench.evaluate_samples(sim, pred, data))
        cg_ms = sum(v for k, v in rows if "cg_pressure" in k)
    emit({"phase": "smoke_timings", "batch": SMOKE_B, "unet3d_forward_ms": fwd_ms,
          "unet3d_forward_tflop": fwd_flops / 1e12,
          "unet3d_tflop_per_s": fwd_flops / fwd_ms / 1e9,
          "guided_ddim_step_s": step_ms / 1e3, "peak_memory_gb": peak_gb,
          "rollout": {"solves": kcg.cg_pressure.launches, "wall_ms": wall_ms,
                      "device_ms": dev_ms, "busy_share": dev_ms / wall_ms,
                      "cg_kernel_ms": cg_ms, "cg_share_of_wall": cg_ms / wall_ms,
                      "top": [[k[:60], v] for k, v in rows[:8]]},
          "nvidia_smi": smi_line, "seconds": round(time.time() - t0, 3)})
    if not cg_ms > 0:
        fail("the profiled rollout shows no K4 time")
    return launches


def burgers_training_phase(torch, smi_line, per_forward, device="cuda", dim=DIM, mults=MULTS):
    """Phase 8: gradient parity at full width, the train app (fresh,
    resumed, prior), training steps/s, then the infer app from the two
    checkpoints. per_forward: the kernel launches of one UNet2D forward."""
    from diffphycon_tpu_torch.apps import infer_burgers, train_burgers
    from diffphycon_tpu_torch.benchmarks import burgers as bench
    from diffphycon_tpu_torch.kernels import unet2d_blocks as kb
    from diffphycon_tpu_torch.training import data
    from diffphycon_tpu_torch.training.trainer import Trainer, TrainerConfig

    work = os.path.join("build", "chip_smoke")
    data_root = os.path.join(work, "data")
    models = os.path.join(work, "trained_models")
    shutil.rmtree(models, ignore_errors=True)

    # 8a. gradient parity, kernels (plain VJPs) vs the plain forward
    t0 = time.time()
    cfg = bench.BurgersConfig(dim=dim, dim_mults=mults, is_condition_u0=True,
                              is_condition_uT=True)
    net = bench.init_params(cfg, seed=0, device=device).train()
    u, f = data.synthetic_burgers(64, seed=0, cache_dir=os.path.join(data_root, "synthetic"),
                                  device=device)
    stacked = data.stack_burgers_uf(u, f, rescaler=bench.RESCALER)
    x = torch.from_numpy(stacked[:TRAIN_B]).to(device)
    gen = torch.Generator(device=device).manual_seed(5)
    gd_k = bench.build_diffusion(cfg, net, device=device)
    gd_p = bench.build_diffusion(cfg, net.forward_plain, device=device)
    t, noise = gd_k.draw_t_noise(x, gen)
    losses, grads = [], []
    for gd in (gd_k, gd_p):
        net.zero_grad(set_to_none=True)
        kb.reset_launch_counts()
        loss = gd.p_losses(x, t, bench.derive_cond(x), noise)
        loss.backward()
        torch.cuda.synchronize()
        losses.append(loss.item())
        grads.append({n: p.grad.detach().clone() for n, p in net.named_parameters()})
        if gd is gd_k:
            parity_counts = kb.launch_counts()
    rel = {n: ((grads[0][n] - g).norm() / g.norm()).item() for n, g in grads[1].items()}
    zero = [n for n in rel if not (grads[0][n].abs().max() > 0 and grads[1][n].abs().max() > 0)]
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    emit({"phase": "train_grad_parity", "batch": TRAIN_B, "tensors": len(rel),
          "checks": "kernel forwards and gradient flow (both sides share the plain "
                    "backward; its arithmetic is checked against jax.grad on the CPU)",
          "params": sum(p.numel() for p in net.parameters()), "loss_kernels": losses[0],
          "loss_plain": losses[1], "max_rel_grad_err": worst[0][1], "worst": worst,
          "tol": GRAD_RTOL, "zero_grads": zero, "launches": parity_counts,
          "seconds": round(time.time() - t0, 3)})
    if zero:
        fail(f"parameters with a zero gradient: {zero[:5]}")
    if not worst[0][1] <= GRAD_RTOL or not math.isfinite(losses[0]):
        fail(f"kernel-backed gradients differ from the plain ones: {worst}")
    if parity_counts != per_forward:
        fail(f"launches of one training forward {parity_counts} != {per_forward}")
    del grads

    # 8b. the train app: 30 steps, resumed to 40, then the prior model
    t0 = time.time()
    width = ["--dim", str(dim), "--dim_mults", *map(str, mults), "--device", device]
    common = width + ["--synthetic_data", "64", "--batch_size", str(TRAIN_B),
                      "--checkpoint_interval", "10", "--is_condition_u0", "True",
                      "--is_condition_uT", "True", "--data_root", data_root, "--exp_id",
                      "smoke", "--seed", "0"]
    runs = [("joint", ["--train_num_steps", "30"], "burgers", 30, 30),
            ("joint resumed", ["--train_num_steps", "40", "--resume", "True"], "burgers", 10, 40),
            ("prior", ["--train_num_steps", "10", "--is_model_w", "True"], "burgers_w", 10, 10)]
    app = []
    for name, extra, sub, steps, final in runs:
        folder = os.path.join(models, sub, "smoke")
        args = train_burgers.build_parser().parse_args(
            common + extra + ["--results_folder", folder])
        kb.reset_launch_counts()
        tic = time.perf_counter()
        trainer = train_burgers.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
        counts = kb.launch_counts()
        log = [json.loads(line) for line in open(os.path.join(folder, "train_log.jsonl"))]
        ckpts = sorted(int(d) for d in os.listdir(os.path.join(folder, "ckpt")) if d.isdigit())
        want = {k: steps * v for k, v in per_forward.items()}
        app.append({"run": name, "final_step": trainer.step, "launches": counts,
                    "expected": want, "log": log, "checkpoints": ckpts, "seconds": wall})
        if trainer.step != final or counts != want:
            fail(f"train app ({name}): step {trainer.step} (want {final}), launches "
                 f"{counts} (want {want})")
        if not log or not all(math.isfinite(r["loss"]) for r in log):
            fail(f"train app ({name}): non-finite or missing losses {log}")
        if final not in ckpts:
            fail(f"train app ({name}): no checkpoint at step {final} ({ckpts})")
    emit({"phase": "train_app", "app": "diffphycon_tpu_torch/apps/train_burgers.py",
          "runs": app, "seconds": round(time.time() - t0, 3)})

    # 8c. optimizer steps/s at batch 16 over several windows (the step is
    # host-bound, so its time varies between windows), the forward /
    # backward / update split
    t0 = time.time()
    trainer = Trainer(gd_k, net, data.ArrayDataset(stacked).batches(TRAIN_B, seed=1),
                      bench.derive_cond,
                      TrainerConfig(results_folder=os.path.join(work, "train_timing")),
                      device=device)
    for _ in range(3):
        trainer.train_step(next(trainer.batch_iter))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_windows, n_steps = 4, 10
    split = {"forward": 0.0, "backward": 0.0, "update": 0.0}
    window_ms = []
    for _ in range(n_windows):
        tic = time.perf_counter()
        for _ in range(n_steps):
            trainer.train_step(next(trainer.batch_iter))
        torch.cuda.synchronize()
        window_ms.append(1e3 * (time.perf_counter() - tic) / n_steps)
    step_ms = sorted(window_ms)[n_windows // 2]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for _ in range(n_steps):  # the same steps cut by synchronisations
        xb = torch.as_tensor(next(trainer.batch_iter), device=device)
        tt, nn_ = gd_k.draw_t_noise(xb, trainer.generator)
        for p in trainer.params:
            p.grad = None
        tics = [time.perf_counter()]
        loss = gd_k.p_losses(xb, tt, bench.derive_cond(xb), nn_)
        torch.cuda.synchronize()
        tics.append(time.perf_counter())
        loss.backward()
        torch.cuda.synchronize()
        tics.append(time.perf_counter())
        trainer.apply_gradients()
        torch.cuda.synchronize()
        tics.append(time.perf_counter())
        for key, a, b_ in zip(split, tics[:-1], tics[1:]):
            split[key] += 1e3 * (b_ - a) / n_steps

    def two_steps():
        for _ in range(2):
            trainer.train_step(next(trainer.batch_iter))

    wall_ms, dev_ms, rows = profile_window(torch, two_steps)
    total = sum(split.values())
    emit({"phase": "train_timing", "batch": TRAIN_B, "steps_timed": n_windows * n_steps,
          "window_ms_per_step": window_ms, "ms_per_step": step_ms,
          "optimizer_steps_per_sec": 1e3 / step_ms,
          "window_spread": (max(window_ms) - min(window_ms)) / step_ms,
          "split_ms": split, "backward_share": split["backward"] / total,
          "peak_memory_gb": peak_gb,
          "profile": {"steps": 2, "wall_ms": wall_ms, "device_ms": dev_ms,
                      "busy_share": dev_ms / wall_ms,
                      "top": [[k[:60], v] for k, v in rows[:10]]},
          "nvidia_smi": smi_line, "seconds": round(time.time() - t0, 3)})
    del trainer, gd_k, gd_p, net
    torch.cuda.empty_cache()

    # 8d. the infer app from the two checkpoints
    t0 = time.time()
    args = infer_burgers.build_parser().parse_args(width + [
        "--model_root", models, "--exp_id", "smoke", "--checkpoint", "40",
        "--checkpoint__model_w", "10", "--synthetic_data", str(B), "--n_test_samples", str(B),
        "--batch_size", str(B), "--eval_two_models", "True", "--wus", "1000",
        "--is_condition_u0", "True", "--is_condition_uT", "True", "--using_ddim", "True",
        "--ddim_sampling_steps", "10", "--data_root", data_root,
        "--save_file", os.path.join(work, "result_trained.json")])
    kb.reset_launch_counts()
    entry = infer_burgers.main(args)["wu=1000.0,wf=0.0"]
    torch.cuda.synchronize()
    finite = all(math.isfinite(v) for v in entry.values())
    emit({"phase": "infer_from_checkpoints", "app": "diffphycon_tpu_torch/apps/infer_burgers.py",
          "checkpoints": {"burgers/smoke": 40, "burgers_w/smoke": 10},
          "sampler": "ddim 10 steps, eta 0, two models, wu=1000, batch 50",
          "result": entry, "finite": finite, "launches": kb.launch_counts(),
          "seconds": round(time.time() - t0, 3)})
    if not finite:
        fail(f"non-finite metrics from the trained checkpoints: {entry}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    try:
        from diffphycon_tpu_torch.apps import infer_burgers
        from diffphycon_tpu_torch.benchmarks import burgers as bench
        from diffphycon_tpu_torch.kernels import _build
        from diffphycon_tpu_torch.kernels import unet2d_blocks as kb
    except ImportError as e:
        fail(f"the port is not importable here ({e}); run from the repository root")
    import torch.nn.functional as F

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_all = time.time()

    # -- 1. device ----------------------------------------------------------
    t0 = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print(smi_line, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi_line, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "seconds": round(time.time() - t0, 3)})

    # -- 2. build -----------------------------------------------------------
    t0 = time.time()
    lib = _build.build()
    _build.load_library()
    ptxas = [ln.replace("ptxas info    :", "").strip() for ln in
             (lib.parent / "ptxas.log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "library": str(lib.relative_to(_build.PKG_DIR.parent)),
          "ptxas": ptxas, "seconds": round(time.time() - t0, 3)})

    # -- 3. each kernel against its plain version -----------------------------
    t0 = time.time()
    calls = main_path_calls(DIM, MULTS, B)
    per_fwd = {}
    for k, a, _ in calls:
        per_fwd[(k, a)] = per_fwd.get((k, a), 0) + 1
    sig_times = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    agg = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
               "ops_ms": 0.0, "bytes_ms": 0.0, "max_abs_err": 0.0} for k in SOURCES}
    bad = []
    with torch.no_grad():
        for (kname, args), count in per_fwd.items():
            kern, plain, library, flops, nbytes, extra = kernel_case(torch, F, kb, gen,
                                                                     kname, args)
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            tol = KERNEL_RTOL * max(1.0, ref.abs().max().item())
            ms, plain_ms = timed(torch, kern), timed(torch, plain)
            lib_ms = None if library is None else timed(torch, library)
            b_ms, b_by = bound(flops, nbytes)
            emit({"phase": "kernel", "kernel": kname, "args": list(args),
                  "per_forward": count, "max_abs_err": err, "tol": tol,
                  "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                  "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
                  "mbytes": nbytes / 1e6,
                  **{f"{k}_ms": timed(torch, fn) for k, fn in extra.items()}})
            if not err <= tol:
                bad.append((kname, args, err, tol))
            sig_times[(kname, args)] = {"ms": ms, "plain_ms": plain_ms,
                                        "library_ms": lib_ms, "bound_ms": b_ms}
            a = agg[kname]
            a["ms"] += count * ms
            a["plain_ms"] += count * plain_ms
            a["library_ms"] = None if lib_ms is None else a["library_ms"] + count * lib_ms
            a["bound_ms"] += count * b_ms
            a["ops_ms"] += count * 1e3 * flops / FP32_PEAK
            a["bytes_ms"] += count * 1e3 * nbytes / HBM_RATE
            a["max_abs_err"] = max(a["max_abs_err"], err)
            del out, ref
    # per Pallas kernel replaced: launches and summed times in one forward;
    # _concat_kernel is the two-source K1 reads and _matmul_bias_kernel the
    # 1x1 K1 convs, both already inside _resblock_kernel
    rows = {}
    for kname, args, row in calls:
        names = [row]
        if kname == "conv2d_nhwc" and args[4]:
            names.append("_concat_kernel")
        if kname == "conv2d_nhwc" and args[6] == 1:
            names.append("_matmul_bias_kernel")
        for name in names:
            r = rows.setdefault(name, {"launches": {}, "ms": 0.0, "plain_ms": 0.0,
                                       "library_ms": 0.0, "bound_ms": 0.0})
            r["launches"][kname] = r["launches"].get(kname, 0) + 1
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                v = sig_times[(kname, args)][key]
                r[key] = None if v is None or r[key] is None else r[key] + v
    emit({"phase": "kernels_checked", "signatures": len(per_fwd),
          "per_pallas_kernel_per_forward": rows, "seconds": round(time.time() - t0, 3)})
    if bad:
        fail(f"kernel mismatches: {bad}")
    torch.cuda.empty_cache()

    # -- 4. full-width UNet2D: kernel forward vs plain forward ----------------
    t0 = time.time()
    cfg = bench.BurgersConfig(is_condition_u0=True, is_condition_uT=True)
    net = bench.init_params(cfg, seed=0, device="cuda")
    x = torch.randn(B, cfg.pad_t, cfg.nx, 2, generator=gen, device="cuda")
    t = torch.linspace(0, 999, B, device="cuda")
    with torch.no_grad():
        kb.reset_launch_counts()
        out = net(x, t)
        torch.cuda.synchronize()
        counts = kb.launch_counts()
        ref = net.forward_plain(x, t)
        err = (out - ref).abs().max().item()
        tol = UNET_RTOL * max(1.0, ref.abs().max().item())
        fwd_ms = timed(torch, lambda: net(x, t), n=10)
        plain_fwd_ms = timed(torch, lambda: net.forward_plain(x, t), n=10)
    fwd_counts = expected_counts(calls)
    emit({"phase": "unet2d", "params": sum(p.numel() for p in net.parameters()),
          "max_abs_err": err, "tol": tol, "launches_per_forward": counts,
          "expected": fwd_counts, "forward_ms": fwd_ms, "plain_forward_ms": plain_fwd_ms,
          "finite": bool(torch.isfinite(out).all()),
          "seconds": round(time.time() - t0, 3)})
    if not err <= tol or not torch.isfinite(out).all():
        fail(f"UNet2D kernel forward differs from the plain forward: {err} > {tol}")
    if counts != fwd_counts:
        fail(f"launch counts per forward {counts} != expected {fwd_counts}")
    del out, ref

    # -- 5. main path through the app ---------------------------------------
    t0 = time.time()
    work = os.path.join("build", "chip_smoke")
    app_args = infer_burgers.build_parser().parse_args([
        "--init_seed", "0", "--synthetic_data", str(B), "--n_test_samples", str(B),
        "--batch_size", str(B), "--eval_two_models", "True", "--wus", "1000",
        "--is_condition_u0", "True", "--is_condition_uT", "True",
        "--using_ddim", "True", "--ddim_sampling_steps", "50", "--ddim_eta", "0",
        "--data_root", os.path.join(work, "data"),
        "--save_file", os.path.join(work, "result.json")])
    kb.reset_launch_counts()
    results = infer_burgers.main(app_args)
    torch.cuda.synchronize()
    main_counts = kb.launch_counts()
    entry = results["wu=1000.0,wf=0.0"]
    finite = all(math.isfinite(v) for v in entry.values())
    emit({"phase": "main_path", "app": "diffphycon_tpu_torch/apps/infer_burgers.py",
          "sampler": "ddim 50 steps, eta 0, two models, wu=1000, batch 50",
          "result": entry, "launches": main_counts, "finite": finite,
          "seconds": round(time.time() - t0, 3)})
    if not finite:
        fail(f"non-finite main-path metrics: {entry}")
    for k in SOURCES:
        if main_counts[k] <= 0:
            fail(f"kernel {k} was not launched on the main path")

    # guided DDPM steps/s at batch 50 (bench.py's metric), and DDIM parity
    t0 = time.time()
    net_w = bench.init_params(cfg, seed=1, device="cuda")
    u_target = torch.randn(B, 11, 128, generator=gen, device="cuda")
    cond_vals = {"u0": u_target[:, 0, :] / bench.RESCALER,
                 "uT": u_target[:, 10, :] / bench.RESCALER}
    guidance = bench.build_guidance(cfg, u_target, wu=1000.0)
    gd = bench.build_diffusion(cfg, net, model_w=net_w, device="cuda")
    ts = gd.sample_ts()
    xg = torch.Generator(device="cuda").manual_seed(1)
    x = gd.sample_init(B, xg)
    x = gd.sample_chunk(x, ts[:2], cond_vals, guidance, xg)  # warm-up
    torch.cuda.synchronize()
    n_steps = 20
    tic = time.perf_counter()
    x = gd.sample_chunk(x, ts[2 : 2 + n_steps], cond_vals, guidance, xg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - tic
    steps_per_sec = n_steps / dt

    def three_steps():
        nonlocal x
        x = gd.sample_chunk(x, ts[22:25], cond_vals, guidance, xg)

    wall_ms, dev_ms, rows = profile_window(torch, three_steps)
    busy = {"steps": 3, "wall_ms": wall_ms, "device_ms": dev_ms,
            "busy_share": dev_ms / wall_ms, "top": [[k[:60], v] for k, v in rows[:8]]}
    emit({"phase": "guided_ddpm", "batch": B, "steps_timed": n_steps,
          "seconds_timed": dt, "guided_denoise_steps_per_sec": steps_per_sec,
          "ms_per_step": 1e3 * dt / n_steps, "profile": busy,
          "finite": bool(torch.isfinite(x).all()), "nvidia_smi": smi_line})
    if not torch.isfinite(x).all():
        fail("non-finite samples in the guided DDPM loop")

    cfg_ddim = bench.BurgersConfig(is_condition_u0=True, is_condition_uT=True,
                                   using_ddim=True, ddim_sampling_steps=50)
    gd_k = bench.build_diffusion(cfg_ddim, net, model_w=net_w, device="cuda")
    gd_p = bench.build_diffusion(cfg_ddim, net.forward_plain,
                                 model_w=net_w.forward_plain, device="cuda")
    x_t = gd_k.sample_init(B, torch.Generator(device="cuda").manual_seed(2))
    three = gd_k.sample_ts()[:3]
    xk = gd_k.sample_chunk(x_t, three, cond_vals, guidance)
    xp = gd_p.sample_chunk(x_t, three, cond_vals, guidance)
    err = (xk - xp).abs().max().item()
    tol = DDIM_RTOL * max(1.0, xp.abs().max().item())
    emit({"phase": "ddim_parity", "steps": 3, "max_abs_err": err, "tol": tol,
          "seconds": round(time.time() - t0, 3)})
    if not err <= tol:
        fail(f"3 DDIM steps differ between kernel and plain forwards: {err} > {tol}")

    del gd, gd_k, gd_p, net, net_w, x, xk, xp
    torch.cuda.empty_cache()

    # -- 6-7. smoke: K4, then the main path ---------------------------------
    cg_row = smoke_kernel_phase(torch, smi_line)
    cg_launches = smoke_main_path(torch, smi_line)

    # -- 8. Burgers training ------------------------------------------------
    burgers_training_phase(torch, smi_line, fwd_counts)

    # -- kernels line ---------------------------------------------------------
    kernels = []
    for k, (route, src) in SOURCES.items():
        a = agg[k]
        kernels.append({
            "name": k, "route": route, "source": src, "replaces": REPLACES[k],
            "launches": main_counts[k], "max_abs_err": a["max_abs_err"],
            "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
            "bound_by": "operations" if a["ops_ms"] >= a["bytes_ms"] else "bytes",
            "library_ms": a["library_ms"]})
    for k, (route, src) in SMOKE_SOURCES.items():
        kernels.append({"name": k, "route": route, "source": src, "replaces": REPLACES[k],
                        "launches": cg_launches, **cg_row})
    emit({"phase": "done", "seconds": round(time.time() - t_all, 3),
          "note": "K1-K3, K5 (linear_attention_block, one K5a + one K5b per launch) "
                  "and K6 (attention_block): ms/plain_ms/bound_ms/library_ms are "
                  "sums over one UNet2D forward at batch 50 (library_ms null where "
                  "no single PyTorch call computes the block), launches those of the "
                  "Burgers main path; "
                  "cg_pressure's are per solve at batch 8 (no single PyTorch call "
                  "solves the system, so library_ms is null), launches those of "
                  "the smoke main path"})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
