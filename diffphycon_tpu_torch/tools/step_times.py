#!/usr/bin/env python
"""End-to-end step times of the port on one NVIDIA GPU, for comparing two
checkouts in turns on one card.

Prints one JSON line: the Burgers training step at batch 16 (ms per step
in 4 windows of 10 steps after 3 warm-up steps, as ``chip_smoke.py`` phase
8 times it), guided DDPM steps/s at batch 50 with two seeded UNet2Ds and
guidance (3 windows of 20 steps after 3 warm-up steps), one UNet2D forward
at batch 50 (median ms per CUDA-event pair of 20, also under
``--ddpm-only``), K6 at the Burgers
bottleneck (50, 2, 16, 512) (median ms per CUDA-event pair of 50 calls, and
the device time alone: 20 calls in a CUDA graph), and K4 per solve at batch
8 on the 127x127 smoke domain (median per event pair of 10 solves of seeded
random divergences, accuracy 1e-6). ``--ddpm-only`` times the guided DDPM
steps alone. ``--conv-digests`` times nothing: it runs K1 and K2 once at
every signature of one Burgers UNet2D forward at batch 50 (``chip_smoke.py``
phase 3's shapes, inputs from a CUDA generator seeded per signature) and
prints per signature the tile plan and the first 16 hex digits of the
SHA-256 of the output's bytes, so that two checkouts' lines show whether
their convolutions are bit-equal. ``--solver`` times the Burgers solver's
no-grad path alone: ``burgers_solve`` at batch 50 (10^4 steps of dt 1e-4)
and ``evaluate_samples`` at batch 50 (two such solves and the metrics), 3
synchronised calls each after a warm-up. ``--two-model`` times the three
two-model samplers, each with its two forwards concurrent on two CUDA
streams (``diffusion.core.two_forwards``) and one after the other, in
turns (concurrent, in turn, in turn, concurrent, twice): guided DDPM at
batch 50 (Burgers, two UNet2Ds), a guided DDIM step at batch 8 (smoke,
two UNet3Ds at the app's widths) and a guided DDPM step at batch 8
(jellyfish, the joint and thetas UNet3Ds at full width with the boundary
updater and the force surrogate), all with seeded random weights; per run
steps/s, the peak memory allocated and reserved, and the output's
largest difference from the first in-turn run's (0: bit-equal).
``--attention`` times nothing else: K5 and K6 alone at each of their
signatures of one Burgers UNet2D forward at batch 50 (``chip_smoke.py``
phase 3's shapes and inputs, a CUDA generator seeded per signature), the
device time of one call (``chip_smoke.timed_graph``) and the first 16 hex
digits of the SHA-256 of its output, and the device ms per forward of each
(under ``--bf16`` the bf16 variants, under ``--bf16act`` the bf16-activation
variants at ``chip_smoke.kernel_case_bf16act``'s inputs), each also per
CUDA-event pair (median of 50), and under ``--stages`` each launch's
device ms by kernel name (``torch.profiler``, 10 calls). ``--bf16``
builds every net of the run with bf16 (``BurgersConfig``,
``SmokeConfig`` and ``JellyfishConfig(bf16=True)``: bf16 weights in the
UNet2D's kernel packs, the UNet3Ds computing in bf16 as flax ``dtype=bf16``;
the jellyfish surrogates stay float32), so the bf16 samplers and training
step read the same way as the fp32 ones.

``--root DIR`` imports ``diffphycon_tpu_torch`` from another checkout (an
earlier version of the port, e.g. the parent commit unpacked with ``git
archive`` into a git-ignored directory) and builds its kernels there; the
timing code is this file's. Compare two checkouts in turns, each run a
process of its own, e.g. ``for r in A B B A A B; do python3
diffphycon_tpu_torch/tools/step_times.py --root $r; done``.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # the checkout holding this file


def timed(torch, fn, n):
    """Median ms of n CUDA-event-timed calls after 3 untimed ones."""
    for _ in range(3):
        fn()
    ts = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return sorted(ts)[n // 2]


def graph_ms(torch, fn, n=20):
    """Device ms per call: n calls captured in one CUDA graph, one replay
    timed by two events after a warm replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def conv_digests(torch) -> dict:
    """K1's and K2's output digests at every signature of one forward, from
    the ``chip_smoke.py`` and the port on ``sys.path``."""
    import torch.nn.functional as F

    import chip_smoke as cs
    from diffphycon_tpu_torch.kernels import unet2d_blocks as kb

    sigs = sorted({(k, a) for k, a, _ in cs.main_path_calls(cs.DIM, cs.MULTS, cs.B)
                   if k in cs.TC_KERNELS})
    digests = {}
    with torch.no_grad():
        for i, (kind, sig) in enumerate(sigs):
            gen = torch.Generator(device="cuda").manual_seed(i)
            out = cs.kernel_case(torch, F, kb, gen, kind, sig)[0]()
            torch.cuda.synchronize()
            plan = kb.tile_plan(*cs.gemm_dims(kind, sig))
            digests[f"{kind}{list(sig)}"] = [
                list(plan), hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]]
    return {"signatures": len(sigs), "digests": digests}


def attention_times(torch, bf16: bool, bf16act: bool = False, stages: bool = False) -> dict:
    """K5's and K6's device ms, event-pair ms and output digests at every
    signature of one forward, and their ms per forward (see the module
    docstring); ``stages``: also each launch's device ms by kernel name
    (``torch.profiler`` over 10 calls)."""
    import torch.nn.functional as F

    import chip_smoke as cs
    from diffphycon_tpu_torch.kernels import unet2d_blocks as kb

    kinds = ("linear_attention_block", "attention_block")
    calls = [(k, a) for k, a, _ in cs.main_path_calls(cs.DIM, cs.MULTS, cs.B) if k in kinds]
    rows = {}
    per_forward = {k: {"device_ms": 0.0, "ms": 0.0} for k in kinds}
    with torch.no_grad():
        for i, (kind, sig) in enumerate(sorted(set(calls))):
            gen = torch.Generator(device="cuda").manual_seed(i)
            if bf16act:
                fn = cs.kernel_case_bf16act(torch, F, kb, gen, kind, sig)[0]
            else:
                fn = cs.kernel_case(torch, F, kb, gen, kind, sig, bf16=bf16)[0]
            out = fn()
            torch.cuda.synchronize()
            ms, err = cs.timed_graph(torch, fn, n=20)
            if ms is None:
                raise SystemExit(f"{kind}{list(sig)}: {err}")
            pair_ms = timed(torch, fn, 50)
            n = calls.count((kind, sig))
            per_forward[kind]["device_ms"] += n * ms
            per_forward[kind]["ms"] += n * pair_ms
            row = {"calls": n, "device_ms": ms, "ms": pair_ms,
                   "digest": hashlib.sha256(out.float().cpu().numpy().tobytes()).hexdigest()[:16]}
            if stages:
                _, _, prof = cs.profile_window(torch, lambda: [fn() for _ in range(10)])
                row["device_ms_per_launch"] = {k[:80]: v / 10 for k, v in prof}
            rows[f"{kind}{list(sig)}"] = row
    return {"attention": rows, "per_forward": per_forward}


def solver_times(torch, bench) -> dict:
    """Seconds of 3 no-grad solves and 3 ``evaluate_samples`` calls at batch
    50 (each synchronised, after one untimed call of each)."""
    from diffphycon_tpu_torch.physics.burgers import burgers_solve, make_burgers_data

    cfg = bench.BurgersConfig(is_condition_u0=True, is_condition_uT=True)
    u0, f = (torch.as_tensor(a, device="cuda") for a in make_burgers_data(50, seed=0))
    with torch.no_grad():
        u_target = burgers_solve(u0, f)
    x = torch.zeros(50, cfg.pad_t, cfg.nx, 2, device="cuda")
    x[:, : cfg.nt_total, :, 0] = u_target / bench.RESCALER
    x[:, : cfg.nt_total - 1, :, 1] = f / bench.RESCALER
    out = {}
    for name, fn in (("solve_s", lambda: burgers_solve(u0, f)),
                     ("evaluate_samples_s", lambda: bench.evaluate_samples(x, u_target, cfg))):
        with torch.no_grad():
            fn()
            ts = []
            for _ in range(3):
                torch.cuda.synchronize()
                tic = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - tic)
        out[name] = ts
    return out


def two_model_times(torch, bf16: bool = False) -> dict:
    """Steps/s and peak memory of the three two-model samplers, concurrent
    and in turn (see the module docstring); ``bf16``: the nets in bf16."""
    import contextlib
    from unittest import mock

    from diffphycon_tpu_torch.benchmarks import burgers as bench
    from diffphycon_tpu_torch.benchmarks import jellyfish as jbench
    from diffphycon_tpu_torch.benchmarks import smoke as sbench
    from diffphycon_tpu_torch.diffusion import core

    def in_turn(model, x, model_w, x_w, tb):
        return model(x, tb), model_w(x_w, tb)

    def form(name):
        return (mock.patch.object(core, "two_forwards", in_turn) if name == "in_turn"
                else contextlib.nullcontext())

    def seeded(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def burgers():
        cfg = bench.BurgersConfig(is_condition_u0=True, is_condition_uT=True, bf16=bf16,
                                  impl="pallas")
        gd = bench.build_diffusion(cfg, bench.init_params(cfg, seed=0, device="cuda"),
                                   model_w=bench.init_params(cfg, seed=1, device="cuda"),
                                   device="cuda")
        u_target = torch.randn(50, 11, 128, generator=seeded(0), device="cuda")
        cond = {"u0": u_target[:, 0] / bench.RESCALER, "uT": u_target[:, 10] / bench.RESCALER}
        guidance = bench.build_guidance(cfg, u_target, wu=1000.0)
        x0, ts = gd.sample_init(50, seeded(1)), gd.sample_ts()
        return 20, lambda n: gd.sample_chunk(x0, ts[:n], cond, guidance, seeded(2))

    def smoke():
        cfg = sbench.SmokeConfig(bf16=bf16)
        gd = sbench.build_diffusion(
            cfg, sbench.init_params(cfg, seed=0, device="cuda"),
            model_w=sbench.init_params(sbench.SmokeConfig(is_w_model=True, bf16=bf16), seed=1,
                                       device="cuda"), device="cuda")
        guidance = sbench.build_guidance(cfg, device="cuda")
        cond = {"init": torch.rand(8, 64, 64, generator=seeded(3), device="cuda")}
        x0, ts = gd.sample_init(8, seeded(4)), gd.sample_ts()
        return 5, lambda n: gd.sample_chunk(x0, ts[:n], cond, guidance, seeded(5))

    def jellyfish():
        cfg = jbench.JellyfishConfig(bf16=bf16)
        gd = jbench.JellyfishDiffusion(
            cfg, jbench.build_joint_unet(cfg, seed=1, device="cuda"),
            thetas_model=jbench.build_thetas_unet(cfg, seed=2, device="cuda"),
            bd_updater=jbench.build_bd_updater(cfg, seed=3, device="cuda"), device="cuda")
        design_fn = jbench.make_force_design_fn(
            cfg, jbench.build_force_unet(cfg, seed=4, device="cuda"), gd.bd_updater, -1.0, 1.0)
        g, h = seeded(6), cfg.image_size
        s0 = torch.rand(8, h, h, cfg.n_state, generator=g, device="cuda") * 2 - 1
        b0 = torch.rand(8, h, h, 3, generator=g, device="cuda")
        th0 = torch.rand(8, generator=g, device="cuda")
        cond = gd._cond(s0, b0, th0)
        x0, ts = gd.sample_init(s0, b0, th0, generator=g), gd.sample_ts()

        def run(n):
            x, gen = x0, seeded(7)
            for t in ts[:n]:
                x = gd.step(x, t, cond, design_fn, gen)
            return x
        return 5, run

    out = {}
    for name, build in (("burgers_ddpm_b50", burgers), ("smoke_ddim_b8", smoke),
                        ("jellyfish_ddpm_b8", jellyfish)):
        n, run = build()
        with torch.no_grad():
            for f in ("concurrent", "in_turn"):  # warm-up
                with form(f):
                    run(1)
            rec = {"steps": n, "runs": []}
            outs = []
            for f in ("concurrent", "in_turn", "in_turn", "concurrent") * 2:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                with form(f):
                    tic = time.perf_counter()
                    x = run(n)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - tic
                outs.append(x)
                rec["runs"].append({
                    "form": f, "steps_per_s": n / dt,
                    "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
                    "finite": bool(torch.isfinite(x).all())})
            ref = outs[1]  # the first in-turn run
            for r, x in zip(rec["runs"], outs):
                r["equal_to_in_turn"] = bool(torch.equal(x, ref))
                r["max_abs_diff_to_in_turn"] = (x - ref).abs().max().item()
            rec["max_abs_in_turn"] = ref.abs().max().item()
        out[name] = rec
        print(json.dumps({name: rec}), flush=True)
        del run, outs, ref, x
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose diffphycon_tpu_torch is timed")
    ap.add_argument("--ddpm-only", action="store_true", help="time the guided DDPM steps alone")
    ap.add_argument("--conv-digests", action="store_true",
                    help="print K1's and K2's output digests at every signature instead")
    ap.add_argument("--two-model", action="store_true",
                    help="time the two-model samplers with concurrent and in-turn forwards")
    ap.add_argument("--solver", action="store_true",
                    help="time the no-grad Burgers solve and evaluate_samples instead")
    ap.add_argument("--attention", action="store_true",
                    help="time K5 and K6 alone at the forward's signatures instead")
    ap.add_argument("--bf16", action="store_true",
                    help="every net in bf16 (bf16 UNet2D packs, bf16 UNet3Ds)")
    ap.add_argument("--bf16act", action="store_true",
                    help="with --attention: the bf16-activation K5 and K6 (flax dtype=bf16)")
    ap.add_argument("--stages", action="store_true",
                    help="with --attention: each launch's device ms by kernel name")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)  # the kernels build, and the data cache lands, under that checkout
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from diffphycon_tpu_torch.benchmarks import burgers as bench
    from diffphycon_tpu_torch.kernels import _build
    from diffphycon_tpu_torch.kernels import attention as ka
    from diffphycon_tpu_torch.kernels import cg_pressure as kcg
    from diffphycon_tpu_torch.physics.fluids import smoke_env
    from diffphycon_tpu_torch.training import data
    from diffphycon_tpu_torch.training.trainer import Trainer, TrainerConfig

    if not Path(ka.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {ka.__file__}, not the port under {root}")
    _build.load_library()
    out = {"root": str(root), "bf16": args.bf16}
    if args.conv_digests:
        print(json.dumps({**out, **conv_digests(torch)}), flush=True)
        return 0
    if args.two_model:
        print(json.dumps({**out, "two_model": two_model_times(torch, args.bf16)}), flush=True)
        return 0
    if args.attention:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(json.dumps({**out, "nvidia_smi": smi.stdout.strip(),
                          **attention_times(torch, args.bf16, args.bf16act, args.stages)}),
              flush=True)
        return 0
    if args.solver:
        print(json.dumps({**out, **solver_times(torch, bench)}), flush=True)
        return 0
    cfg = bench.BurgersConfig(is_condition_u0=True, is_condition_uT=True, bf16=args.bf16,
                                  impl="pallas")
    net = bench.init_params(cfg, seed=0, device="cuda")
    if not args.ddpm_only:
        u, f = data.synthetic_burgers(64, seed=0, cache_dir="build/step_times/data",
                                      device="cuda")
        stacked = data.stack_burgers_uf(u, f, rescaler=bench.RESCALER)
        trainer = Trainer(bench.build_diffusion(cfg, net.train(), device="cuda"), net,
                          data.ArrayDataset(stacked).batches(16, seed=1), bench.derive_cond,
                          TrainerConfig(results_folder="build/step_times/train"), device="cuda")
        for _ in range(3):
            trainer.train_step(next(trainer.batch_iter))
        torch.cuda.synchronize()
        windows = []
        for _ in range(4):
            tic = time.perf_counter()
            for _ in range(10):
                trainer.train_step(next(trainer.batch_iter))
            torch.cuda.synchronize()
            windows.append(1e3 * (time.perf_counter() - tic) / 10)
        out["train_window_ms"] = windows
        del trainer
    net.eval()
    gen = torch.Generator(device="cuda").manual_seed(0)
    xf = torch.randn(50, cfg.pad_t, cfg.nx, 2, generator=gen, device="cuda")
    tf = torch.linspace(0, 999, 50, device="cuda")
    with torch.no_grad():
        out["forward_ms"] = timed(torch, lambda: net(xf, tf), 20)
    u_target = torch.randn(50, 11, 128, generator=gen, device="cuda")
    cond = {"u0": u_target[:, 0, :] / bench.RESCALER, "uT": u_target[:, 10, :] / bench.RESCALER}
    guidance = bench.build_guidance(cfg, u_target, wu=1000.0)
    gd = bench.build_diffusion(cfg, net, model_w=bench.init_params(cfg, seed=1, device="cuda"),
                               device="cuda")
    ts, xg = gd.sample_ts(), torch.Generator(device="cuda").manual_seed(1)
    x = gd.sample_chunk(gd.sample_init(50, xg), ts[:3], cond, guidance, xg)
    torch.cuda.synchronize()
    rates = []
    for w in range(3):
        tic = time.perf_counter()
        x = gd.sample_chunk(x, ts[3 + 20 * w:23 + 20 * w], cond, guidance, xg)
        torch.cuda.synchronize()
        rates.append(20 / (time.perf_counter() - tic))
    out["ddpm_steps_per_s"] = rates
    if not args.ddpm_only:
        c = 512
        xa = torch.randn(50, 2, 16, c, generator=gen, device="cuda")
        p = {"norm_g": 1 + 0.1 * torch.randn(c, generator=gen, device="cuda"),
             "wqkv": torch.randn(c, 384, generator=gen, device="cuda") * c ** -0.5,
             "wo": torch.randn(128, c, generator=gen, device="cuda") * 128 ** -0.5,
             "bo": 0.1 * torch.randn(c, generator=gen, device="cuda")}
        coeffs = smoke_env.smoke_domain_128().laplacian_coeffs("cuda")
        div = torch.randn(8, 127, 127, generator=gen, device="cuda")
        with torch.no_grad():
            out["k6_event_pair_ms"] = timed(torch, lambda: ka.attention_block(xa, p), 50)
            out["k6_device_ms"] = graph_ms(torch, lambda: ka.attention_block(xa, p))
            out["k4_ms"] = timed(torch, lambda: kcg.cg_pressure(div, coeffs, 1e-6, 500), 10)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
