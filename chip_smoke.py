#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``diffphycon_tpu_torch`` (never JAX) at full width on seven paths:
Burgers sampling (UNet2D dim 64, mults (1, 2, 4, 8), batch 50, input (50,
16, 128, 2)), smoke indirect control (UNet3D dim 64, mults (1, 2, 4), batch
8, input (8, 32, 64, 64, 6); 128^2 fluid solver), Burgers training (the
same UNet2D at batch 16), smoke training (the UNet3D at batch 16), the
jellyfish benchmark (UNet3Ds (16, 20, 64, 64, 7) -> 4 and 1 channels;
UNet2Dv2 / ForceUNet surrogates dim 64, mults (1, 2, 4, 8)) and the
baselines (the Burgers solver's gradient, PID, SL, BC, BPPO, SAC at the
apps' default widths; receding-horizon MPC with Adam and L-BFGS through the
jellyfish surrogates) and the RL environments (the smoke env on the real
128^2 solver, K4 in every sub-step; the jellyfish env on the surrogates).

Burgers:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compiles the CUDA kernels from ``diffphycon_tpu_torch/csrc``;
3. kernels: every hand-written kernel at every shape one UNet2D forward
   gives it (K1-K3 convs and norms, K5 at its 8 linear-attention sites, K6
   at the bottleneck), against its plain PyTorch version (max |err| <=
   KERNEL_RTOL * max(1, max |plain|)), with CUDA-event timings (one call
   per event pair) of the kernel, the plain version and the library call
   (cuDNN ``F.conv2d`` / ``F.group_norm``, TF32 off; none for K5 and K6, beside which
   ``F.scaled_dot_product_attention`` on K6's q, k, v is timed as a
   yardstick of its core), and the bound max(flops / peak, bytes / HBM
   rate). K1, K2, K5 and K6 (3xTF32 tensor cores) are bound at 3 * flops
   over the TF32 rate, with their fp32 CUDA-core bound beside it in the
   signature's line; K1 and K2 also print their tile plan (BM, BN, split-K,
   CTAs), the cuDNN call timed a second time under ``cudnn.benchmark``
   (``library_tuned_ms``), its ratios to both cuDNN times (a record, not a
   check) and, as a diagnostic, ``stream_ms``: 20 calls back to back, per
   call. K3 (one cluster launch), K5 (K5a, the merge, K5b) and K6 (K6a,
   K6b, K6c) must give bit-equal repeats; their lines add ``device_ms``, the
   device time alone (20 calls captured in a CUDA graph, its replay timed by
   two events), so that the host's share of ``ms`` stands apart; K3 prints
   its cluster size, K5 its chunk plan and head groups and its stages timed
   apart (K5a; the merge with K5b), each per event pair and on the device,
   K6 its token tile; K6 is also checked at 128 and 2048 tokens
   (``K6_EXTRA``, not part of the forward's sums);
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
   iteration counts within 2%, two solves bit-equal, the divergence left
   after projection; its cluster plan (CTAs per element, row bands, the
   clusters the card holds at each size), CUDA event times per solve, us
   per iteration and the bound for the iterations actually run; the same
   at batch 1;
7. main path: the port's ``apps/generate_smoke.py`` ``main()`` (8 test sims,
   one batch of 8, every scene accepted) and ``apps/infer_smoke.py``
   ``main()`` (two seeded UNet3Ds at full width, DDIM SMOKE_DDIM_STEPS steps
   at eta 1, calibration rows on); K4 must launch exactly 256 + 3 * 255
   times; then the UNet3D forward and one guided DDIM step at batch 8, timed,
   and a profiled evaluation rollout (K4's share of it).

Training:
8. the same UNet2D at batch 16: gradient parity, the train app (fresh,
   resumed, prior) with exact launch counts, steps/s, the infer app from
   the checkpoints, and ``--checkpoint_sweep`` over steps 10 and 20 of both
   models (a row per checkpoint, its seconds; K1-K3, K5, K6 launched).

The persistent kernel (``csrc/unet2d_persistent.cu``):
9. K7 ``resblock_pair``, the counterpart of ``scripts/bench_midgrain_pallas.py``:
   the pair at batch 50 on the four down-path pair shapes of the flagship
   UNet2D and the script's own (4, 32, 256), each launched once with the
   counters reset (5 K7 launches, nothing else); then against the plain
   pair and two K1/K3 ``resblock`` calls, timed beside them (per event pair,
   and on the device alone from a CUDA graph) and beside the pair from
   cuDNN convs and ``F.group_norm`` (TF32 off); bound at 3xTF32 for the
   convs, the fp32 bound beside it; then K7's bf16 instantiation (bf16 conv
   weights) on the same inputs: 5 launches, all bf16, against the bf16
   plain pair and two bf16 K1/K3 ResBlocks (BF16_UNET_RTOL), bit-equal
   repeats, timed beside them and a cuDNN bf16 pair, bound at 989 TFLOP/s;
10. K8 ``UNet2D.forward_mega`` at full width (batch 50): against the plain
   and the K1-K6 forwards, exactly 1 K8 launch and nothing else per
   forward, two forwards bit-equal, one CTA per SM; the kernel against its
   plain version on the same inputs, timed per event pair and on the device
   alone (CUDA graph), with its stage and barrier counts and the bound at
   3xTF32 (fp32 beside it); the 3-level and the 2-level dim-16 nets at
   batch 4 (bottlenecks of 128 and 512 tokens) through K8 and through K1-K6
   (``forward``: K6 on the bottleneck); ``forward_mega``, ``forward`` and
   ``forward_plain`` timed in one call, two ``forward_mega`` calls profiled
   and the host time of its parts; 20 guided DDPM steps at batch 50 with
   both models through ``forward_mega`` (exactly 40 K8 launches) in turns
   with 20 through K1-K6, and a profile of 3 of its steps; then the same
   net with bf16 weights (``BurgersConfig(bf16=True, impl="pallas")``, the JAX mega
   kernel's default packs): K8's bf16 instantiation, 1 launch per forward
   (a bf16 one), against the bf16 plain and K1-K6 forwards and the kernel
   against its plain version (BF16_UNET_RTOL), bit-equal repeats, timed per
   event pair and on the device beside the bound at 989 TFLOP/s, and 20
   guided DDPM steps through bf16 ``forward_mega`` (40 bf16 K8 launches) in
   turns with bf16 K1-K6.

Smoke training and jellyfish (no kernel of their own: cuDNN, TF32 off):
11. smoke training at full width: 16 train sims from ``generate_smoke``,
   ``apps/train_smoke.py`` ``main()`` for the joint (C=6, 3 steps, a
   checkpoint, resumed to 4) and the w model (C=2) at batch 16, then each
   timed through ``Trainer.train_step`` with remat off and (the w model)
   on: after each switch a warm-up step, a one-step window (ms per
   optimizer step; peak memory) and one step cut at the trainer's marks
   (forward, backward, update); the joint model's step with remat on (the
   app's default) is phase 17's fp32 turn. A micro-batch that does not fit
   is halved by gradient accumulation (``--grad_accum``) and the reason
   printed;
12. jellyfish at full width: synthetic sims (4 train, 8 test),
   ``generate_jellyfish_forces``, ``train_surrogates_jellyfish`` for the
   force, simulator and boundary-updater nets (3 steps at batch 16),
   ``train_jellyfish`` for the states (EBM, double backward) and thetas
   models at batch 16 (2 steps, then timed as in phase 11),
   ``infer_jellyfish`` at batch 8 (guided DDIM, 3 steps, closed-loop
   rollout), 3 timed guided DDIM and DDPM steps at batch 8 (the default
   1000-step run projected from them), and the EBM loss, its parameter
   gradient and one guided step at dim 16 on CUDA, with cuDNN's TF32
   switch at PyTorch's default (on), against the CPU.

The baselines (no kernel of their own: elementwise solver steps, MLPs and
1D convs in plain PyTorch, the surrogates on cuDNN, TF32 off):
13. at the apps' default widths, step, episode and iteration counts cut:
   the Burgers solver at batch 32 (Nx 128, 10 frames), forward without grad
   at dt 1e-3 (BASE_SOLVER_DTS), the SL objective's value and gradient with and
   without per-frame checkpoint (peak memory; a profile of 100 steps),
   and that objective and its gradient on CUDA against the CPU (dt 1e-3;
   BASE_CPU_RTOL, BASE_CPU_GRAD_RTOL); ``apps/train_burgers_operator.py``
   (batch 256, BASE_OP_STEPS steps, then warm ms per step and a profile);
   ``apps/eval_pid_sl_burgers.py`` for pid, sl and sl_surrogate (on that
   operator; n_test 32, BASE_OPT_STEPS Adam steps at dt 1e-3);
   ``apps/train_baselines_burgers.py`` for bc, bppo and sac (MLPs 512 x 2,
   BASE_RL_STEPS updates); ``apps/train_sac_burgers.py`` (2 episodes of 50
   updates at batch 1024); ``apps/infer_jellyfish.py --inference_method
   MPC`` at batch 8 on phase 12's surrogates over MPC_FRAMES frames
   (BASE_MPC_ITERS replanning iterations per step; objective, walltime,
   peak memory), and one
   replanning iteration at t = 0 (19 steps) timed alone (MPC_TIMED_ITERS
   times after a warm-up), projected to the
   default run (30 iterations over the shrinking horizons), one at t = 15
   (4 steps) profiled; ``--inference_method MPC_LBFGS`` over MPC_LBFGS_FRAMES
   frames and a replan at t = 0 of MPC_LBFGS_ITERS L-BFGS iterations, each
   timed with its value-and-gradient evaluations, and its peak memory;
   then one operator training step (loss, gradient) and one conv SAC update
   at batch 64 (policy loss and gradient, critic losses and gradients) on
   CUDA against the CPU, begun with cuDNN's TF32 switch at PyTorch's
   default (JELLY_CPU_RTOL, JELLY_CPU_GRAD_RTOL). Run alone
   (``chip_smoke.baselines_phase(torch, smi)``) it builds the jellyfish
   surrogates it needs.

The RL environments (``baselines/envs.py``; K4 is the smoke env's kernel):
14. one ``SmokeRLEnv`` episode of RL_ENV_FRAMES control frames at batch 2 on
   CUDA against the CPU (K4 against the plain CG, exactly 8 K4 launches a
   frame; RL_ENV_RTOL); s per control frame at batch 1 and 4, K4's share
   and the device's busy share of two profiled frames; ms per warm conv SAC
   update at batch 64; ``apps/train_baselines_smoke.py`` for bc, bppo and
   sac at the default widths with RL_SMOKE_CUT (K4 must launch once per
   sub-step of every episode); on phase 12's surrogates, s per jellyfish
   env step at batch 1 and 8, ms per warm MLP SAC update at batch 256 on
   the 28,672-wide observation, ``apps/train_baselines_jellyfish.py`` for
   bc, bppo and sac with RL_JELLY_CUT; the apps' default runs projected
   from these times. Run alone: ``chip_smoke.rl_env_phase(torch, smi)``.

The remaining modules (the last slice: no kernel of its own; K1-K3, K5, K6
carry every UNet2D forward in it):
15. at full width: 20 guided DDPM steps at batch 50 with
   the two forwards on two CUDA streams (``core.two_forwards``, the port's
   ``fuse_two_models``) in turns with the two-call step, its plain
   version, from the same x_T and noises (outputs within
   DDIM_RTOL, exact launch counts, steps/s and a 3-step profile of each);
   three post-hoc-guidance DDPM steps (``guidance_u0=False``) through the
   kernels against the plain forwards; the pred_x0 / pred_v losses at
   batch 16 through the kernels against the plain forwards; a one-rank
   NCCL group (``parallel.make_mesh``): the DDP trainer's first loss and
   gradients against the plain trainer's (GRAD_RTOL), both timed per step
   in turns, ``apps/train_burgers.py`` ``main()`` for DDP_APP_STEPS steps
   under the group, and batch-sharded guided DDIM at batch 50 against
   ``gd.sample``; a reference Trainer file round trip on CUDA; ``ks_solve``
   at batch 32 on CUDA against the CPU (KS_RTOL), timed. Run alone:
   ``chip_smoke.remaining_modules_phase`` (its docstring).

bf16 weights (the Pallas kernels' ``weight_dtype=bfloat16``; every
``*_bf16`` kernel is a bf16 variant in the same source as its fp32 one):
16. ``bf16_phase``: the bf16 variants of K1, K2, K5 and K6 at every
   signature of one UNet2D forward at batch 50 against their bf16 plain
   versions (BF16_KERNEL_RTOL), two calls bit-equal, timed per event pair
   and on the device (CUDA graph) beside the plain version, cuDNN's bf16
   conv (K1, K2) and the bound at 989 TFLOP/s, and the distance to the
   plain version on unrounded activations (K1, K2: at least
   BF16_ROUNDING_MARGIN times the distance to the bf16 plain version, so
   the kernel rounds; K5, K6: a record); the bf16 UNet2D's
   kernel forward against its plain forward (BF16_UNET_RTOL), launch
   counts (52/3/38/8/1, every K1, K2, K5 and K6 launch a bf16 one), its
   distance from the fp32 forward above BF16_GUARD, both forwards timed in
   turns; ``infer_burgers.main()`` with ``--bf16 True`` (two seeded models,
   DDIM 50, batch 50); BF16_DDPM_STEPS guided DDPM steps at batch 50, fp32
   and bf16 in turns (steps/s, busy share); one training step's loss and
   gradients at batch 16 on CUDA against the CPU, ``train_burgers.main()``
   with ``--bf16 True`` for BF16_TRAIN_STEPS steps (float32 checkpoints and
   EMA; the app trains the flax ``dtype=bf16`` net, as JAX's, whose
   train app has no ``--impl``: every launch a bf16-activation one), and ms
   per training step, bf16 and fp32 in turns. Run alone:
   ``chip_smoke.bf16_phase(torch, F, smi, chip_smoke.main_path_calls(64,
   (1, 2, 4, 8), 50))`` after ``_build.load_library()``, with
   ``torch.backends.cudnn.allow_tf32 = False``.

The UNet3D in bf16 (flax ``dtype=bf16``, bench.py's deployment dtype for
smoke and jellyfish; cuDNN bf16 convs, no kernel of its own; K4 in the
smoke rollout):
17. ``bf16_unet3d_phase`` (its docstring): the smoke and jellyfish joint
   forwards at batch 8, the smoke and EBM training steps at batch 16 (the
   train apps with ``--bf16 True``, float32 checkpoints; whether the bf16
   EBM takes batch 16 as one micro-batch) and bench.py's two bf16 profiles,
   each bf16 and fp32 in turns; a bf16 smoke step and EBM step on CUDA
   against the CPU (BF16_3D_LOSS_RTOL, BF16_3D_GRAD_RTOL); ``infer_smoke``
   and ``infer_jellyfish`` ``main()`` with ``--bf16 True``.

The flax ``dtype=bf16`` UNet2D (bf16 activations: ``BurgersConfig(bf16=
True)``, ``infer_burgers --bf16 True``, JAX's default bf16 for Burgers):
18. ``bf16act_phase`` (its docstring): the bf16-activation variants of K1,
   K2, K3, K5 and K6 at every signature of one forward at batch 50 against
   their plain versions (BF16ACT_KERNEL_RTOL), bit-equal repeats, timed per
   event pair and on the device beside the plain version, the library call
   and the bound at 2-byte activations; the net's kernel forward against its
   plain forward with its launches (52 / 3 / 38 / 8 / 1, all
   bf16-activation ones); ``infer_burgers.main()`` with ``--bf16 True`` in
   turns with ``--impl pallas --bf16 True``; guided DDPM in both bf16 modes
   in turns (steps/s, busy share, peak memory).

Then it prints the ``kernels`` JSON line (K1-K3: per-forward sums of the
phase-3 times; K4: per solve at batch 8, with its phase-14 launches beside
the smoke main path's; K7: sums over the five pair shapes;
K8: per forward at batch 50; the ``*_bf16`` records of K7 and K8 the same
with bf16 weights), and ``{"ok": true, "device": {...}}`` as the
last line.

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
TF32_PEAK = 495e12   # H100 SXM dense TF32 tensor-core FLOP/s
# K1 and K2 run 3xTF32: three TF32 products per fp32-accurate FMA
TC_KERNELS = ("conv2d_nhwc", "downsample_nhwc")
TF32X3_KERNELS = TC_KERNELS + ("linear_attention_block", "attention_block")  # at 3xTF32
# the kernels whose device time alone is measured (timed_graph) in phase 3
DEVICE_TIMED = ("group_norm_act", "linear_attention_block", "attention_block")
# K6 beside the bottleneck, checked and timed in phase 3 but not part of the
# forward's sums: the 3-level dim-16 net's 4x32 bottleneck (128 tokens) and a
# 16x128 level (2048 tokens), at batch 4 and C = 64
K6_EXTRA = ((4, 4, 32, 64), (4, 16, 128, 64))
HBM_RATE = 3.35e12   # H100 SXM HBM3 bytes/s
B = 50
TRAIN_B = 16  # the train app's default batch
SWEEP = (10, 20)  # phase 8's --checkpoint_sweep: steps both models have checkpoints at
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
    "group_norm_act": ("cuda", "diffphycon_tpu_torch/csrc/group_norm_act.cu"),
    "linear_attention_block": ("cuda", "diffphycon_tpu_torch/csrc/linear_attention_tc.cu"),
    "attention_block": ("cuda", "diffphycon_tpu_torch/csrc/attention.cu"),
}
SMOKE_SOURCES = {"cg_pressure": ("cuda", "diffphycon_tpu_torch/csrc/cg_pressure.cu")}
PERSISTENT_SRC = ("cuda", "diffphycon_tpu_torch/csrc/unet2d_persistent.cu")
PERSISTENT_BF16_SRC = "diffphycon_tpu_torch/csrc/unet2d_persistent_bf16.cu"  # its bf16 instance
REPLACES.update({
    "resblock_pair": "diffphycon_tpu/research/pallas_unet2d.py:170 (_resblock_pair_kernel; "
                     "wrapper resblock_pair :414, pallas_call through _run :360)",
    "unet2d_mega": "diffphycon_tpu/research/pallas_unet2d_mega.py:283 (unet2d_mega_apply; "
                   "pallas_call :392)",
})
# the bf16 records of K7 and K8: the JAX kernels on their bf16 weight packs
BF16_PACKS = {
    "resblock_pair_bf16": " under weight_dtype=bfloat16 (pack_unet2d_params :665)",
    "unet2d_mega_bf16": " on bf16 packs (pack_unet2d_mega, weight_dtype=bfloat16 by default :72)",
}
JELLY_TRAIN_SIMS, JELLY_TEST_SIMS, JELLY_B = 4, 8, 8
JELLY_DDIM_STEPS = 3
# CUDA against the CPU on one EBM loss, its parameter gradient and one guided
# DDPM step (dim 16, batch 2, 8 frames of 32x32, fixed draws): fp32 on both
# (TF32 off) differs in summation order only, ~1e-6 relative in a forward.
# With the nets' TF32 switch left on (an H100, dim 16, these inputs) the
# errors were 3.2e-5 in the loss, 2.2e-4 in the gradient (of a 0.47 maximum)
# and 1.2e-3 in the step; in fp32 9e-8, 7e-7 and 2.5e-6. The limits sit
# between: each of the three catches a TF32 conv. The gradient is second
# order (the backward of a backward), so it gets 10x more room.
JELLY_CPU_RTOL = 1e-5
JELLY_CPU_GRAD_RTOL = 1e-4
# phase 13 (baselines): the apps' default widths (Nx 128, 10 frames, MLPs
# of 512 x 2, the operator at s = s_ob = 128, the jellyfish surrogates of
# phase 12 at batch 8); step, episode and iteration counts cut
BASE_B = 32          # the solver batch and eval_pid_sl_burgers' default n_test
BASE_OP_STEPS = 50   # train_burgers_operator steps at its batch 256
BASE_OPT_STEPS = 10  # PID / SL / SL-surrogate Adam steps
BASE_RL_STEPS = {"bc_steps": 50, "critic_steps": 50, "bppo_steps": 20, "sac_steps": 50}
BASE_MPC_ITERS = 1   # replanning iterations per real step (default 30)
# the solver's timed step sizes: dt 1e-3 only (dt 1e-4, ten times the
# steps at the same us per step, gave way to phase 18's time)
BASE_SOLVER_DTS = (1e-3,)
MPC_FRAMES = 2       # the MPC app run's frames (default 20; the timed iteration plans 19 steps)
MPC_LBFGS_FRAMES = 2  # the MPC_LBFGS app run's frames (default 20)
MPC_LBFGS_ITERS = 1   # timed L-BFGS iterations of the replan at t = 0
MPC_TIMED_ITERS = 2   # timed Adam replanning iterations at t = 0 (their larger is kept)
RL_SAC_B = 64         # train_baselines_smoke's default batch (the conv SAC)
# phase 14 (RL envs and apps): the apps' default widths, counts cut. The
# smoke app's sac runs one round (2 online episodes, 64 updates)
RL_SMOKE_CUT = {"n_episodes": 1, "bc_steps": 20, "critic_steps": 20, "bppo_steps": 10,
                "sac_steps": 64}
RL_JELLY_CUT = {"bc_steps": 20, "critic_steps": 20, "bppo_steps": 10, "sac_steps": 80}
RL_ENV_FRAMES = 3  # the smoke env's CUDA-against-CPU episode
# that episode's observations, rewards and metrics: each of its 24 pressure
# solves stops at max |residual| < 1e-6 on both sides, after iteration
# counts that may differ by a few (summation order, CG_ITER_RTOL), as in
# phase 6, where one solve agrees with the plain CG to KERNEL_RTOL
RL_ENV_RTOL = 1e-4
# the SL objective and its gradient on CUDA against the CPU (batch 32, dt
# 1e-3, 1000 steps): both are float32 elementwise ops in one order, ~1e-7
# relative a step; a wrong or missing term moves the objective by O(1) and
# the gradient by O(max |g|)
BASE_CPU_RTOL = 1e-5
BASE_CPU_GRAD_RTOL = 1e-4
# the down-path pair shapes of the flagship UNet2D, then the JAX bench
# script's level2 (4, 32, 256)
PAIR_SHAPES = ((16, 128, 64), (8, 64, 64), (4, 32, 128), (2, 16, 256), (4, 32, 256))


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


def expected_counts(calls, bf16=False, bf16act=False):
    """The launch counters of one forward of ``calls``; ``bf16``: with
    bfloat16 weights, every K1, K2, K5 and K6 launch is a bf16 variant's;
    ``bf16act``: with bfloat16 activations (flax ``dtype=bfloat16``), every
    K1, K2, K3, K5 and K6 launch is a bf16-activation variant's."""
    conv = [a for k, a, _ in calls if k == "conv2d_nhwc"]
    counts = {
        "conv2d_nhwc": len(conv),
        "conv2d_nhwc.dual": sum(a[4] > 0 for a in conv),
        "conv2d_nhwc.upsample": sum(a[7] for a in conv),
        "downsample_nhwc": sum(k == "downsample_nhwc" for k, _, _ in calls),
        "group_norm_act": sum(k == "group_norm_act" for k, _, _ in calls),
        "linear_attention_block": sum(k == "linear_attention_block" for k, _, _ in calls),
        "attention_block": sum(k == "attention_block" for k, _, _ in calls),
        "resblock_pair": 0,  # the per-block forward launches no persistent kernel
        "resblock_pair.bf16": 0,
        "unet2d_mega": 0,
        "unet2d_mega.bf16": 0,
    }
    for k in BF16_KERNELS:
        counts[f"{k}.bf16"] = counts[k] if bf16 else 0
    for k in BF16ACT_KERNELS:
        counts[f"{k}.bf16act"] = counts[k] if bf16act else 0
    return counts


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


def timed_stream(torch, fn, n=20, warm=3):
    """Mean ms of n calls enqueued back to back between two CUDA events: the
    device time once the host's enqueue overlaps the previous call (timed()
    also counts the wrapper's host time while the card waits for it)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def timed_graph(torch, fn, n=20):
    """(device ms per call, None) with n calls of fn captured in one CUDA
    graph and its replay timed between two events: the device's time alone,
    without the host's launch path; (None, the error) if the capture fails
    (a diagnostic, not a check)."""
    try:
        fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        ts = []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) / n)
        del graph
        return sorted(ts)[1], None
    except Exception as e:  # noqa: BLE001 (a diagnostic: record why and go on)
        torch.cuda.synchronize()
        return None, f"{type(e).__name__}: {e}"[:200]


def timed_tuned(torch, fn, n=20):
    """timed() with cuDNN's autotuner on (cudnn.benchmark), restored after."""
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        return timed(torch, fn, n=n)
    finally:
        torch.backends.cudnn.benchmark = prev


def bound(flops, nbytes, peak=FP32_PEAK):
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kernel_bound(kname, flops, nbytes):
    """(bound ms, bound by, ms of the operations alone) of one launch: K1,
    K2 and K5 at the 3xTF32 tensor-core rate, the others at fp32."""
    if kname in TF32X3_KERNELS:
        return (*bound(3 * flops, nbytes, TF32_PEAK), 1e3 * 3 * flops / TF32_PEAK)
    return (*bound(flops, nbytes), 1e3 * flops / FP32_PEAK)


def gemm_dims(kname, args):
    """(m, n, k) of the implicit GEMM of one K1 or K2 signature."""
    if kname == "conv2d_nhwc":
        b_, h, w, ca, cb, co, k, up = args
        return b_ * h * w * (4 if up else 1), co, k * k * (ca + cb)
    b_, h, w, c, co = args
    return b_ * (h // 2) * (w // 2), co, 4 * c


def attention_flops(kind, b_, n, c):
    """FLOPs of one attention block: the qkv projection, the out-projection,
    the per-head products (linear: k v^T and context^T q, 32x32 per token;
    full: q k^T and P v, n per token) and ~10 per element of the norms and
    softmaxes."""
    hidden = HEADS * DIM_HEAD
    proj = 2 * n * c * 3 * hidden + 2 * n * hidden * c
    core = 2 * 2 * n * HEADS * DIM_HEAD * (DIM_HEAD if kind == "linear_attention_block" else n)
    return b_ * (proj + core + 10 * n * (2 * c + hidden))


def kernel_case(torch, F, kb, gen, kind, args, bf16=False):
    """(kernel fn, plain fn, library fn or None, flops, bytes, extra timings)
    at one signature. ``bf16``: the matmul weights rounded to bfloat16 (the
    bf16 variants; weight bytes at 2 each), the library call cuDNN's bf16
    conv on operands cast outside the timing, and extra["unrounded"] the
    plain version on the float32 activation with the same weights (what a
    kernel that forgot to round would give)."""
    dev = "cuda"
    wdt = torch.bfloat16 if bf16 else torch.float32
    wsize = 2 if bf16 else 4

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + shift

    if kind in ("linear_attention_block", "attention_block"):
        from diffphycon_tpu_torch.kernels import attention as ka

        b_, h, w, c = args
        hidden = HEADS * DIM_HEAD
        x = rnd(b_, h, w, c, scale=2.0, shift=0.3)
        p = {"norm_g": rnd(c, scale=0.1, shift=1.0),
             "wqkv": rnd(c, 3 * hidden, scale=c ** -0.5).to(wdt),
             "wo": rnd(hidden, c, scale=hidden ** -0.5).to(wdt), "bo": rnd(c, scale=0.1)}
        linear = kind == "linear_attention_block"
        if linear:
            p["out_g"] = rnd(c, scale=0.1, shift=1.0)
        kern = ka.linear_attention_block if linear else ka.attention_block
        plain = ka.linear_attention_block_plain if linear else ka.attention_block_plain
        n = h * w
        nbytes = 4 * (2 * x.numel() + 3 * c) + wsize * (c * 3 * hidden + hidden * c)
        extra = {}
        if bf16:
            p32 = {**p, "wqkv": p["wqkv"].float(), "wo": p["wo"].float()}
            extra["unrounded"] = lambda: plain(x, p32)
        if linear:  # the stages apart: K5a, then the merge with K5b
            extra["k5a"], extra["k5b"] = ka.linear_attention_stages(x, p)
        else:  # yardstick of the core: SDPA on this block's q, k, v
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
        wt = rnd(k * k * ci, co, scale=1.0 / math.sqrt(k * k * ci)).to(wdt)
        bias = rnd(co, scale=0.1)
        # cuDNN on its NCHW layout (the transposes, and the bf16 casts, are
        # made outside the timing; the concat and the upsample are timed)
        w_lib = wt.reshape(k, k, ci, co).permute(3, 2, 0, 1).contiguous()
        xa_l = xa.permute(0, 3, 1, 2).contiguous().to(wdt)
        xb_l = xb.permute(0, 3, 1, 2).contiguous().to(wdt) if cb else None
        b_lib = bias.to(wdt)

        def library():
            x = xa_l if xb_l is None else torch.cat([xa_l, xb_l], dim=1)
            if up:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            return F.conv2d(x, w_lib, b_lib, padding=k // 2)

        ho, wo = (2 * h, 2 * w) if up else (h, w)
        flops = 2 * b_ * ho * wo * co * k * k * ci
        nbytes = (4 * (xa.numel() + (xb.numel() if cb else 0) + co + b_ * ho * wo * co)
                  + wsize * wt.numel())
        extra = {"unrounded": lambda: kb.conv2d_nhwc_plain(xa, wt.float(), bias, x_b=xb, k=k,
                                                           upsample=up)} if bf16 else {}
        return (lambda: kb.conv2d_nhwc(xa, wt, bias, x_b=xb, k=k, upsample=up),
                lambda: kb.conv2d_nhwc_plain(xa, wt, bias, x_b=xb, k=k, upsample=up),
                library, flops, nbytes, extra)
    if kind == "downsample_nhwc":
        b_, h, w, c, co = args
        x = rnd(b_, h, w, c)
        wt = rnd(4 * c, co, scale=1.0 / math.sqrt(4 * c)).to(wdt)
        bias = rnd(co, scale=0.1)
        w_lib = wt.reshape(2, 2, c, co).permute(3, 2, 0, 1).contiguous()
        x_l = x.permute(0, 3, 1, 2).contiguous().to(wdt)
        b_lib = bias.to(wdt)
        flops = 2 * b_ * (h // 2) * (w // 2) * co * 4 * c
        nbytes = 4 * (x.numel() + co + b_ * (h // 2) * (w // 2) * co) + wsize * wt.numel()
        extra = {"unrounded": lambda: kb.downsample_nhwc_plain(x, wt.float(), bias)
                 } if bf16 else {}
        return (lambda: kb.downsample_nhwc(x, wt, bias),
                lambda: kb.downsample_nhwc_plain(x, wt, bias),
                lambda: F.conv2d(x_l, w_lib, b_lib, stride=2),
                flops, nbytes, extra)
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


def rollout_divergence(torch, batch=SMOKE_B):
    """(sim, staggered velocity (B, 129, 129, 2), its divergence (B, 127,
    127)) of a carry-over step of a seeded generator rollout on the smoke
    domain: the right-hand sides K4 solves on the smoke path."""
    import numpy as np

    from diffphycon_tpu_torch.apps.generate_smoke import sample_waypoints, segment_schedule
    from diffphycon_tpu_torch.physics.fluids import grids
    from diffphycon_tpu_torch.physics.fluids import smoke_env

    sim = smoke_env.SmokeSim.create(accuracy=1e-6, max_iterations=500, device="cuda")
    rng = np.random.default_rng(0)
    dens0 = np.zeros((batch, 128, 128), np.float32)
    seg_v = np.zeros((batch, 4, 2), np.float32)
    seg_starts = np.zeros((batch, 4), np.int32)
    for j in range(batch):
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
    return sim, stag, div


def smoke_kernel_phase(torch, smi_line):
    """Phase 6: K4 against its plain version on real rollout divergences, at
    batch 8 and at batch 1."""
    from diffphycon_tpu_torch.kernels import cg_pressure as kcg
    from diffphycon_tpu_torch.physics.fluids import grids
    from diffphycon_tpu_torch.physics.fluids import smoke_env

    t0 = time.time()
    sim, stag, div = rollout_divergence(torch)
    coeffs, acc, maxit = sim.coeffs, 1e-6, 500
    with torch.no_grad():
        p, iters = kcg.cg_pressure(div, coeffs, acc, maxit)
        p_plain, iters_plain = kcg.cg_pressure_plain(div, coeffs, acc, maxit)
        p2, iters2 = kcg.cg_pressure(div, coeffs, acc, maxit)
        torch.cuda.synchronize()
        bit_equal = torch.equal(p, p2) and torch.equal(iters, iters2)
        err = (p - p_plain).abs().max().item()
        tol = KERNEL_RTOL * max(1.0, p_plain.abs().max().item())
        iter_gap = (iters - iters_plain).abs().float() / iters_plain.float().clamp(min=1)
        projected = stag - grids.staggered_gradient(p[..., None]) * sim.velocity_mask[None]
        active = torch.as_tensor(smoke_env.smoke_domain_128().active, device="cuda")
        div_after = (grids.staggered_divergence(projected)[..., 0] * active)[:, 1:-1, 1:-1]
        ms = timed(torch, lambda: kcg.cg_pressure(div, coeffs, acc, maxit), n=10, warm=2)
        plain_ms = timed(torch, lambda: kcg.cg_pressure_plain(div, coeffs, acc, maxit),
                         n=3, warm=1)
        # batch 1: one cluster on the card
        div1 = div[:1].contiguous()
        p1, iters1 = kcg.cg_pressure(div1, coeffs, acc, maxit)
        err1 = (p1 - p_plain[:1]).abs().max().item()
        tol1 = KERNEL_RTOL * max(1.0, p_plain[:1].abs().max().item())
        ms1 = timed(torch, lambda: kcg.cg_pressure(div1, coeffs, acc, maxit), n=10, warm=2)
    H, W = div.shape[1:]
    plan, plan1 = kcg._plan(SMOKE_B, H, W), kcg._plan(1, H, W)
    n_cells = H * W
    total_iters = int(iters.sum().item())
    flops = CG_FLOPS_PER_CELL * n_cells * (total_iters + SMOKE_B)
    nbytes = 4 * (2 * div.numel() + 5 * n_cells + SMOKE_B)  # div, coeffs in; p, iters out
    b_ms, b_by = bound(flops, nbytes)
    us_it = 1e3 * ms / iters.max().item()
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": None, "cluster": plan.cluster,
           "us_per_iteration": us_it}
    emit({"phase": "cg_kernel", "batch": SMOKE_B, "grid": [H, W],
          "accuracy": acc, "iterations": iters.tolist(),
          "plain_iterations": iters_plain.tolist(), "max_iter_gap": iter_gap.max().item(),
          "tol": tol, "bit_equal_repeat": bit_equal,
          "plan": {"cluster": plan.cluster, "bands": plan.bands, "waves": plan.waves,
                   "resident_clusters": {S: kcg._resident(H, W, S) for S in kcg.CG_CLUSTERS}},
          "max_div_after_projection": div_after.abs().max().item(),
          "max_div_before": div.abs().max().item(), "gflop": flops / 1e9,
          "mbytes": nbytes / 1e6,
          "batch_1": {"cluster": plan1.cluster, "ms": ms1, "iterations": iters1.tolist(),
                      "us_per_iteration": 1e3 * ms1 / max(1, iters1.max().item()),
                      "max_abs_err": err1, "tol": tol1},
          "nvidia_smi": smi_line, "seconds": round(time.time() - t0, 3), **row})
    if not (err <= tol and err1 <= tol1):
        fail(f"K4 differs from its plain version: {err} > {tol} or {err1} > {tol1} (batch 1)")
    gap1 = abs(int(iters1[0]) - int(iters_plain[0])) / max(1, int(iters_plain[0]))
    if not (iter_gap.max().item() <= CG_ITER_RTOL and gap1 <= CG_ITER_RTOL):
        fail(f"K4 iteration counts {iters.tolist()} (batch 1: {iters1.tolist()}) vs plain "
             f"{iters_plain.tolist()}")
    if not bit_equal:
        fail("two K4 solves are not bit-equal")
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
        cg_ms = sum(v for k, v in rows if "cg_cluster_kernel" in k)
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
    checkpoints and over a sweep of two. per_forward: the kernel launches
    of one UNet2D forward."""
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
            ("prior", ["--train_num_steps", "20", "--is_model_w", "True"], "burgers_w", 20, 20)]
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
    # host-bound, so its time varies between windows)
    t0 = time.time()
    trainer = Trainer(gd_k, net, data.ArrayDataset(stacked).batches(TRAIN_B, seed=1),
                      bench.derive_cond,
                      TrainerConfig(results_folder=os.path.join(work, "train_timing")),
                      device=device)
    n_windows, n_steps = 2, 10
    tm = _step_timing(torch, trainer,
                      lambda: torch.as_tensor(next(trainer.batch_iter), device=device),
                      3, n_windows, n_steps)

    wall_ms, dev_ms, rows = profile_window(
        torch, lambda: trainer.train_step(next(trainer.batch_iter)))
    emit({"phase": "train_timing", "batch": TRAIN_B, "steps_timed": n_windows * n_steps,
          "window_ms_per_step": tm["window_ms_per_step"], "ms_per_step": tm["ms_per_step"],
          "optimizer_steps_per_sec": 1e3 / tm["ms_per_step"],
          "window_spread": tm["window_spread"],
          "peak_memory_gb": tm["peak_memory_gb"],
          "profile": {"steps": 1, "wall_ms": wall_ms, "device_ms": dev_ms,
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

    # 8e. --checkpoint_sweep over steps 10 and 20 of both models
    t0 = time.time()
    args = infer_burgers.build_parser().parse_args(width + [
        "--model_root", models, "--exp_id", "smoke", "--checkpoint_sweep", *map(str, SWEEP),
        "--synthetic_data", str(B), "--n_test_samples", str(B), "--batch_size", str(B),
        "--eval_two_models", "True", "--wus", "1000", "--is_condition_u0", "True",
        "--is_condition_uT", "True", "--using_ddim", "True", "--ddim_sampling_steps", "10",
        "--data_root", data_root, "--save_file", os.path.join(work, "result_sweep.json")])
    kb.reset_launch_counts()
    rows = infer_burgers.main(args)
    torch.cuda.synchronize()
    counts = kb.launch_counts()
    want = [f"ckpt={k},wu=1000.0,wf=0.0" for k in SWEEP]
    emit({"phase": "checkpoint_sweep", "app": "diffphycon_tpu_torch/apps/infer_burgers.py",
          "checkpoints": {"burgers/smoke": SWEEP, "burgers_w/smoke": SWEEP},
          "sampler": "ddim 10 steps, eta 0, two models, wu=1000, batch 50", "rows": rows,
          "s_per_checkpoint": [rows[k]["walltime_s"] for k in want if k in rows],
          "launches": counts, "nvidia_smi": smi_line, "seconds": round(time.time() - t0, 3)})
    if list(rows) != want or not all(math.isfinite(v) for r in rows.values()
                                     for v in r.values()):
        fail(f"checkpoint sweep: rows {list(rows)} (want {want}) or non-finite metrics")
    if json.load(open(os.path.join(work, "result_sweep.json"))) != rows:
        fail("checkpoint sweep: the save file differs from the returned rows")
    if not all(counts[k] > 0 for k in SOURCES):
        fail(f"checkpoint sweep: a kernel of K1-K3, K5, K6 was not launched: {counts}")


def _res_pack(torch, gen, c):
    """Seeded ResBlock weights of one equal-channel block (kernel layout)."""
    def r(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale + shift

    return {"w1": r(9 * c, c, scale=(9 * c) ** -0.5), "b1": r(c, scale=0.1),
            "gs1": r(c, scale=0.1, shift=1.0), "gb1": r(c, scale=0.1),
            "w2": r(9 * c, c, scale=(9 * c) ** -0.5), "b2": r(c, scale=0.1),
            "gs2": r(c, scale=0.1, shift=1.0), "gb2": r(c, scale=0.1)}


def _pair_library(torch, F, kb, x, ss_a, ss_b, p_a, p_b):
    """The pair from cuDNN convs (TF32 off) and F.group_norm on NCHW: the
    library yardstick (weights and the input transposed outside the timing).
    bf16 conv weights: cuDNN's bf16 conv on the activation cast to bf16,
    its output back to float32."""
    c = x.shape[-1]

    def nchw_w(w):
        return w.reshape(3, 3, c, c).permute(3, 2, 0, 1).contiguous()

    def conv(h, w, b):
        return F.conv2d(h.to(w.dtype), w, b.to(w.dtype), padding=1).float()

    blocks = [(ss, p, nchw_w(p["w1"]), nchw_w(p["w2"])) for ss, p in ((ss_a, p_a), (ss_b, p_b))]
    x_l = x.permute(0, 3, 1, 2).contiguous()

    def run():
        h_in = x_l
        for ss, p, w1, w2 in blocks:
            h = F.group_norm(conv(h_in, w1, p["b1"]), 1, p["gs1"], p["gb1"], eps=kb.GN_EPS)
            h = F.silu(h * (ss[:, :c, None, None] + 1.0) + ss[:, c:, None, None])
            h = F.group_norm(conv(h, w2, p["b2"]), 1, p["gs2"], p["gb2"], eps=kb.GN_EPS)
            h_in = F.silu(h) + h_in
        return h_in

    return run


def resblock_pair_phase(torch, F, smi_line):
    """Phase 9: K7 at the pair shapes, against the plain pair and two
    K1/K3 ResBlocks; then K7's bf16 instantiation on the same inputs with
    bf16 conv weights (:func:`_pair_bf16`). Returns the kernels line's K7
    records, fp32 and bf16."""
    from diffphycon_tpu_torch.kernels import unet2d_blocks as kb

    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(9)
    cases = []
    for h, w, c in PAIR_SHAPES:
        x = torch.randn(B, h, w, c, generator=gen, device="cuda")
        ss_a = 0.5 * torch.randn(B, 2 * c, generator=gen, device="cuda")
        ss_b = 0.5 * torch.randn(B, 2 * c, generator=gen, device="cuda")
        cases.append((x, ss_a, ss_b, _res_pack(torch, gen, c), _res_pack(torch, gen, c)))
    with torch.no_grad():
        kb.reset_launch_counts()  # the path: the bench script's pair at each shape, once
        outs = [kb.resblock_pair(*case) for case in cases]
        torch.cuda.synchronize()
        counts = kb.launch_counts()
        want = {k: 0 for k in counts}
        want["resblock_pair"] = len(PAIR_SHAPES)
        rows, bad = [], []
        for (h, w, c), case, out in zip(PAIR_SHAPES, cases, outs):
            x, ss_a, ss_b, p_a, p_b = case
            plain = kb.resblock_pair_plain(*case)
            two = kb.resblock(kb.resblock(x, ss_a, p_a), ss_b, p_b)
            library = _pair_library(torch, F, kb, *case)
            tol = KERNEL_RTOL * max(1.0, plain.abs().max().item())
            err = (out - plain).abs().max().item()
            err_two = (out - two).abs().max().item()
            repeat_equal = torch.equal(out, kb.resblock_pair(*case))
            ms = timed(torch, lambda: kb.resblock_pair(*case), n=10)
            two_ms = timed(torch, lambda: kb.resblock(kb.resblock(x, ss_a, p_a), ss_b, p_b),
                           n=10)
            plain_ms = timed(torch, lambda: kb.resblock_pair_plain(*case), n=5)
            lib_ms = timed(torch, library, n=10)
            device_ms, _ = timed_graph(torch, lambda: kb.resblock_pair(*case), n=10)
            two_device_ms, _ = timed_graph(
                torch, lambda: kb.resblock(kb.resblock(x, ss_a, p_a), ss_b, p_b), n=10)
            m = B * h * w
            # 4 convs (3xTF32 on the tensor cores); per element GN (two
            # passes) + affine + FiLM / residual + SiLU ~16
            conv_flops, other_flops = 4 * 2 * m * c * 9 * c, 4 * 16 * m * c
            flops = conv_flops + other_flops
            nbytes = 4 * (2 * m * c + 2 * (2 * 9 * c * c + 6 * c) + 2 * 2 * B * c)
            ops_ms = 1e3 * (3 * conv_flops / TF32_PEAK + other_flops / FP32_PEAK)
            bytes_ms = 1e3 * nbytes / HBM_RATE
            b_ms, b_by = max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"
            row = {"shape": [B, h, w, c], "max_abs_err": err, "max_abs_err_vs_two_resblocks":
                   err_two, "tol": tol, "repeat_bit_equal": repeat_equal, "ms": ms,
                   "device_ms": device_ms, "two_resblock_ms": two_ms,
                   "two_resblock_device_ms": two_device_ms,
                   "not_slower_than_two_resblocks": ms <= two_ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": b_ms, "bound_by": b_by, "bound_fp32_ms": bound(flops, nbytes)[0],
                   "gflop": flops / 1e9}
            rows.append(row)
            emit({"phase": "resblock_pair", **row})
            if not (err <= tol and err_two <= tol and repeat_equal):
                bad.append(row)
            del plain, two
    emit({"phase": "resblock_pair_checked", "launches": counts, "expected": want,
          "nvidia_smi": smi_line, "seconds": round(time.time() - t0, 3)})
    if bad:
        fail(f"K7 differs from the plain pair or from two ResBlocks: {bad}")
    if counts != want:
        fail(f"K7 path launches {counts} != {want}")
    agg = {"launches": counts["resblock_pair"],
           "max_abs_err": max(r["max_abs_err"] for r in rows)}
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "two_resblock_ms"):
        agg[key] = sum(r[key] for r in rows)
    dev = [r["device_ms"] for r in rows]
    agg["device_ms"] = None if None in dev else sum(dev)
    agg["bound_by"] = "operations" if all(r["bound_by"] == "operations" for r in rows) \
        else "bytes"
    return {"resblock_pair": agg, "resblock_pair_bf16": _pair_bf16(torch, F, kb, cases,
                                                                   smi_line)}


def _bf16_pair_pack(torch, p):
    return {k: v.to(torch.bfloat16) if k in ("w1", "w2") else v for k, v in p.items()}


def _pair_bf16(torch, F, kb, cases, smi_line):
    """Phase 9, bf16: K7 with bf16 conv weights (its bf16 instantiation) at
    the five pair shapes, each launched once with the counters reset (5 K7
    launches, all bf16, nothing else), against the bf16 plain pair
    (BF16_UNET_RTOL: rounding flips cascade through two GroupNorms) and two
    bf16 K1/K3 ResBlocks, bit-equal repeats; timed beside them and the pair
    from cuDNN bf16 convs; bound at the bf16 rate."""
    t0 = time.time()
    cases = [(x, ss_a, ss_b, _bf16_pair_pack(torch, p_a), _bf16_pair_pack(torch, p_b))
             for x, ss_a, ss_b, p_a, p_b in cases]
    with torch.no_grad():
        kb.reset_launch_counts()
        outs = [kb.resblock_pair(*case) for case in cases]
        torch.cuda.synchronize()
        counts = kb.launch_counts()
        want = {k: 0 for k in counts}
        want["resblock_pair"] = want["resblock_pair.bf16"] = len(PAIR_SHAPES)
        rows, bad = [], []
        for (h, w, c), case, out in zip(PAIR_SHAPES, cases, outs):
            x, ss_a, ss_b, p_a, p_b = case
            plain = kb.resblock_pair_plain(*case)
            two = kb.resblock(kb.resblock(x, ss_a, p_a), ss_b, p_b)
            scale = max(1.0, plain.abs().max().item())
            err = (out - plain).abs().max().item()
            err_two = (out - two).abs().max().item()
            repeat_equal = torch.equal(out, kb.resblock_pair(*case))
            ms = timed(torch, lambda: kb.resblock_pair(*case), n=10)
            two_ms = timed(torch, lambda: kb.resblock(kb.resblock(x, ss_a, p_a), ss_b, p_b),
                           n=10)
            plain_ms = timed(torch, lambda: kb.resblock_pair_plain(*case), n=5)
            lib_ms = timed(torch, _pair_library(torch, F, kb, *case), n=10)
            device_ms, _ = timed_graph(torch, lambda: kb.resblock_pair(*case), n=10)
            m = B * h * w
            conv_flops, other_flops = 4 * 2 * m * c * 9 * c, 4 * 16 * m * c
            nbytes = 4 * (2 * m * c + 2 * 6 * c + 2 * 2 * B * c) + 2 * 2 * 9 * c * c * 2
            ops_ms = 1e3 * (conv_flops / BF16_PEAK + other_flops / FP32_PEAK)
            bytes_ms = 1e3 * nbytes / HBM_RATE
            row = {"shape": [B, h, w, c], "max_abs_err": err, "rel_err": err / scale,
                   "rel_err_vs_two_resblocks": err_two / scale, "tol_rel": BF16_UNET_RTOL,
                   "repeat_bit_equal": repeat_equal, "ms": ms, "device_ms": device_ms,
                   "two_resblock_ms": two_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": max(ops_ms, bytes_ms),
                   "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
            rows.append(row)
            emit({"phase": "resblock_pair_bf16", **row})
            if not (err <= BF16_UNET_RTOL * scale and err_two <= BF16_UNET_RTOL * scale
                    and repeat_equal):
                bad.append(row)
            del plain, two
    emit({"phase": "resblock_pair_bf16_checked", "launches": counts, "expected": want,
          "nvidia_smi": smi_line, "seconds": round(time.time() - t0, 3)})
    if bad:
        fail(f"bf16 K7 differs from the bf16 plain pair or from two ResBlocks: {bad}")
    if counts != want:
        fail(f"bf16 K7 path launches {counts} != {want}")
    agg = {"launches": counts["resblock_pair.bf16"],
           "max_abs_err": max(r["max_abs_err"] for r in rows)}
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "two_resblock_ms"):
        agg[key] = sum(r[key] for r in rows)
    dev = [r["device_ms"] for r in rows]
    agg["device_ms"] = None if None in dev else sum(dev)
    agg["bound_by"] = "operations" if all(r["bound_by"] == "operations" for r in rows) \
        else "bytes"
    return agg


def unet2d_mega_phase(torch, smi_line, bench, cfg):
    """Phase 10: K8 through UNet2D.forward_mega at full width, its checks,
    timings and 20 guided DDPM steps through it; then K8's bf16
    instantiation (:func:`_mega_bf16`). Returns the kernels line's K8
    records, fp32 and bf16."""
    from torch.utils.flop_counter import FlopCounterMode

    from diffphycon_tpu_torch.kernels import unet2d_blocks as kb
    from diffphycon_tpu_torch.kernels import unet2d_mega as kmega
    from diffphycon_tpu_torch.nets import unet2d as tunet
    from diffphycon_tpu_torch.nets.init import seeded_init_

    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(10)
    net = bench.init_params(cfg, seed=0, device="cuda")
    net_w = bench.init_params(cfg, seed=1, device="cuda")
    x = torch.randn(B, cfg.pad_t, cfg.nx, 2, generator=gen, device="cuda")
    t = torch.linspace(0, 999, B, device="cuda")
    with torch.no_grad():
        kb.reset_launch_counts()
        out = net.forward_mega(x, t)
        torch.cuda.synchronize()
        counts = kb.launch_counts()
        want = {k: 0 for k in counts}
        want["unet2d_mega"] = 1
        bit_equal = torch.equal(out, net.forward_mega(x, t))
        ref_plain = net.forward_plain(x, t)
        ref_k = net(x, t)
        tol = KERNEL_RTOL * max(1.0, ref_plain.abs().max().item())
        err_plain = (out - ref_plain).abs().max().item()
        err_k = (out - ref_k).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        del ref_plain, ref_k

        # the kernel alone, on the inputs forward_mega gives it
        packs = net._kernel_pack()
        film = net._film(t, packs)
        x0 = tunet._conv_nchw(x, net.init_conv)
        plan = kmega.mega_plan(packs, x0.shape, net.groups, HEADS, DIM_HEAD, x0.device)
        k_out = kmega.unet2d_mega(x0, film, packs, plan)
        k_ref = kmega.unet2d_mega_plain(x0, film, packs, plan)
        k_err = (k_out - k_ref).abs().max().item()
        k_tol = KERNEL_RTOL * max(1.0, k_ref.abs().max().item())
        with FlopCounterMode(display=False) as counter:
            kmega.unet2d_mega_plain(x0, film, packs, plan)
        weights = {id(s.ptrs[k]): s.ptrs[k] for s in plan.stages for k in s.ptrs
                   if isinstance(s.ptrs[k], torch.Tensor)}
        nbytes = 4 * (sum(w.numel() for w in weights.values()) + x0.numel() + film.numel()
                      + k_out.numel())
        flops = counter.get_total_flops()
        # the convs (~97% of the flops) and the attention projections run
        # 3xTF32 on the tensor cores: bound at 3 TF32 products per FMA, the
        # fp32 CUDA-core bound beside it
        b_ms, b_by = bound(3 * flops, nbytes, TF32_PEAK)
        b_fp32_ms = bound(flops, nbytes)[0]
        del k_out, k_ref
        k_ms = timed(torch, lambda: kmega.unet2d_mega(x0, film, packs, plan), n=10)
        k_plain_ms = timed(torch, lambda: kmega.unet2d_mega_plain(x0, film, packs, plan), n=5)
        mega_fwd_ms = timed(torch, lambda: net.forward_mega(x, t), n=10)
        fwd_ms = timed(torch, lambda: net(x, t), n=10)
        plain_fwd_ms = timed(torch, lambda: net.forward_plain(x, t), n=5)
        mega_fwd_ms_2 = timed(torch, lambda: net.forward_mega(x, t), n=10)
        prof_wall, prof_dev, prof_rows = profile_window(
            torch, lambda: [net.forward_mega(x, t) for _ in range(2)])
        # host time to enqueue one forward_mega, and its parts (no sync inside)
        torch.cuda.synchronize()
        tic = time.perf_counter()
        net.forward_mega(x, t)
        enqueue_ms = 1e3 * (time.perf_counter() - tic)
        torch.cuda.synchronize()
        host = {}
        for name, fn in (("pack", net._kernel_pack), ("film", lambda: net._film(t, packs)),
                         ("init_conv", lambda: tunet._conv_nchw(x, net.init_conv)),
                         ("k8_wrapper", lambda: kmega.unet2d_mega(x0, film, packs, plan)),
                         ("final_conv", lambda: tunet._conv_nchw(x0, net.final_conv))):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            fn()
            host[name] = 1e3 * (time.perf_counter() - tic)
        torch.cuda.synchronize()

        # the device time alone (a CUDA graph of 10 launches) and the grid
        k_device_ms, k_device_err = timed_graph(
            torch, lambda: kmega.unet2d_mega(x0, film, packs, plan), n=10)
        grid_blocks = kmega.grid_blocks(x0.device)
        sms = torch.cuda.get_device_properties(0).multi_processor_count

        # smaller nets at batch 4 through K8 and through K1-K6 (K6 on their
        # bottlenecks): the 3-level net's 4 x 32 = 128 tokens, and the
        # 2-level net's 8 x 64 = 512 (K8 refused more than 128 tokens before
        # its attention stages became K6's)
        small = {}
        for mults, tokens in (((1, 2, 4), 128), ((1, 2), 512)):
            snet = seeded_init_(tunet.UNet2D(dim=16, dim_mults=mults),
                                torch.Generator().manual_seed(0)).cuda()
            xs = torch.randn(4, 16, 128, 2, generator=gen, device="cuda")
            ts = torch.tensor([3.0, 500.0, 999.0, 0.0], device="cuda")
            kb.reset_launch_counts()
            s_out = snet.forward_mega(xs, ts)
            torch.cuda.synchronize()
            s_mega_counts = kb.launch_counts()
            s_ref = snet.forward_plain(xs, ts)
            kb.reset_launch_counts()
            s_fwd = snet(xs, ts)
            torch.cuda.synchronize()
            s_counts = kb.launch_counts()
            scale = max(1.0, s_ref.abs().max().item())
            small[tokens] = {
                "dim": 16, "mults": list(mults), "batch": 4, "bottleneck_tokens": tokens,
                "max_abs_err": (s_out - s_ref).abs().max().item(), "tol": KERNEL_RTOL * scale,
                "launches": s_mega_counts, "bit_equal_repeat": torch.equal(
                    s_out, snet.forward_mega(xs, ts)),
                "forward_mega_ms": timed(torch, lambda: snet.forward_mega(xs, ts), n=10),
                "forward_k1_k6_max_abs_err": (s_fwd - s_ref).abs().max().item(),
                "forward_k1_k6_tol": UNET_RTOL * scale, "forward_k1_k6_launches": s_counts,
                "forward_k1_k6_ms": timed(torch, lambda: snet(xs, ts), n=10)}
            del snet, s_out, s_ref, s_fwd
    split_k = sum(st.ints.get("splits", 1) > 1 for st in plan.stages)
    emit({"phase": "unet2d_mega", "batch": B, "stages": plan.counts(),
          "split_k_stages": split_k, "barriers": plan.barriers(),
          "grid_blocks": kmega.unet2d_mega.grid, "grid_planned": plan.grid, "sms": sms,
          "arrival_counters": plan.n_counters,
          "workspace_mb": plan.workspace_bytes / 1e6, "launches_per_forward": counts,
          "expected": want, "max_abs_err_vs_plain_forward": err_plain,
          "max_abs_err_vs_kernel_forward": err_k, "tol": tol, "bit_equal_repeat": bit_equal,
          "finite": finite, "kernel_max_abs_err": k_err, "kernel_tol": k_tol,
          "kernel_ms": k_ms, "kernel_device_ms": k_device_ms,
          **({"kernel_device_ms_error": k_device_err} if k_device_err else {}),
          "kernel_plain_ms": k_plain_ms, "bound_ms": b_ms, "bound_by": b_by,
          "bound_fp32_ms": b_fp32_ms, "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
          "forward_mega_ms": [mega_fwd_ms, mega_fwd_ms_2], "forward_k1_k6_ms": fwd_ms,
          "forward_plain_ms": plain_fwd_ms,
          "forward_mega_enqueue_ms": enqueue_ms, "forward_mega_host_ms": host,
          "profile_two_forward_mega": {"wall_ms": prof_wall, "device_ms": prof_dev,
                                       "top": [[k[:60], v] for k, v in prof_rows[:6]]},
          "small_nets": list(small.values()),
          "nvidia_smi": smi_line, "seconds": round(time.time() - t0, 3)})
    if not (err_plain <= tol and err_k <= tol and finite):
        fail(f"forward_mega differs: {err_plain} (plain), {err_k} (K1-K6) > {tol}")
    if not k_err <= k_tol:
        fail(f"K8 differs from its plain version: {k_err} > {k_tol}")
    if counts != want:
        fail(f"launches per forward_mega {counts} != {want}")
    if not bit_equal:
        fail("two K8 forwards are not bit-equal")
    if grid_blocks != sms or kmega.unet2d_mega.grid != sms:
        fail(f"K8 launched {kmega.unet2d_mega.grid} CTAs (grid {grid_blocks}), not one per "
             f"SM of {sms}")
    for tokens, r in small.items():
        if not (r["max_abs_err"] <= r["tol"] and r["bit_equal_repeat"]
                and r["launches"]["unet2d_mega"] == 1 and sum(r["launches"].values()) == 1):
            fail(f"K8 on the {tokens}-token bottleneck differs or repeats unequal: {r}")
        if not (r["forward_k1_k6_max_abs_err"] <= r["forward_k1_k6_tol"]
                and r["forward_k1_k6_launches"]["attention_block"] == 1):
            fail(f"UNet2D.forward (K1-K6) on the {tokens}-token bottleneck differs, or its "
                 f"launches hold no K6 call: {r}")
    del small

    # 20 guided DDPM steps at batch 50, both models through forward_mega, in
    # turns with 20 through K1-K6 (K1-K6, K8, K8, K1-K6)
    t0 = time.time()
    u_target = torch.randn(B, 11, 128, generator=gen, device="cuda")
    cond_vals = {"u0": u_target[:, 0, :] / bench.RESCALER,
                 "uT": u_target[:, 10, :] / bench.RESCALER}
    guidance = bench.build_guidance(cfg, u_target, wu=1000.0)
    gds = {"k1_k6": bench.build_diffusion(cfg, net, model_w=net_w, device="cuda"),
           "mega": bench.build_diffusion(cfg, net.forward_mega, model_w=net_w.forward_mega,
                                         device="cuda")}
    ts = gds["mega"].sample_ts()
    n_steps = 20
    rates, mega_counts = {"k1_k6": [], "mega": []}, None
    xs_ = {}
    for name in ("k1_k6", "mega", "mega", "k1_k6"):
        gd = gds[name]
        xg = torch.Generator(device="cuda").manual_seed(1)
        xt = gd.sample_chunk(gd.sample_init(B, xg), ts[:2], cond_vals, guidance, xg)  # warm-up
        torch.cuda.synchronize()
        if name == "mega" and mega_counts is None:
            kb.reset_launch_counts()
        tic = time.perf_counter()
        xt = gd.sample_chunk(xt, ts[2:2 + n_steps], cond_vals, guidance, xg)
        torch.cuda.synchronize()
        rates[name].append(n_steps / (time.perf_counter() - tic))
        if name == "mega" and mega_counts is None:
            mega_counts = kb.launch_counts()
        xs_.setdefault(name, xt)
    want_steps = {k: 0 for k in mega_counts}
    want_steps["unet2d_mega"] = 2 * n_steps
    gd = gds["mega"]

    def three_steps():
        nonlocal xt
        xt = gd.sample_chunk(xt, ts[22:25], cond_vals, guidance, xg)

    wall_ms, dev_ms, rows = profile_window(torch, three_steps)
    busy = {"steps": 3, "wall_ms": wall_ms, "device_ms": dev_ms,
            "busy_share": dev_ms / wall_ms, "top": [[k[:60], v] for k, v in rows[:6]]}
    step_gap = ((xs_["mega"] - xs_["k1_k6"]).abs().max()
                / xs_["k1_k6"].abs().max().clamp(min=1.0)).item()
    finite = bool(torch.isfinite(xs_["mega"]).all())
    emit({"phase": "guided_ddpm_mega", "batch": B, "steps_timed": n_steps,
          "order": "k1_k6, mega, mega, k1_k6",
          "guided_denoise_steps_per_sec": rates, "profile_mega": busy, "launches": mega_counts,
          "expected": want_steps, "finite": finite,
          "rel_gap_vs_k1_k6_after_22_steps": step_gap,
          "nvidia_smi": smi_line, "seconds": round(time.time() - t0, 3)})
    if not finite:
        fail("non-finite samples in the guided DDPM loop through forward_mega")
    if mega_counts != want_steps:
        fail(f"launches of 20 guided steps through forward_mega {mega_counts} != {want_steps}")
    del gds, net, net_w
    torch.cuda.empty_cache()
    return {"unet2d_mega": {"launches": mega_counts["unet2d_mega"], "max_abs_err": k_err,
                            "ms": k_ms, "plain_ms": k_plain_ms, "bound_ms": b_ms,
                            "bound_by": b_by, "library_ms": None, "device_ms": k_device_ms},
            "unet2d_mega_bf16": _mega_bf16(torch, smi_line, bench)}


def _maps_cost(torch, kb, kmega, launch, n=20):
    """What the tensor maps cost a bf16 K7/K8 launch (each launch encodes
    them on the host and writes them on the device, ``unet2d_mega._maps``):
    over n launches enqueued back to back, the median host time of the
    launch and of its ``_maps`` call (encoding, allocation and the writing
    kernels' enqueue), in us; the writing kernels' device time alone
    (``timed_graph``), in us; the maps a launch writes."""
    from unittest import mock

    encode, maps_s, launch_s, last = kmega._maps, [], [], []

    def timed_maps(*args):
        tic = time.perf_counter()
        out = encode(*args)
        maps_s.append(time.perf_counter() - tic)
        last[:] = args
        return out

    with mock.patch.object(kmega, "_maps", timed_maps):
        launch()
        torch.cuda.synchronize()
        maps_s.clear()
        for _ in range(n):
            tic = time.perf_counter()
            launch()
            launch_s.append(time.perf_counter() - tic)
        torch.cuda.synchronize()
    plan, bases, _, device, lib = last
    dev_ms, dev_err = timed_graph(
        torch, lambda: encode(plan, bases, kb._stream(torch.empty(0, device=device)), device,
                              lib), n=10)
    return {"maps": len(plan.map_specs), "maps_host_us": 1e6 * sorted(maps_s)[n // 2],
            "launch_host_us": 1e6 * sorted(launch_s)[n // 2],
            "maps_device_us": None if dev_ms is None else 1e3 * dev_ms,
            **({"maps_device_error": dev_err} if dev_err else {})}


def _mega_bf16(torch, smi_line, bench):
    """Phase 10, bf16: ``BurgersConfig(bf16=True, impl="pallas")`` nets (bf16 packs, the
    JAX mega kernel's default) through ``forward_mega`` at batch 50: exactly
    1 K8 launch per forward, a bf16 one, and nothing else; within
    BF16_UNET_RTOL of the bf16 plain forward and of the bf16 K1-K6 forward;
    two forwards bit-equal; the kernel against its plain version (the bf16
    plain replay) on the same inputs; timed per event pair and on the device
    (CUDA graph) beside the bound at the bf16 rate (the weights at their
    stored sizes); forward_mega and the K1-K6 forward in turns; then 20
    guided DDPM steps with both models through bf16 forward_mega (exactly
    40 K8 launches, all bf16) in turns with 20 through bf16 K1-K6."""
    from torch.utils.flop_counter import FlopCounterMode

    from diffphycon_tpu_torch.kernels import unet2d_blocks as kb
    from diffphycon_tpu_torch.kernels import unet2d_mega as kmega
    from diffphycon_tpu_torch.nets import unet2d as tunet

    t0 = time.time()
    cfg = bench.BurgersConfig(is_condition_u0=True, is_condition_uT=True, bf16=True,
                              impl="pallas")
    net = bench.init_params(cfg, seed=0, device="cuda")
    net_w = bench.init_params(cfg, seed=1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(101)
    x = torch.randn(B, cfg.pad_t, cfg.nx, 2, generator=gen, device="cuda")
    t = torch.linspace(0, 999, B, device="cuda")
    with torch.no_grad():
        kb.reset_launch_counts()
        out = net.forward_mega(x, t)
        torch.cuda.synchronize()
        counts = kb.launch_counts()
        want = {k: 0 for k in counts}
        want["unet2d_mega"] = want["unet2d_mega.bf16"] = 1
        bit_equal = torch.equal(out, net.forward_mega(x, t))
        ref_plain = net.forward_plain(x, t)
        ref_k = net(x, t)
        scale = max(1.0, ref_plain.abs().max().item())
        err_plain = (out - ref_plain).abs().max().item()
        err_k = (out - ref_k).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        del ref_plain, ref_k

        packs = net._kernel_pack()
        film = net._film(t, packs)
        x0 = tunet._conv_nchw(x, net.init_conv, torch.bfloat16)
        plan = kmega.mega_plan(packs, x0.shape, net.groups, HEADS, DIM_HEAD, x0.device)
        k_out = kmega.unet2d_mega(x0, film, packs, plan)
        k_ref = kmega.unet2d_mega_plain(x0, film, packs, plan)
        k_scale = max(1.0, k_ref.abs().max().item())
        k_err = (k_out - k_ref).abs().max().item()
        with FlopCounterMode(display=False) as counter:
            kmega.unet2d_mega_plain(x0, film, packs, plan)
        weights = {id(st.ptrs[k]): st.ptrs[k] for st in plan.stages for k in st.ptrs
                   if isinstance(st.ptrs[k], torch.Tensor)}
        nbytes = (sum(w.numel() * w.element_size() for w in weights.values())
                  + 4 * (x0.numel() + film.numel() + k_out.numel()))
        flops = counter.get_total_flops()
        b_ms, b_by = bound(flops, nbytes, BF16_PEAK)
        del k_out, k_ref
        k_ms = timed(torch, lambda: kmega.unet2d_mega(x0, film, packs, plan), n=10)
        k_plain_ms = timed(torch, lambda: kmega.unet2d_mega_plain(x0, film, packs, plan), n=3)
        k_device_ms, k_device_err = timed_graph(
            torch, lambda: kmega.unet2d_mega(x0, film, packs, plan), n=10)
        maps = _maps_cost(torch, kb, kmega, lambda: kmega.unet2d_mega(x0, film, packs, plan))
        fwd_ms = {"forward_mega": [], "forward_k1_k6": []}
        for name in ("forward_mega", "forward_k1_k6", "forward_k1_k6", "forward_mega"):
            fn = net.forward_mega if name == "forward_mega" else net
            fwd_ms[name].append(timed(torch, lambda: fn(x, t), n=5))
    emit({"phase": "unet2d_mega_bf16", "batch": B, "weight_dtype": str(plan.weight_dtype),
          "stages": plan.counts(), "barriers": plan.barriers(),
          "launches_per_forward": counts, "expected": want,
          "rel_err_vs_plain_forward": err_plain / scale,
          "rel_err_vs_kernel_forward": err_k / scale, "tol_rel": BF16_UNET_RTOL,
          "bit_equal_repeat": bit_equal, "finite": finite, "kernel_max_abs_err": k_err,
          "kernel_rel_err": k_err / k_scale, "kernel_ms": k_ms, "kernel_device_ms": k_device_ms,
          **({"kernel_device_ms_error": k_device_err} if k_device_err else {}),
          "kernel_plain_ms": k_plain_ms, "bound_ms": b_ms, "bound_by": b_by, **maps,
          "gflop": flops / 1e9, "mbytes": nbytes / 1e6, "forward_ms_in_turns": fwd_ms,
          "nvidia_smi": smi_line, "seconds": round(time.time() - t0, 3)})
    if not (err_plain <= BF16_UNET_RTOL * scale and err_k <= BF16_UNET_RTOL * scale and finite):
        fail(f"bf16 forward_mega differs: {err_plain / scale} (plain), {err_k / scale} (K1-K6)")
    if not k_err <= BF16_UNET_RTOL * k_scale:
        fail(f"bf16 K8 differs from its plain version: {k_err / k_scale}")
    if counts != want:
        fail(f"launches per bf16 forward_mega {counts} != {want}")
    if not bit_equal:
        fail("two bf16 K8 forwards are not bit-equal")

    # 20 guided DDPM steps at batch 50 through bf16 forward_mega, in turns
    # with bf16 K1-K6
    t0 = time.time()
    u_target = torch.randn(B, 11, 128, generator=gen, device="cuda")
    cond_vals = {"u0": u_target[:, 0, :] / bench.RESCALER,
                 "uT": u_target[:, 10, :] / bench.RESCALER}
    guidance = bench.build_guidance(cfg, u_target, wu=1000.0)
    gds = {"k1_k6": bench.build_diffusion(cfg, net, model_w=net_w, device="cuda"),
           "mega": bench.build_diffusion(cfg, net.forward_mega, model_w=net_w.forward_mega,
                                         device="cuda")}
    ts = gds["mega"].sample_ts()
    n_steps = 20
    rates, mega_counts, xs_ = {"k1_k6": [], "mega": []}, None, {}
    for name in ("k1_k6", "mega", "mega", "k1_k6"):
        gd = gds[name]
        xg = torch.Generator(device="cuda").manual_seed(1)
        xt = gd.sample_chunk(gd.sample_init(B, xg), ts[:2], cond_vals, guidance, xg)
        torch.cuda.synchronize()
        if name == "mega" and mega_counts is None:
            kb.reset_launch_counts()
        tic = time.perf_counter()
        xt = gd.sample_chunk(xt, ts[2:2 + n_steps], cond_vals, guidance, xg)
        torch.cuda.synchronize()
        rates[name].append(n_steps / (time.perf_counter() - tic))
        if name == "mega" and mega_counts is None:
            mega_counts = kb.launch_counts()
        xs_.setdefault(name, xt)
    want_steps = {k: 0 for k in mega_counts}
    want_steps["unet2d_mega"] = want_steps["unet2d_mega.bf16"] = 2 * n_steps
    finite = bool(torch.isfinite(xs_["mega"]).all())
    emit({"phase": "guided_ddpm_mega_bf16", "batch": B, "steps_timed": n_steps,
          "order": "k1_k6, mega, mega, k1_k6", "guided_denoise_steps_per_sec": rates,
          "launches": mega_counts, "expected": want_steps, "finite": finite,
          "rel_gap_vs_k1_k6_after_22_steps": ((xs_["mega"] - xs_["k1_k6"]).abs().max()
                                              / xs_["k1_k6"].abs().max().clamp(min=1.0)).item(),
          "nvidia_smi": smi_line, "seconds": round(time.time() - t0, 3)})
    if not finite:
        fail("non-finite samples in the guided DDPM loop through bf16 forward_mega")
    if mega_counts != want_steps:
        fail(f"launches of 20 bf16 guided steps through forward_mega {mega_counts} != "
             f"{want_steps}")
    del gds, net, net_w
    torch.cuda.empty_cache()
    return {"launches": mega_counts["unet2d_mega.bf16"], "max_abs_err": k_err, "ms": k_ms,
            "plain_ms": k_plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "device_ms": k_device_ms}


def _fit(torch, run, batch, accum=1):
    """run(accum): a training run at ``batch`` with gradient accumulation
    ``accum``, 2 * accum, ..., the first whose micro-batch fits in device
    memory (the apps' --grad_accum); returns (result, accum, why or None)."""
    why = None
    while True:
        try:
            return run(accum), accum, why
        except torch.cuda.OutOfMemoryError as e:  # the stated fallback, printed
            if accum >= batch:
                raise
            why = (f"micro-batch {batch // accum} does not fit "
                   f"({str(e).splitlines()[0][:120]}); trying {batch // accum // 2}")
        print(why, flush=True)
        torch.cuda.empty_cache()
        accum *= 2


def _step_timing(torch, trainer, batch_fn, warm, n_windows, n_steps):
    """``warm`` untimed ``trainer.train_step``s, then ms per optimizer step
    over ``n_windows`` windows of ``n_steps`` (their median, and the peak
    device memory of the windows). batch_fn() -> a device batch."""
    for _ in range(warm):
        trainer.train_step(batch_fn())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    window_ms, losses = [], []
    for _ in range(n_windows):
        tic = time.perf_counter()
        for _ in range(n_steps):
            losses.append(trainer.train_step(batch_fn()))
        torch.cuda.synchronize()
        window_ms.append(1e3 * (time.perf_counter() - tic) / n_steps)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = sorted(window_ms)[n_windows // 2]
    return {"window_ms_per_step": window_ms, "ms_per_step": step_ms,
            "window_spread": (max(window_ms) - min(window_ms)) / step_ms,
            "peak_memory_gb": peak_gb,
            "losses": [float(v) for v in losses]}


# phases 11-12: one warm-up step after each remat switch (the allocator grows
# to the new setting's peak there), then a one-step window
REMAT_TIMING = (1, 1, 1)


def _timed_remat(torch, tr, batch_fn, settings=(True, False)):
    """{"remat_on"|"remat_off": _step_timing of trainer ``tr`` with its
    UNet3D's remat_all switched to each of ``settings``, at the
    accumulation that fits, trying the app's first (remat off takes more
    memory than the app's remat on)}."""
    timing = {}
    for remat_all in settings:
        tr.model.remat_all = remat_all

        def run(accum):
            tr.cfg.gradient_accumulate_every = accum
            return _step_timing(torch, tr, batch_fn, *REMAT_TIMING)

        tm, accum, why = _fit(torch, run, TRAIN_B, accum=tr.cfg.gradient_accumulate_every)
        timing[f"remat_{'on' if remat_all else 'off'}"] = {
            "grad_accum": accum, "why_accum": why, **tm}
        if not all(math.isfinite(v) for v in tm["losses"]):
            fail(f"non-finite training losses (remat_all {remat_all}): {tm['losses']}")
    return timing


def smoke_training_phase(torch, smi_line):
    """Phase 11: smoke training at full width (UNet3D dim 64, mults (1, 2,
    4), input (16, 32, 64, 64, C)): a generated train split, the train app
    for the joint (C=6) and the w model (C=2) at batch 16 (a few steps, a
    save, a resume), then ms per optimizer step and its peak
    memory, remat on and off."""
    from diffphycon_tpu_torch.apps import generate_smoke, train_smoke

    t0 = time.time()
    work = os.path.join("build", "chip_smoke")
    data_dir = os.path.join(work, "smoke_train_data")
    models = os.path.join(work, "smoke_models")
    tic = time.perf_counter()
    generate_smoke.main(generate_smoke.build_parser().parse_args([
        "--out", data_dir, "--n_test", "0", "--n_train", str(TRAIN_B), "--batch", str(TRAIN_B),
        "--filter_rate", "-1", "--min_sum_rate", "-1", "--max_sum_rate", "1e9"]))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - tic

    def app(extra, folder, fresh):
        def run(accum):
            if fresh:
                shutil.rmtree(folder, ignore_errors=True)
            tic = time.perf_counter()
            tr = train_smoke.main(train_smoke.build_parser().parse_args(
                ["--dataset_path", data_dir, "--batch_size", str(TRAIN_B), "--grad_accum",
                 str(accum), "--checkpoint_interval", "2", "--results_folder", folder] + extra))
            torch.cuda.synchronize()
            return tr, time.perf_counter() - tic
        return run

    runs, record = {}, []
    for name, extra, sub, final in (
            ("joint", ["--train_num_steps", "3"], "smoke", 3),
            ("joint resumed", ["--train_num_steps", "4", "--resume", "True"], "smoke", 4),
            ("w", ["--train_num_steps", "2", "--is_w_model", "True"], "smoke_w", 2)):
        folder = os.path.join(models, sub)
        if name == "joint resumed":  # the joint run's folder as it stands
            accum, why = record[0]["grad_accum"], None
            tr, wall = app(extra, folder, fresh=False)(accum)
        else:
            (tr, wall), accum, why = _fit(torch, app(extra, folder, fresh=True), TRAIN_B)
        log = [json.loads(line) for line in open(os.path.join(folder, "train_log.jsonl"))]
        ckpts = sorted(int(d) for d in os.listdir(os.path.join(folder, "ckpt")) if d.isdigit())
        record.append({"run": name, "batch": TRAIN_B, "grad_accum": accum, "why_accum": why,
                       "final_step": tr.step, "losses": [r["loss"] for r in log],
                       "checkpoints": ckpts, "remat_all": tr.model.remat_all, "seconds": wall})
        if tr.step != final or final not in ckpts:
            fail(f"train_smoke ({name}): step {tr.step}, checkpoints {ckpts} (want {final})")
        if not log or not all(math.isfinite(r["loss"]) for r in log):
            fail(f"train_smoke ({name}): non-finite or missing losses {log}")
        runs[name] = tr
    emit({"phase": "smoke_train_app", "app": "diffphycon_tpu_torch/apps/train_smoke.py",
          "generate_seconds": gen_s, "runs": record, "seconds": round(time.time() - t0, 3)})

    t0 = time.time()
    timing = {}
    # the joint model with remat on (the app's default) is timed in phase 17,
    # in turns with its bf16 step
    for name, tr, settings in (("joint", runs["joint resumed"], (False,)),
                               ("w", runs["w"], (True, False))):
        timing[name] = _timed_remat(
            torch, tr, lambda tr=tr: torch.as_tensor(next(tr.batch_iter), device="cuda"),
            settings)
    emit({"phase": "smoke_train_timing", "channels": {"joint": 6, "w": 2},
          "input": [TRAIN_B, 32, 64, 64], "warm_windows_steps": REMAT_TIMING, "timing": timing,
          "nvidia_smi": smi_line, "seconds": round(time.time() - t0, 3)})
    del runs
    torch.cuda.empty_cache()


def _jelly_cpu_check(torch, tbench):
    """The EBM loss, its parameter gradient and one guided DDPM step on CUDA
    against the same weights and draws on the CPU. cuDNN's TF32 switch is put
    back to PyTorch's default (on) first: the nets must turn it off for their
    forward, backward and recompute themselves, and a TF32 conv anywhere in
    the double backward or the guidance gradient shows here."""
    import copy

    torch.backends.cudnn.allow_tf32 = True
    cfg = tbench.JellyfishConfig(dim=16, dim_mults=(1, 2, 4), frames=8, image_size=32,
                                 reg_ratio=0.1, remat_all=True)
    g = torch.Generator().manual_seed(11)
    b, f, h = 2, cfg.frames, cfg.image_size
    state0 = torch.rand(b, f, h, h, 3, generator=g) * 2 - 1
    bd0 = torch.randn(b, f, h, h, 3, generator=g)
    thetas0 = torch.randn(b, f, generator=g)
    t = torch.tensor([7, 613])
    noise = torch.randn(b, f, h, h, 3, generator=g)
    init_noise = tuple(torch.randn(b, f, h, h, c, generator=g) for c in (3, 3, 1))
    step_noise = torch.randn(b, f, h, h, 4, generator=g)
    nets_cpu = {"joint": tbench.build_joint_unet(cfg, seed=1, device="cpu"),
                "thetas": tbench.build_thetas_unet(cfg, seed=2, device="cpu"),
                "bd": tbench.build_bd_updater(cfg, seed=3, device="cpu"),
                "force": tbench.build_force_unet(cfg, seed=4, device="cpu")}
    out = {}
    for dev in ("cpu", "cuda"):
        nets = {k: copy.deepcopy(v).to(dev) for k, v in nets_cpu.items()}
        gd = tbench.JellyfishDiffusion(cfg, nets["joint"], thetas_model=nets["thetas"],
                                       bd_updater=nets["bd"], device=dev)
        tic = time.perf_counter()
        loss = gd.p_losses_states(*(a.to(dev) for a in (state0, bd0, thetas0, t, noise)))
        loss.backward()
        grads = {k: p.grad.cpu() for k, p in nets["joint"].named_parameters()}
        design_fn = tbench.make_force_design_fn(cfg, nets["force"], nets["bd"], -2.0, 3.0)
        cond = gd._cond(state0[:, 0].to(dev), bd0[:, 0].to(dev), thetas0[:, 0].to(dev))
        x = gd.sample_init(cond.state_0, cond.bd_0, cond.thetas_0,
                           noise=tuple(a.to(dev) for a in init_noise))
        x = gd.step(x, 500, cond, design_fn, noise=step_noise.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = (loss.item(), grads, x.cpu(), time.perf_counter() - tic)
    (lc, gc, xc, sc), (lg, gg, xg, sg) = out["cpu"], out["cuda"]
    gmax = max(v.abs().max().item() for v in gc.values())
    grad_err = max((gg[k] - v).abs().max().item() for k, v in gc.items())
    rec = {"shape": [b, f, h, h], "dim": 16, "surrogate_dim": cfg.image_size,
           "tf32_switch_before": True, "loss_cpu": lc, "loss_cuda": lg,
           "loss_rel_err": abs(lg - lc) / max(1.0, abs(lc)), "loss_tol": JELLY_CPU_RTOL,
           "grad_max_abs_err": grad_err, "grad_max": gmax,
           "grad_tol": JELLY_CPU_GRAD_RTOL * max(1.0, gmax),
           "step_max_abs_err": (xg - xc).abs().max().item(),
           "step_tol": JELLY_CPU_RTOL * max(1.0, xc.abs().max().item()),
           "cpu_seconds": sc, "cuda_seconds": sg}
    ok = (rec["loss_rel_err"] <= JELLY_CPU_RTOL and grad_err <= rec["grad_tol"]
          and rec["step_max_abs_err"] <= rec["step_tol"] and math.isfinite(lg)
          and bool(torch.isfinite(xg).all()))
    return rec, ok


def _conv_nets_cpu_check(torch):
    """One operator training step's loss and parameter gradient (batch 256,
    s = s_ob = 128), and one conv SAC update at batch RL_SAC_B (64x64 field
    observations): the policy loss and its gradient before the update, the
    two critic losses of ``SAC.step`` (taken before any of its Adam steps)
    and the critics' gradients it leaves; on CUDA against the CPU with the
    same weights, batch and noise. cuDNN's TF32 switch is put back to
    PyTorch's default (on) first, as in _jelly_cpu_check: the nets must
    clear it for their forward and backward themselves."""
    import copy

    from diffphycon_tpu_torch.apps.train_burgers_operator import operator_loss
    from diffphycon_tpu_torch.baselines.rl import SAC, ConvGaussPolicy, ConvQ
    from diffphycon_tpu_torch.nets.burgers_operator import SurrogateOperator

    g = torch.Generator().manual_seed(12)
    op_in = [torch.randn(256, 128, generator=g) for _ in range(3)]
    b = RL_SAC_B
    s, s2 = (torch.rand(b, 64, 64, 4, generator=g) for _ in range(2))
    a = torch.rand(b, 64, 64, 2, generator=g) * 2 - 1
    r, mask = torch.randn(b, generator=g), torch.ones(b)
    n1, n2 = (torch.randn(b, 64, 64, 2, generator=g) for _ in range(2))
    op_cpu = SurrogateOperator(seed=0, device="cpu").train()
    out = {}
    for dev in ("cpu", "cuda"):
        torch.backends.cudnn.allow_tf32 = True
        op = copy.deepcopy(op_cpu).to(dev)
        loss = operator_loss(op, *(x.to(dev) for x in op_in))
        loss.backward()
        res = {"operator_loss": loss.item(),
               "operator_grad": {k: p.grad.cpu() for k, p in op.named_parameters()}}
        sac = SAC(64 * 64 * 4, 64 * 64 * 2, seed=0, batch_size=b,
                  policy=ConvGaussPolicy(in_channels=4, action_channels=2),
                  q_module=lambda: ConvQ(in_channels=6), action_shape=(64, 64, 2), device=dev)
        sd, ad, rd, s2d, md, n1d, n2d = (x.to(dev) for x in (s, a, r, s2, mask, n1, n2))
        an, logp = sac._sample_action(sd, n2d)
        lp = (sac.log_alpha.detach().exp() * logp
              - torch.minimum(sac.q1(sd, an), sac.q2(sd, an))).mean()
        params = dict(sac.policy.named_parameters())
        res["policy_loss"] = lp.item()
        res["policy_grad"] = {k: v.cpu() for k, v in zip(
            params, torch.autograd.grad(lp, list(params.values())))}
        res["critic_loss"], _ = sac.step(sd, ad, rd, s2d, md, noise=(n1d, n2d))
        res["critic_loss"] = float(res["critic_loss"])
        res["critic_grad"] = {f"q{i}.{k}": p.grad.cpu() for i, q in ((1, sac.q1), (2, sac.q2))
                              for k, p in q.named_parameters()}
        out[dev] = res
    rec, ok = {"tf32_switch_before": True, "operator_batch": 256, "sac_batch": b,
               "loss_tol": JELLY_CPU_RTOL, "grad_tol": JELLY_CPU_GRAD_RTOL}, True
    for name in ("operator", "policy", "critic"):
        lc, lg = out["cpu"][f"{name}_loss"], out["cuda"][f"{name}_loss"]
        gc, gg = out["cpu"][f"{name}_grad"], out["cuda"][f"{name}_grad"]
        gmax = max(v.abs().max().item() for v in gc.values())
        gerr = max((gg[k] - v).abs().max().item() for k, v in gc.items())
        rec[name] = {"loss_cpu": lc, "loss_cuda": lg,
                     "loss_rel_err": abs(lg - lc) / max(1.0, abs(lc)),
                     "grad_max_abs_err": gerr, "grad_max": gmax}
        ok = ok and (rec[name]["loss_rel_err"] <= JELLY_CPU_RTOL and math.isfinite(lg)
                     and gerr <= JELLY_CPU_GRAD_RTOL * max(1.0, gmax))
    return rec, ok


def _busy(torch, fn):
    """One profiled call of fn: wall and device ms, the device's busy share
    (a lower bound: the profiler adds host time) and the top 5 kernels."""
    wall_ms, dev_ms, rows = profile_window(torch, fn)
    return {"wall_ms": wall_ms, "device_ms": dev_ms, "busy_share": dev_ms / wall_ms,
            "top": [[k[:60], v] for k, v in rows[:5]]}


def _sl_value_and_grad(u0, f, u_tgt, dt, checkpoint=True, T=1.0):
    """The SL objective J(f) = mean (u(T) - u_target(T))^2 through the solver
    and its gradient with respect to f."""
    from diffphycon_tpu_torch.physics.burgers import burgers_solve

    f = f.detach().clone().requires_grad_(True)
    j = ((burgers_solve(u0, f, T=T, dt=dt, checkpoint=checkpoint)[:, -1] - u_tgt) ** 2).mean()
    j.backward()
    return j.detach(), f.grad


def _solver_records(torch, smi_line):
    """Phase 13, part 1: the solver at batch 32, forward without grad and the
    SL value-and-gradient with and without per-frame checkpoint, each with
    its peak memory; then the SL objective on CUDA against the CPU."""
    from diffphycon_tpu_torch.physics.burgers import burgers_solve, make_burgers_data

    t0 = time.time()
    u0_np, f_np = make_burgers_data(BASE_B, seed=0)
    u0, f_true = (torch.as_tensor(a, device="cuda") for a in (u0_np, f_np))
    with torch.no_grad():
        u_tgt = burgers_solve(u0, f_true, dt=1e-3)[:, -1]
    f = 0.5 * f_true  # a control halfway to the generating one

    def sync_time(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        tic = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - tic, (torch.cuda.max_memory_allocated() - base) / 1e9

    with torch.no_grad():
        burgers_solve(u0, f, dt=1e-3)  # warm-up, then the backward's and the recompute's
    for ckpt in (True, False):
        _sl_value_and_grad(u0, f, u_tgt, 1e-3, ckpt)
    rec = {}
    for dt in BASE_SOLVER_DTS:
        steps = round(1.0 / dt)
        with torch.no_grad():
            _, fwd_s, fwd_gb = sync_time(lambda: burgers_solve(u0, f, dt=dt))
        row = {"steps": steps, "forward_s": fwd_s, "forward_us_per_step": 1e6 * fwd_s / steps,
               "forward_peak_gb": fwd_gb}
        for ckpt in (True, False):
            (j, g), s_, gb = sync_time(lambda: _sl_value_and_grad(u0, f, u_tgt, dt, ckpt))
            key = "checkpoint" if ckpt else "no_checkpoint"
            row[f"value_and_grad_{key}_s"] = s_
            row[f"value_and_grad_{key}_us_per_step"] = 1e6 * s_ / steps
            row[f"value_and_grad_{key}_peak_gb"] = gb
            row[f"J_{key}"] = j.item()
            if not torch.isfinite(g).all():
                fail(f"non-finite SL gradient (dt {dt}, checkpoint {ckpt})")
        row["grad_over_forward"] = row["value_and_grad_checkpoint_s"] / fwd_s
        rec[f"dt_{dt:g}"] = row
    # the profiler's bookkeeping grows with the event count: profile 100
    # steps (T = 0.1), the same ops per step
    rec["dt_0.001"]["value_and_grad_checkpoint_profile_100_steps"] = _busy(
        torch, lambda: _sl_value_and_grad(u0, f, u_tgt, 1e-3, T=0.1))
    # CUDA against the CPU at dt 1e-3
    tic = time.perf_counter()
    j_cpu, g_cpu = _sl_value_and_grad(u0.cpu(), f.cpu(), u_tgt.cpu(), 1e-3)
    cpu_s = time.perf_counter() - tic
    j_gpu, g_gpu = _sl_value_and_grad(u0, f, u_tgt, 1e-3)
    gmax = g_cpu.abs().max().item()
    cmp = {"J_cpu": j_cpu.item(), "J_cuda": j_gpu.item(),
           "J_rel_err": abs(j_gpu.item() - j_cpu.item()) / max(abs(j_cpu.item()), 1e-30),
           "J_tol": BASE_CPU_RTOL, "grad_max_abs_err": (g_gpu.cpu() - g_cpu).abs().max().item(),
           "grad_max": gmax, "grad_tol": BASE_CPU_GRAD_RTOL * gmax, "cpu_s": cpu_s}
    emit({"phase": "baselines_solver", "batch": BASE_B, "nx": 128,
          "solves": rec, "sl_cuda_vs_cpu": cmp, "nvidia_smi": smi_line,
          "seconds": round(time.time() - t0, 3)})
    if not (cmp["J_rel_err"] <= BASE_CPU_RTOL and cmp["grad_max_abs_err"] <= cmp["grad_tol"]):
        fail(f"the SL objective on CUDA differs from the CPU: {cmp}")
    return rec


def _operator_step_ms(torch, checkpoint, data_root):
    """ms per train_burgers_operator step at batch 256, warm: the app's step
    on its checkpoint and data, 3 untimed steps, then 3 windows of 10
    (synchronised), their median; and a profile of 3 more steps."""
    import numpy as np

    from diffphycon_tpu_torch.apps.train_burgers_operator import make_train_step
    from diffphycon_tpu_torch.nets.burgers_operator import RESCALER, SurrogateOperator
    from diffphycon_tpu_torch.training.data import synthetic_burgers

    op = SurrogateOperator(device="cuda")
    op.load_state_dict(torch.load(checkpoint, map_location="cuda", weights_only=True))
    op.train()
    u, f = synthetic_burgers(4096, seed=0, cache_dir=os.path.join(data_root, "synthetic"),
                             device="cuda")
    ut = torch.as_tensor(u[:, :-1].reshape(-1, 128) / RESCALER, device="cuda")
    un = torch.as_tensor(u[:, 1:].reshape(-1, 128) / RESCALER, device="cuda")
    ft = torch.as_tensor(f.reshape(-1, 128) / RESCALER, device="cuda")
    step = make_train_step(op, 1e-3, 5000, 1e-4, 1.0)
    rng = np.random.default_rng(1)
    windows = []
    for w in range(4):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        for i in range(3 if w == 0 else 10):
            idx = torch.as_tensor(rng.integers(0, ut.shape[0], 256), device="cuda")
            step(i, ut[idx], ft[idx], un[idx])
        torch.cuda.synchronize()
        if w:
            windows.append(1e3 * (time.perf_counter() - tic) / 10)

    def three_steps():
        for i in range(3):
            idx = torch.as_tensor(rng.integers(0, ut.shape[0], 256), device="cuda")
            step(i, ut[idx], ft[idx], un[idx])

    return sorted(windows)[1], _busy(torch, three_steps)


def _jelly_surrogates(torch):
    """(dataset root, surrogate folder) of phase 12; built here (synthetic
    sims, force labels, one step per surrogate) when phase 13 runs alone."""
    from diffphycon_tpu_torch.apps import generate_jellyfish_forces, train_surrogates_jellyfish
    from diffphycon_tpu_torch.training.data import synthetic_jellyfish

    work = os.path.join("build", "chip_smoke", "jellyfish")
    root, sur = os.path.join(work, "data"), os.path.join(work, "surrogates")
    if not all(os.path.isfile(os.path.join(sur, m, "params.pt"))
               for m in ("force", "simulator", "boundary_updater")):
        synthetic_jellyfish(JELLY_TRAIN_SIMS, os.path.join(root, "train_data"), seed=0)
        synthetic_jellyfish(JELLY_TEST_SIMS, os.path.join(root, "test_data"), seed=1)
        generate_jellyfish_forces.main(generate_jellyfish_forces.build_parser().parse_args(
            ["--dataset_path", root, "--splits", "train_data"]))
        for model in ("force", "simulator", "boundary_updater"):
            train_surrogates_jellyfish.main(train_surrogates_jellyfish.build_parser().parse_args(
                ["--dataset_path", root, "--model", model, "--num_steps", "1",
                 "--batch_size", str(TRAIN_B), "--results_folder", sur]))
    return root, sur


def _mpc_records(torch, smi_line):
    """Phase 13, part 7: infer_jellyfish --inference_method MPC at batch 8 on
    phase 12's surrogates (replanning iterations cut to BASE_MPC_ITERS), then
    one replanning iteration at t = 0 (the full 19-step horizon) timed alone
    and projected to the default run, and one at t = 15 profiled; then
    --inference_method MPC_LBFGS over MPC_LBFGS_FRAMES frames and a replan
    at t = 0 of MPC_LBFGS_ITERS timed L-BFGS iterations."""
    from diffphycon_tpu_torch.apps import infer_jellyfish
    from diffphycon_tpu_torch.apps.infer_jellyfish import _surrogates
    from diffphycon_tpu_torch.baselines import lbfgs
    from diffphycon_tpu_torch.baselines.mpc_jellyfish import mpc_objective
    from diffphycon_tpu_torch.benchmarks import jellyfish as tbench
    from diffphycon_tpu_torch.training.data import load_jellyfish_dataset

    t0 = time.time()
    root, sur = _jelly_surrogates(torch)
    out = os.path.join("build", "chip_smoke", "baselines", "mpc")
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tic = time.perf_counter()
    agg = infer_jellyfish.main(infer_jellyfish.build_parser().parse_args(
        ["--inference_method", "MPC", "--dataset_path", root, "--surrogate_folder", sur,
         "--n_test_samples", str(JELLY_B), "--batch_size", str(JELLY_B),
         "--frames", str(MPC_FRAMES), "--num_iters", str(BASE_MPC_ITERS),
         "--inference_result_path", out]))
    torch.cuda.synchronize()
    app_s = time.perf_counter() - tic
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not math.isfinite(agg["objective"]):
        fail(f"non-finite MPC objective: {agg}")
    row = json.loads(open(os.path.join(out, "results.json")).read().splitlines()[-1])
    if row["metrics"] != agg:
        fail("infer_jellyfish MPC wrote another row than it returned")

    cfg = tbench.JellyfishConfig()
    data = load_jellyfish_dataset(root, "test", n=JELLY_B)
    ppl = tbench.SurrogatePipeline(cfg, *_surrogates(tbench, cfg, sur, "cuda"),
                                   p_min=float(data["norm"]["p_min"]),
                                   p_max=float(data["norm"]["p_max"]))
    s0, b0, th0 = (torch.as_tensor(data[k][:, 0], device="cuda")
                   for k in ("states", "bd", "thetas"))
    num_t = cfg.frames - 1
    plan0 = 0.7 * torch.rand(JELLY_B, num_t, generator=torch.Generator().manual_seed(0)) + 0.2
    realized = torch.zeros(JELLY_B, num_t, device="cuda")

    def one_iteration(t=0):
        plan = plan0.to("cuda").requires_grad_(True)
        opt = torch.optim.Adam([plan], lr=0.05)
        mpc_objective(ppl, plan, s0, b0, th0, realized, t, th0, 1000.0, 0.0, 0.0,
                      0.15).backward()
        opt.step()

    one_iteration()  # warm-up
    times = []
    for _ in range(MPC_TIMED_ITERS):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        one_iteration()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - tic)
    iter_s = sorted(times)[MPC_TIMED_ITERS // 2]
    # profiled at a 4-step horizon (t = 15): the same ops per step, and the
    # profiler's bookkeeping grows with the event count
    profile = _busy(torch, lambda: one_iteration(num_t - 4))
    horizons = sum(num_t - t for t in range(num_t))  # pipeline steps over all replans
    emit({"phase": "baselines_mpc", "app": "diffphycon_tpu_torch/apps/infer_jellyfish.py",
          "batch": JELLY_B, "frames": cfg.frames, "app_frames": MPC_FRAMES,
          "num_iters": BASE_MPC_ITERS,
          "result": agg, "app_s": app_s, "peak_memory_gb": peak,
          "replan_iteration_t0_s": times, "replan_iteration_t0_median_s": iter_s,
          "replan_iteration_t15_profile": profile,
          "planned_steps_per_iteration_sweep": horizons,
          "projected_default_batch_s": 30 * iter_s * horizons / num_t,
          "projection": "30 iterations x sum of the shrinking horizons (190 pipeline "
                        "steps) at the t = 0 iteration's time per step of 19",
          "nvidia_smi": smi_line, "seconds": round(time.time() - t0, 3)})

    # MPC_LBFGS: the app over MPC_LBFGS_FRAMES frames (one iteration per
    # replan), then a replan at t = 0 (the full 19-step horizon) cut to
    # MPC_LBFGS_ITERS iterations, each timed with its value-and-gradient
    # evaluations (its own plus the line search's trials)
    t0 = time.time()
    out = os.path.join("build", "chip_smoke", "baselines", "mpc_lbfgs")
    shutil.rmtree(out, ignore_errors=True)
    tic = time.perf_counter()
    agg = infer_jellyfish.main(infer_jellyfish.build_parser().parse_args(
        ["--inference_method", "MPC_LBFGS", "--dataset_path", root, "--surrogate_folder", sur,
         "--n_test_samples", str(JELLY_B), "--batch_size", str(JELLY_B),
         "--frames", str(MPC_LBFGS_FRAMES), "--num_iters", "1",
         "--inference_result_path", out]))
    torch.cuda.synchronize()
    app_s = time.perf_counter() - tic
    row = json.loads(open(os.path.join(out, "results.json")).read().splitlines()[-1])
    if not math.isfinite(agg["objective"]) or row["metrics"] != agg:
        fail(f"infer_jellyfish MPC_LBFGS: {agg}, written {row['metrics']}")

    def objective(p):
        return mpc_objective(ppl, p, s0, b0, th0, realized, 0, th0, 1000.0, 0.0, 0.0, 0.15)

    torch.cuda.reset_peak_memory_stats()
    plan, state, iters = plan0.to("cuda"), lbfgs.init(plan0.to("cuda")), []
    for _ in range(MPC_LBFGS_ITERS):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        value, grad = lbfgs.value_and_grad(objective, plan)
        updates, state = lbfgs.update(grad, state, plan, value, objective, learning_rate=0.05)
        plan = (plan + updates).clamp(0.2, 1.1)
        torch.cuda.synchronize()
        iters.append({"s": time.perf_counter() - tic, "objective": float(value),
                      "evaluations": 1 + state.num_linesearch_steps,
                      "step_size": float(state.stepsize)})
    peak = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "baselines_mpc_lbfgs", "app": "diffphycon_tpu_torch/apps/infer_jellyfish.py",
          "batch": JELLY_B, "app_frames": MPC_LBFGS_FRAMES, "app_num_iters": 1, "result": agg,
          "app_s": app_s, "replan_t0_iterations": iters, "peak_memory_gb": peak,
          "s_per_evaluation": sum(i["s"] for i in iters) / sum(i["evaluations"] for i in iters),
          "adam_iteration_t0_median_s": iter_s,
          "nvidia_smi": smi_line, "seconds": round(time.time() - t0, 3)})
    if not all(math.isfinite(i["objective"]) for i in iters) or not torch.isfinite(plan).all():
        fail(f"L-BFGS replan at t = 0: {iters}")


def baselines_phase(torch, smi_line):
    """Phase 13: the baselines at the apps' default widths: the Burgers
    solver forward and SL gradient (checkpoint on and off, peak memory), the
    SL objective on CUDA against the CPU, train_burgers_operator,
    eval_pid_sl_burgers (pid, sl, sl_surrogate), train_baselines_burgers
    (bc, bppo, sac), train_sac_burgers, and infer_jellyfish MPC."""
    from diffphycon_tpu_torch.apps import (
        eval_pid_sl_burgers,
        train_baselines_burgers,
        train_burgers_operator,
        train_sac_burgers,
    )

    t_phase = time.time()
    torch.cuda.empty_cache()
    _solver_records(torch, smi_line)
    work = os.path.join("build", "chip_smoke", "baselines")
    shutil.rmtree(work, ignore_errors=True)
    op_dir = os.path.join(work, "operator")

    t0 = time.time()
    op = train_burgers_operator.main(train_burgers_operator.build_parser().parse_args(
        ["--num_steps", str(BASE_OP_STEPS), "--data_root", os.path.join(work, "data"),
         "--results_folder", op_dir]))
    if not all(math.isfinite(v) for v in op["losses"]):
        fail(f"train_burgers_operator: non-finite losses {op['losses']}")
    warm_ms, op_profile = _operator_step_ms(torch, op["checkpoint"], os.path.join(work, "data"))
    emit({"phase": "baselines_operator",
          "app": "diffphycon_tpu_torch/apps/train_burgers_operator.py", "batch": 256,
          "steps": BASE_OP_STEPS, "app_ms_per_step": 1e3 * op["train_s"] / BASE_OP_STEPS,
          "warm_ms_per_step": warm_ms, "profile_3_steps": op_profile,
          "first_loss": op["losses"][0], "last_loss": op["losses"][-1],
          "final_one_step_rel_l2": op["final_one_step_rel_l2"],
          "seconds": round(time.time() - t0, 3), "nvidia_smi": smi_line})

    t0 = time.time()
    rows = {}
    for method in ("pid", "sl", "sl_surrogate"):
        tic = time.perf_counter()
        out = eval_pid_sl_burgers.main(eval_pid_sl_burgers.build_parser().parse_args(
            ["--n_test", str(BASE_B), "--pid_steps", str(BASE_OPT_STEPS),
             "--sl_steps", str(BASE_OPT_STEPS), "--methods", method, "--operator_folder", op_dir,
             "--save_file", os.path.join(work, "baselines.json")]))
        torch.cuda.synchronize()
        app_s = time.perf_counter() - tic
        if [r["method"] for r in out] != [method] or not math.isfinite(out[0]["J_actual_mse"]):
            fail(f"eval_pid_sl_burgers {method}: {out}")
        rows[method] = {**out[0], "app_s": app_s, "s_per_opt_step": app_s / BASE_OPT_STEPS}
    emit({"phase": "baselines_pid_sl", "app": "diffphycon_tpu_torch/apps/eval_pid_sl_burgers.py",
          "n_test": BASE_B, "opt_steps": BASE_OPT_STEPS, "solver_dt": 1e-3, "rows": rows,
          "note": "s_per_opt_step: the app's wall time over its Adam steps (it includes the "
                  "target solve and the scoring solve)", "nvidia_smi": smi_line,
          "seconds": round(time.time() - t0, 3)})

    t0 = time.time()
    rl_rows = {}
    for method in ("bc", "bppo", "sac"):
        res = train_baselines_burgers.main(train_baselines_burgers.build_parser().parse_args(
            ["--method", method, "--save_file", os.path.join(work, "baselines.json")]
            + [a for k, v in BASE_RL_STEPS.items() for a in (f"--{k}", str(v))]))
        if not math.isfinite(res["J_actual_mse"]):
            fail(f"train_baselines_burgers {method}: {res}")
        rl_rows[method] = {**res, "ms_per_update": 1e3 * res["update_s"] / res["updates"]}
    emit({"phase": "baselines_rl", "app": "diffphycon_tpu_torch/apps/train_baselines_burgers.py",
          "hidden": 512, "depth": 2, "steps": BASE_RL_STEPS, "rows": rl_rows,
          "nvidia_smi": smi_line, "seconds": round(time.time() - t0, 3)})

    t0 = time.time()
    sac = train_sac_burgers.main(train_sac_burgers.build_parser().parse_args(
        ["--num_episode", "2", "--save_file", os.path.join(work, "sac.json")]))
    if not math.isfinite(sac["J_actual_mse"]):
        fail(f"train_sac_burgers: {sac}")
    emit({"phase": "baselines_sac_online", "app": "diffphycon_tpu_torch/apps/train_sac_burgers.py",
          "episodes": 2, "updates_per_step": 50, "batch": 1024,
          "J_actual_mse": sac["J_actual_mse"], "control_energy": sac["control_energy"],
          "ms_per_update": 1e3 * sac["update_s"] / sac["updates"],
          "seconds": round(time.time() - t0, 3), "nvidia_smi": smi_line})

    _mpc_records(torch, smi_line)

    t0 = time.time()
    rec, ok = _conv_nets_cpu_check(torch)
    emit({"phase": "baselines_conv_nets_cuda_vs_cpu", **rec,
          "seconds": round(time.time() - t0, 3)})
    if not ok:
        fail(f"the operator or the conv SAC nets differ between CUDA and the CPU: {rec}")
    emit({"phase": "baselines_done", "seconds": round(time.time() - t_phase, 3)})


def _smoke_env_cpu_check(torch):
    """One SmokeRLEnv episode of RL_ENV_FRAMES control frames of 8 sub-steps
    at batch 2 on CUDA (K4 in every sub-step) against the CPU (the plain
    CG), from densities at the target bucket's mouth and on the same
    actions: observations, rewards and metrics, and K4's launches."""
    import numpy as np

    from diffphycon_tpu_torch.baselines.envs import SmokeRLEnv
    from diffphycon_tpu_torch.kernels import cg_pressure as kcg

    rng = np.random.default_rng(5)
    acts = np.zeros((RL_ENV_FRAMES, 2, 64, 64, 2), np.float32)
    acts[..., 1] = 0.4
    acts = np.clip(acts + 0.5 * rng.normal(size=acts.shape), -1, 1).astype(np.float32)
    d0 = np.zeros((2, 128, 128), np.float32)
    d0[0, 104:116, 56:70] = 1.0
    d0[1, 30:40, 40:50] = 1.0
    out = {}
    for dev in ("cpu", "cuda"):
        env = SmokeRLEnv(frames=RL_ENV_FRAMES, w_energy=0.01, device=dev)
        kcg.cg_pressure.launches = 0
        tic = time.perf_counter()
        obs, rew = [env.reset(2, np.random.default_rng(0), density0=d0)], []
        for a in acts:
            o, r, _ = env.step(a)
            obs.append(o)
            rew.append(r)
        out[dev] = (torch.stack(obs).cpu(), torch.stack(rew).cpu(), env.metrics(),
                    kcg.cg_pressure.launches, time.perf_counter() - tic)
    (oc, rc, mc, _, sc), (og, rg, mg, launches, sg) = out["cpu"], out["cuda"]
    obs_err, rew_err = (og - oc).abs().max().item(), (rg - rc).abs().max().item()
    rec = {"batch": 2, "frames": RL_ENV_FRAMES, "sub_steps": 8, "k4_launches": launches,
           "k4_launches_expected": RL_ENV_FRAMES * 8, "obs_max_abs_err": obs_err,
           "obs_tol": RL_ENV_RTOL * max(1.0, oc.abs().max().item()),
           "reward_max_abs_err": rew_err, "reward_max": rc.abs().max().item(),
           "reward_tol": RL_ENV_RTOL * max(1.0, rc.abs().max().item()),
           "metrics_cpu": mc, "metrics_cuda": mg, "cpu_seconds": sc, "cuda_seconds": sg}
    ok = (obs_err <= rec["obs_tol"] and rew_err <= rec["reward_tol"]
          and all(abs(mg[k] - mc[k]) <= RL_ENV_RTOL * max(1.0, abs(mc[k])) for k in mc)
          and launches == RL_ENV_FRAMES * 8 and bool(torch.isfinite(og).all()))
    return rec, ok


def _median_s(torch, fn, n):
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - tic)
    return sorted(times)[n // 2]


def _sac_update_ms(torch, sac, obs_shape, act_shape):
    """ms per warm ``SAC.update`` from a replay of 1024 random transitions:
    2 untimed updates, then the median of 3 windows of 5."""
    import numpy as np

    from diffphycon_tpu_torch.baselines.rl import RingReplay

    rng = np.random.default_rng(2)
    replay = RingReplay(1024, obs_shape, act_shape)
    obs = rng.random((1024, *replay.state.shape[1:]), np.float32)
    replay.push_batch(obs, rng.uniform(-1, 1, (1024, *replay.action.shape[1:])),
                      rng.normal(size=1024), obs[::-1], np.ones(1024))
    for _ in range(2):
        sac.update(replay)
    return 1e3 * _median_s(torch, lambda: [sac.update(replay) for _ in range(5)], 3) / 5


def rl_env_phase(torch, smi_line):
    """Phase 14: the smoke and jellyfish RL baselines at the apps' default
    widths (the 128^2 solver with K4 in every sub-step, 64^2 observations,
    MLPs 512 x 2, the conv SAC at batch 64; phase 12's surrogates, MLP SAC
    at batch 256), counts cut: the smoke env on CUDA against the CPU, s per
    control frame and env step, K4's share, SAC update times, both apps for
    bc, bppo and sac (K4's launches counted over the smoke app runs), and
    the apps' default runs projected from those times."""
    import numpy as np

    from diffphycon_tpu_torch.apps import train_baselines_jellyfish, train_baselines_smoke
    from diffphycon_tpu_torch.baselines.envs import SmokeRLEnv
    from diffphycon_tpu_torch.baselines.rl import SAC, ConvGaussPolicy, ConvQ
    from diffphycon_tpu_torch.kernels import cg_pressure as kcg
    from diffphycon_tpu_torch.training.data import load_jellyfish_dataset

    t_phase = time.time()
    torch.cuda.empty_cache()
    rec, ok = _smoke_env_cpu_check(torch)
    emit({"phase": "rl_smoke_env_cuda_vs_cpu", **rec, "tol": RL_ENV_RTOL,
          "seconds": round(time.time() - t_phase, 3)})
    if not ok:
        fail(f"SmokeRLEnv on CUDA (K4) differs from the CPU (plain CG): {rec}")

    # s per control frame (8 sub-steps, 8 K4 solves) at batch 1 and 4, and
    # K4's share of two profiled frames at batch 4
    t0 = time.time()
    env = SmokeRLEnv(device="cuda")
    frame = {}
    for b in (1, 4):
        env.reset(b, np.random.default_rng(1))
        a = torch.zeros(b, 64, 64, 2, device="cuda")
        a[..., 1] = 0.4
        env.step(a)  # warm-up
        frame[b] = _median_s(torch, lambda a=a: env.step(a), 5)
    wall_ms, dev_ms, rows = profile_window(torch, lambda: [env.step(a) for _ in range(2)])
    k4_ms = sum(v for k, v in rows if "cg_cluster_kernel" in k)
    sac = SAC(64 * 64 * 4, 64 * 64 * 2, seed=0, batch_size=RL_SAC_B,
              policy=ConvGaussPolicy(in_channels=4, action_channels=2),
              q_module=lambda: ConvQ(in_channels=6), action_shape=(64, 64, 2), device="cuda")
    conv_sac_ms = _sac_update_ms(torch, sac, (64, 64, 4), (64, 64, 2))
    del sac
    emit({"phase": "rl_smoke_env_timing", "s_per_control_frame": {"batch_1": frame[1],
                                                                  "batch_4": frame[4]},
          "profile_2_frames_batch_4": {"wall_ms": wall_ms, "device_ms": dev_ms,
                                       "busy_share": dev_ms / wall_ms, "k4_ms": k4_ms,
                                       "k4_share_of_wall": k4_ms / wall_ms,
                                       "top": [[k[:60], v] for k, v in rows[:6]]},
          "conv_sac_update_ms_batch_64": conv_sac_ms, "nvidia_smi": smi_line,
          "seconds": round(time.time() - t0, 3)})
    if not k4_ms > 0:
        fail("the profiled control frames show no K4 time")

    # the smoke app for bc, bppo and sac, K4's launches counted over them
    t0 = time.time()
    work = os.path.join("build", "chip_smoke", "rl")
    shutil.rmtree(work, ignore_errors=True)
    cut = [a for k, v in RL_SMOKE_CUT.items() for a in (f"--{k}", str(v))]
    smoke_rows = {}
    kcg.cg_pressure.launches = 0
    for method in ("bc", "bppo", "sac"):
        tic = time.perf_counter()
        row = train_baselines_smoke.main(train_baselines_smoke.build_parser().parse_args(
            ["--method", method, "--save_file", os.path.join(work, "smoke.json")] + cut))
        torch.cuda.synchronize()
        smoke_rows[method] = {**row, "app_s": time.perf_counter() - tic,
                              "ms_per_update": 1e3 * row["update_s"] / row["updates"]}
    launches = kcg.cg_pressure.launches
    rounds = -(-RL_SMOKE_CUT["sac_steps"] // (2 * 32))
    episodes = 3 * (RL_SMOKE_CUT["n_episodes"] + 1) + 2 * rounds
    emit({"phase": "rl_smoke_app", "app": "diffphycon_tpu_torch/apps/train_baselines_smoke.py",
          "cut": RL_SMOKE_CUT, "rows": smoke_rows, "k4_launches": launches,
          "k4_launches_expected": 256 * episodes, "nvidia_smi": smi_line,
          "seconds": round(time.time() - t0, 3)})
    if launches != 256 * episodes:
        fail(f"K4 launched {launches} times over the smoke RL apps, expected {256 * episodes}")
    if not all(math.isfinite(r[k]) for r in smoke_rows.values()
               for k in ("J_target", "smoke_out", "J_energy")):
        fail(f"non-finite smoke RL metrics: {smoke_rows}")

    # the jellyfish app on phase 12's surrogates; s per env step at batch 1
    # and 8, ms per MLP SAC update at batch 256 on the full observation
    t0 = time.time()
    root, sur = _jelly_surrogates(torch)
    jargs = ["--dataset_path", root, "--surrogate_folder", sur]
    jenv, cfg = train_baselines_jellyfish.build_env(
        train_baselines_jellyfish.build_parser().parse_args(jargs), torch.device("cuda"))
    test = load_jellyfish_dataset(root, "test", n=JELLY_B)
    step = {}
    for b in (1, JELLY_B):
        jenv.reset(test["states"][:b, 0], test["bd"][:b, 0], test["thetas"][:b, 0])
        act = torch.full((b, 1), 0.3, device="cuda")
        jenv.step(act)  # warm-up
        step[b] = _median_s(torch, lambda act=act: jenv.step(act), 5)
    obs_dim = jenv.obs_dim(cfg.n_state)
    sac = SAC(obs_dim, 1, 512, 2, seed=0, batch_size=256, device="cuda")
    mlp_sac_ms = _sac_update_ms(torch, sac, obs_dim, 1)
    del sac, jenv
    cut = [a for k, v in RL_JELLY_CUT.items() for a in (f"--{k}", str(v))]
    jelly_rows = {}
    for method in ("bc", "bppo", "sac"):
        tic = time.perf_counter()
        row = train_baselines_jellyfish.main(train_baselines_jellyfish.build_parser().parse_args(
            jargs + ["--method", method, "--save_file", os.path.join(work, "jelly.json")] + cut))
        torch.cuda.synchronize()
        jelly_rows[method] = {**row, "app_s": time.perf_counter() - tic,
                              "ms_per_update": 1e3 * row["update_s"] / row["updates"]}
    if not all(math.isfinite(r["J_jellyfish"]) for r in jelly_rows.values()):
        fail(f"non-finite jellyfish RL metrics: {jelly_rows}")

    # the apps' default runs projected from these times (their episode,
    # step and update counts at the JAX apps' defaults)
    f1, f4, j1, j8 = frame[1], frame[4], step[1], step[JELLY_B]
    ms = {m: {k: r["ms_per_update"] / 1e3 for k, r in rows.items()}
          for m, rows in (("smoke", smoke_rows), ("jelly", jelly_rows))}
    smoke_env = 8 * 32 * f1 + 32 * f4  # 8 behavior episodes, the eval at n_test 4
    jelly_env = 16 * 19 * j1 + 20 * j8  # 16 offline sims, the eval at n_test 8
    projected = {
        "smoke": {"bc": smoke_env + 1000 * ms["smoke"]["bc"],
                  "bppo": smoke_env + 2100 * ms["smoke"]["bppo"],
                  "sac": smoke_env + 8 * (2 * 32 * f1 + 64 * conv_sac_ms / 1e3)},
        "jellyfish": {"bc": jelly_env + 2000 * ms["jelly"]["bc"],
                      "bppo": jelly_env + 4200 * ms["jelly"]["bppo"],
                      "sac": jelly_env + 25 * (4 * 20 * j1 + 80 * mlp_sac_ms / 1e3)}}
    emit({"phase": "rl_jellyfish_app",
          "app": "diffphycon_tpu_torch/apps/train_baselines_jellyfish.py", "cut": RL_JELLY_CUT,
          "rows": jelly_rows, "s_per_env_step": {"batch_1": j1, f"batch_{JELLY_B}": j8},
          "obs_dim": obs_dim, "mlp_sac_update_ms_batch_256": mlp_sac_ms,
          "projected_default_run_s": projected,
          "projection": "episodes x frames x s per control frame / env step at the apps' "
                        "batch (behavior and online batch 1, eval n_test) + updates x ms per "
                        "update (bc, bppo: the app run's mean over its learners; sac: the "
                        "warm update); smoke sac 8 rounds of 2 episodes and 64 updates, "
                        "jellyfish sac 25 rounds of 4 episodes and 80 updates",
          "nvidia_smi": smi_line, "seconds": round(time.time() - t0, 3)})
    emit({"phase": "rl_done", "seconds": round(time.time() - t_phase, 3)})
    return launches


FUSE_STEPS = 20      # phase 15: guided DDPM steps per timed run, fused and two-call
POST_HOC_T = (500, 499, 498)  # phase 15: post-hoc-guidance DDPM steps
DDP_APP_STEPS = 5    # phase 15: train_burgers steps under the one-rank NCCL group
DDP_WINDOWS, DDP_WINDOW_STEPS = 2, 4  # phase 15: timed windows per turn, steps each
KS_B = 32
# KS over 400 ETDRK4 steps: a relative perturbation of 1e-7 in u0 grows to
# 5e-7 of max |u| (measured on the CPU at batch 32), cuFFT and pocketfft
# differ by summation order: 1e-4 leaves two orders of margin
KS_RTOL = 1e-4


def _ddpm_run(torch, gd, x, ts, cond_vals, guidance, noises):
    """x after the DDPM steps ts with the given noises, and the seconds."""
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for t, noise in zip(ts, noises):
        x = gd.ddpm_step(x, t, cond_vals, guidance, noise=noise)
    torch.cuda.synchronize()
    return x, time.perf_counter() - tic


def remaining_modules_phase(torch, smi_line, per_forward):
    """Phase 15: the modules of the last port slice at full width (UNet2D
    dim 64, mults (1, 2, 4, 8)): the two-stream step against the two-call step,
    post-hoc guidance, the pred_x0 / pred_v losses, a one-rank NCCL
    data-parallel trainer and train app, batch-sharded sampling, a reference
    checkpoint round trip and the KS solver. per_forward: the kernel
    launches of one UNet2D forward. Run alone:
    ``chip_smoke.remaining_modules_phase(torch, smi, chip_smoke.expected_counts(
    chip_smoke.main_path_calls(64, (1, 2, 4, 8), 50)))``."""
    import contextlib
    from unittest import mock

    import torch.distributed as dist

    from diffphycon_tpu_torch.apps import train_burgers
    from diffphycon_tpu_torch.benchmarks import burgers as bench
    from diffphycon_tpu_torch.diffusion import GaussianDiffusion, core
    from diffphycon_tpu_torch.kernels import unet2d_blocks as kb
    from diffphycon_tpu_torch.parallel import make_mesh, sample_sharded
    from diffphycon_tpu_torch.parallel.dryrun import free_port
    from diffphycon_tpu_torch.physics import ks
    from diffphycon_tpu_torch.training import data
    from diffphycon_tpu_torch.training.trainer import Trainer, TrainerConfig
    from diffphycon_tpu_torch.utils.convert import load_reference_checkpoint_unet2d

    work = os.path.join("build", "chip_smoke")
    data_root = os.path.join(work, "data")
    t_phase = time.time()
    cfg = bench.BurgersConfig(is_condition_u0=True, is_condition_uT=True)
    net = bench.init_params(cfg, seed=0, device="cuda")
    net_w = bench.init_params(cfg, seed=1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(15)
    u_target = torch.randn(B, 11, 128, generator=gen, device="cuda")
    cond_vals = {"u0": u_target[:, 0, :] / bench.RESCALER,
                 "uT": u_target[:, 10, :] / bench.RESCALER}
    guidance = bench.build_guidance(cfg, u_target, wu=1000.0)

    def step_counts(n_forwards):
        return {k: n_forwards * v for k, v in per_forward.items()}

    # 15a. the two forwards of a two-model step on two CUDA streams
    # (core.two_forwards, the port's fuse_two_models) against its plain
    # version, the forwards one after the other: the same x_T and noises, in
    # turns (two-call, fused, fused, two-call)
    t0 = time.time()
    gd = bench.build_diffusion(cfg, net, model_w=net_w, device="cuda")

    def in_turn(model, x, model_w, x_w, tb):
        return model(x, tb), model_w(x_w, tb)

    def form(name):
        return (mock.patch.object(core, "two_forwards", in_turn) if name == "two_call"
                else contextlib.nullcontext())

    ts = gd.sample_ts()[2:2 + FUSE_STEPS]
    x_t = gd.sample_init(B, gen)
    noises = [torch.randn(x_t.shape, generator=gen, device="cuda") for _ in ts]
    with torch.no_grad():
        for name in ("two_call", "fused"):  # warm-up
            with form(name):
                _ddpm_run(torch, gd, x_t, ts[:2], cond_vals, guidance, noises[:2])
        runs = {"two_call": [], "fused": []}
        outs = {}
        for name in ("two_call", "fused", "fused", "two_call"):
            kb.reset_launch_counts()
            with form(name):
                outs[name], dt = _ddpm_run(torch, gd, x_t, ts, cond_vals, guidance, noises)
            counts = kb.launch_counts()
            runs[name].append(FUSE_STEPS / dt)
            if counts != step_counts(2 * FUSE_STEPS):
                fail(f"{name} guided DDPM: launches {counts} != "
                     f"{step_counts(2 * FUSE_STEPS)} (two forwards a step)")
        busy = {}
        for name in ("two_call", "fused"):
            with form(name):
                wall_ms, dev_ms, rows = profile_window(
                    torch, lambda: _ddpm_run(torch, gd, x_t, ts[:3], cond_vals, guidance,
                                             noises[:3]))
            busy[name] = {"steps": 3, "wall_ms": wall_ms, "device_ms": dev_ms,
                          "busy_share": dev_ms / wall_ms}
    err = (outs["fused"] - outs["two_call"]).abs().max().item()
    tol = DDIM_RTOL * max(1.0, outs["two_call"].abs().max().item())
    emit({"phase": "fuse_two_models", "batch": B, "steps": FUSE_STEPS,
          "order": ["two_call", "fused", "fused", "two_call"],
          "steps_per_sec": runs, "launches_per_step": step_counts(2),
          "bit_equal": bool(torch.equal(outs["fused"], outs["two_call"])),
          "max_abs_err": err, "tol": tol, "profile": busy, "nvidia_smi": smi_line,
          "seconds": round(time.time() - t0, 3)})
    if not err <= tol or not torch.isfinite(outs["fused"]).all():
        fail(f"fused guided DDPM differs from the two-call step: {err} > {tol}")
    del outs, noises

    # 15b. post-hoc guidance (guidance_u0=False): kernel against plain
    # forwards, the same noises for both DDPM passes of each step
    t0 = time.time()
    gd_post = bench.build_diffusion(cfg, net, model_w=net_w, device="cuda")
    gd_post_plain = bench.build_diffusion(cfg, net.forward_plain,
                                          model_w=net_w.forward_plain, device="cuda")
    x = torch.randn(x_t.shape, generator=gen, device="cuda")
    noise_pairs = [(torch.randn(x.shape, generator=gen, device="cuda"),
                    torch.randn(x.shape, generator=gen, device="cuda")) for _ in POST_HOC_T]
    results = []
    with torch.no_grad():
        for gd in (gd_post, gd_post_plain):
            gd.guidance_u0 = False
            kb.reset_launch_counts()
            y = x
            for t, (n1, n2) in zip(POST_HOC_T, noise_pairs):
                y = gd.ddpm_step(y, t, cond_vals, guidance, noise=n1, guided_noise=n2)
            torch.cuda.synchronize()
            results.append((y, kb.launch_counts()))
    (y_k, counts), (y_p, _) = results
    err = (y_k - y_p).abs().max().item()
    tol = DDIM_RTOL * max(1.0, y_p.abs().max().item())
    emit({"phase": "post_hoc_guidance", "batch": B, "steps": list(POST_HOC_T),
          "max_abs_err": err, "tol": tol, "launches": counts,
          "finite": bool(torch.isfinite(y_k).all()), "seconds": round(time.time() - t0, 3)})
    if not err <= tol or not torch.isfinite(y_k).all():
        fail(f"post-hoc guided DDPM: kernel forwards differ from plain: {err} > {tol}")
    if counts != step_counts(2 * len(POST_HOC_T)):
        fail(f"post-hoc guided DDPM: launches {counts} != {step_counts(2 * len(POST_HOC_T))}")
    del gd, gd_post, gd_post_plain

    # 15c. the pred_x0 / pred_v objectives at batch 16: kernel against plain
    t0 = time.time()
    u, f = data.synthetic_burgers(64, seed=0, cache_dir=os.path.join(data_root, "synthetic"),
                                  device="cuda")
    stacked = data.stack_burgers_uf(u, f, rescaler=bench.RESCALER)
    xb = torch.from_numpy(stacked[:TRAIN_B]).cuda()
    cond = bench.build_diffusion(cfg, net, device="cuda").cond
    objectives = {}
    for objective in ("pred_x0", "pred_v"):
        gds = [GaussianDiffusion(m, sample_shape=(cfg.pad_t, cfg.nx, 2), objective=objective,
                                 cond=cond, device="cuda")
               for m in (net, net.forward_plain)]
        t, noise = gds[0].draw_t_noise(xb, gen)
        net.zero_grad(set_to_none=True)
        kb.reset_launch_counts()
        loss_k = gds[0].p_losses(xb, t, bench.derive_cond(xb), noise)
        loss_k.backward()
        torch.cuda.synchronize()
        counts = kb.launch_counts()
        grads_finite = all(torch.isfinite(p.grad).all() for p in net.parameters())
        with torch.no_grad():
            loss_p = gds[1].p_losses(xb, t, bench.derive_cond(xb), noise)
        rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        objectives[objective] = {"loss_kernels": loss_k.item(), "loss_plain": loss_p.item(),
                                 "rel_err": rel, "grads_finite": grads_finite,
                                 "launches": counts}
        if not rel <= UNET_RTOL or not grads_finite:
            fail(f"{objective} p_losses: kernels {loss_k.item()} vs plain {loss_p.item()} "
                 f"(rel {rel} > {UNET_RTOL}) or non-finite gradients")
        if counts != step_counts(1):
            fail(f"{objective} p_losses: launches {counts} != {step_counts(1)}")
    net.zero_grad(set_to_none=True)
    emit({"phase": "objectives", "batch": TRAIN_B, "tol": UNET_RTOL, **objectives,
          "seconds": round(time.time() - t0, 3)})

    # 15d. data parallel: a one-rank NCCL group (one card), the DDP trainer's
    # first step against the plain trainer's, both timed in turns, the train
    # app under the group, then batch-sharded sampling
    t0 = time.time()
    mesh = make_mesh(device="cuda", rank=0, world_size=1, local_rank=0,
                     init_method=f"tcp://localhost:{free_port()}")
    try:
        trainers = {}
        for name in ("plain", "ddp"):
            m = bench.init_params(cfg, seed=0, device="cuda").train()
            trainers[name] = Trainer(
                bench.build_diffusion(cfg, m, device="cuda"), m,
                data.ArrayDataset(stacked).batches(TRAIN_B, seed=1), bench.derive_cond,
                TrainerConfig(results_folder=os.path.join(work, f"ddp_{name}"), seed=3),
                mesh=mesh if name == "ddp" else None, device=None if name == "ddp" else "cuda")
        if trainers["ddp"].ddp is None:
            fail("the one-rank NCCL mesh did not wrap the model in DistributedDataParallel")
        first = {}
        for name, tr in trainers.items():
            kb.reset_launch_counts()
            loss = tr.compute_grads(xb).item()
            torch.cuda.synchronize()
            first[name] = (loss, {n: p.grad.detach().clone()
                                  for n, p in zip(tr.param_names, tr.params)},
                           kb.launch_counts())
        rel = {n: ((first["ddp"][1][n] - g).norm() / g.norm().clamp_min(1e-30)).item()
               for n, g in first["plain"][1].items()}
        worst = max(rel.values())
        loss_rel = abs(first["ddp"][0] - first["plain"][0]) / abs(first["plain"][0])
        bit_equal = all(torch.equal(first["ddp"][1][n], g) for n, g in first["plain"][1].items())
        del first
        for tr in trainers.values():
            tr.apply_gradients()
        timing = {"plain": [], "ddp": []}
        for name in ("plain", "ddp", "ddp", "plain"):
            tr = trainers[name]
            tr.train_step(next(tr.batch_iter))  # warm-up
            # the median of DDP_WINDOWS windows of DDP_WINDOW_STEPS steps
            timing[name].append(1e3 / DDP_WINDOW_STEPS * _median_s(
                torch, lambda: [tr.train_step(next(tr.batch_iter))
                                for _ in range(DDP_WINDOW_STEPS)], DDP_WINDOWS))
        del trainers
        emit({"phase": "ddp_step", "world_size": mesh.world_size, "backend": dist.get_backend(),
              "batch": TRAIN_B, "loss_rel_err": loss_rel, "max_rel_grad_err": worst,
              "grads_bit_equal": bit_equal, "tol": GRAD_RTOL,
              "order": ["plain", "ddp", "ddp", "plain"], "ms_per_step": timing,
              "nvidia_smi": smi_line, "seconds": round(time.time() - t0, 3)})
        if not (worst <= GRAD_RTOL and loss_rel <= GRAD_RTOL):
            fail(f"the DDP step differs from the plain step: loss {loss_rel}, grads {worst}")

        t0 = time.time()
        folder = os.path.join(work, "trained_models", "burgers", "ddp")
        shutil.rmtree(folder, ignore_errors=True)
        args = train_burgers.build_parser().parse_args([
            "--synthetic_data", "64", "--batch_size", str(TRAIN_B), "--train_num_steps",
            str(DDP_APP_STEPS), "--checkpoint_interval", str(DDP_APP_STEPS),
            "--is_condition_u0", "True", "--is_condition_uT", "True", "--data_root", data_root,
            "--results_folder", folder, "--seed", "0"])
        kb.reset_launch_counts()
        trainer = train_burgers.main(args)
        torch.cuda.synchronize()
        counts = kb.launch_counts()
        log = [json.loads(line) for line in open(os.path.join(folder, "train_log.jsonl"))]
        emit({"phase": "ddp_train_app", "app": "diffphycon_tpu_torch/apps/train_burgers.py",
              "steps": trainer.step, "ddp": trainer.ddp is not None, "launches": counts,
              "log": log, "seconds": round(time.time() - t0, 3)})
        if trainer.ddp is None or trainer.step != DDP_APP_STEPS:
            fail(f"train app under the mesh: ddp {trainer.ddp is not None}, step {trainer.step}")
        if counts != step_counts(DDP_APP_STEPS):
            fail(f"train app under the mesh: launches {counts} != {step_counts(DDP_APP_STEPS)}")
        if not log or not all(math.isfinite(r["loss"]) for r in log):
            fail(f"train app under the mesh: non-finite or missing losses {log}")
        del trainer

        t0 = time.time()
        cfg_ddim = bench.BurgersConfig(is_condition_u0=True, is_condition_uT=True,
                                       using_ddim=True, ddim_sampling_steps=10)
        gd = bench.build_diffusion(cfg_ddim, net, model_w=net_w, device="cuda")
        with torch.no_grad():
            kb.reset_launch_counts()
            tic = time.perf_counter()
            xs = sample_sharded(mesh, gd, B, cond_vals, guidance,
                                torch.Generator(device="cuda").manual_seed(4))
            torch.cuda.synchronize()
            sharded_s = time.perf_counter() - tic
            counts = kb.launch_counts()
            ref = gd.sample(B, cond_vals, guidance, torch.Generator(device="cuda").manual_seed(4))
        err = (xs - ref).abs().max().item()
        tol = DDIM_RTOL * max(1.0, ref.abs().max().item())
        emit({"phase": "sharded_sampling", "world_size": mesh.world_size, "batch": B,
              "sampler": "ddim 10 steps, eta 0, two models, wu=1000", "max_abs_err": err,
              "tol": tol, "seconds_sampling": sharded_s, "launches": counts,
              "seconds": round(time.time() - t0, 3)})
        if not err <= tol or not torch.isfinite(xs).all():
            fail(f"sharded sampling differs from gd.sample: {err} > {tol}")
        if counts != step_counts(2 * 10):
            fail(f"sharded sampling: launches {counts} != {step_counts(20)}")
    finally:
        dist.destroy_process_group()

    # 15e. a reference Trainer checkpoint written from the net and loaded on
    # CUDA
    t0 = time.time()
    path = os.path.join(work, "reference_model.pt")
    torch.save({"step": 1, "model": {f"model.{k}": v.cpu() for k, v in net_w.state_dict().items()},
                "ema": {f"ema_model.model.{k}": v.cpu() for k, v in net.state_dict().items()},
                "opt": {}, "scaler": None, "loss": 0.0}, path)
    loaded = load_reference_checkpoint_unet2d(bench.build_unet(cfg, "cuda"), path)
    x = torch.randn(B, cfg.pad_t, cfg.nx, 2, generator=gen, device="cuda")
    tt = torch.linspace(0, 999, B, device="cuda")
    with torch.no_grad():
        same = torch.equal(loaded(x, tt), net(x, tt))
    emit({"phase": "reference_checkpoint", "file_mb": os.path.getsize(path) / 1e6,
          "forward_bit_equal": same, "seconds": round(time.time() - t0, 3)})
    if not same:
        fail("the reference checkpoint's EMA weights do not give the net's forward")
    os.remove(path)

    # 15f. the KS solver at batch 32: CUDA against the CPU, timed
    t0 = time.time()
    u0, f = (torch.from_numpy(a) for a in ks.make_ks_data(KS_B, seed=0))
    ref = ks.ks_solve(u0, f)
    ks.ks_solve(u0.cuda(), f.cuda())  # warm-up (cuFFT plans)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    out = ks.ks_solve(u0.cuda(), f.cuda())
    torch.cuda.synchronize()
    ks_s = time.perf_counter() - tic
    err = (out.cpu() - ref).abs().max().item()
    tol = KS_RTOL * max(1.0, ref.abs().max().item())
    emit({"phase": "ks_solve", "batch": KS_B, "frames": 10, "substeps": 40,
          "seconds_cuda": ks_s, "us_per_step": 1e6 * ks_s / 400, "max_abs_err": err,
          "tol": tol, "finite": bool(torch.isfinite(out).all()), "nvidia_smi": smi_line,
          "seconds": round(time.time() - t0, 3)})
    if not err <= tol or not torch.isfinite(out).all():
        fail(f"ks_solve on CUDA differs from the CPU: {err} > {tol}")
    emit({"phase": "remaining_modules_done", "seconds": round(time.time() - t_phase, 3)})


def jellyfish_phase(torch, smi_line):
    """Phase 12: the jellyfish pipeline at full width: synthetic sims,
    force labels, the three surrogates (UNet2Dv2 / ForceUNet dim 64, mults (1,
    2, 4, 8), 64x64), the states (EBM) and thetas UNet3Ds (dim 64, mults (1,
    2, 4), input (16, 20, 64, 64, 7)) at batch 16, guided inference at batch
    8 with closed-loop scoring, timed guided DDIM and DDPM steps, and the
    CUDA-against-CPU check."""
    import numpy as np

    from diffphycon_tpu_torch.apps import (
        generate_jellyfish_forces,
        infer_jellyfish,
        train_jellyfish,
        train_surrogates_jellyfish,
    )
    from diffphycon_tpu_torch.benchmarks import jellyfish as tbench
    from diffphycon_tpu_torch.training.data import load_jellyfish_dataset, synthetic_jellyfish

    t0 = time.time()
    work = os.path.join("build", "chip_smoke", "jellyfish")
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "data")
    synthetic_jellyfish(JELLY_TRAIN_SIMS, os.path.join(root, "train_data"), seed=0)
    synthetic_jellyfish(JELLY_TEST_SIMS, os.path.join(root, "test_data"), seed=1)
    tic = time.perf_counter()
    generate_jellyfish_forces.main(generate_jellyfish_forces.build_parser().parse_args(
        ["--dataset_path", root, "--splits", "train_data"]))
    torch.cuda.synchronize()
    forces_s = time.perf_counter() - tic
    if not all(np.isfinite(np.load(os.path.join(root, "train_data", "forces",
                                                f"sim_{i:06d}.npy"))).all()
               for i in range(JELLY_TRAIN_SIMS)):
        fail("non-finite jellyfish force labels")
    sur = os.path.join(work, "surrogates")
    surrogates = {}
    for model in ("force", "simulator", "boundary_updater"):
        tic = time.perf_counter()
        state, last = train_surrogates_jellyfish.main(
            train_surrogates_jellyfish.build_parser().parse_args(
                ["--dataset_path", root, "--model", model, "--num_steps", "3",
                 "--batch_size", str(TRAIN_B), "--log_every", "1", "--results_folder", sur]))
        torch.cuda.synchronize()
        surrogates[model] = {"steps": state.step, "last_loss": last,
                             "seconds": time.perf_counter() - tic}
        if not (last is not None and math.isfinite(last)):
            fail(f"surrogate {model}: non-finite loss {last}")
    emit({"phase": "jellyfish_data_and_surrogates", "train_sims": JELLY_TRAIN_SIMS,
          "test_sims": JELLY_TEST_SIMS, "force_label_seconds": forces_s,
          "surrogates": surrogates, "batch": TRAIN_B, "seconds": round(time.time() - t0, 3)})

    # the states (EBM) and thetas models through the train app at batch 16
    t0 = time.time()
    data = load_jellyfish_dataset(root, "train")
    trained = {}
    for model_type, sub in (("states", "jellyfish"), ("thetas", "jellyfish_w")):
        folder = os.path.join(work, sub)

        def run(accum):
            shutil.rmtree(folder, ignore_errors=True)
            tr = train_jellyfish.main(train_jellyfish.build_parser().parse_args(
                ["--dataset_path", root, "--model_type", model_type, "--train_num_steps", "2",
                 "--checkpoint_interval", "2", "--batch_size", str(TRAIN_B),
                 "--grad_accum", str(accum), "--results_folder", folder]))
            return tr, [json.loads(line)["loss"]
                        for line in open(os.path.join(folder, "train_log.jsonl"))]

        (tr, app_losses), accum, why = _fit(torch, run, TRAIN_B)
        if not app_losses or not all(math.isfinite(v) for v in app_losses):
            fail(f"train_jellyfish ({model_type}): non-finite losses {app_losses}")
        batches = train_jellyfish.window_batches(data["states"], data["bd"], data["thetas"],
                                                 TRAIN_B, 20, seed=3)
        trained[model_type] = {
            "batch": TRAIN_B, "app_grad_accum": accum, "why_accum": why, "app_steps": 2,
            "app_losses": app_losses, "remat_all_default": True,
            # the EBM with remat on (the default) is timed in phase 17, in turns
            # with its bf16 step
            "timing": _timed_remat(torch, tr, lambda: tuple(
                torch.as_tensor(a, device="cuda") for a in next(batches)),
                (False,) if model_type == "states" else (True, False))}
        del tr
        torch.cuda.empty_cache()
    emit({"phase": "jellyfish_train", "app": "diffphycon_tpu_torch/apps/train_jellyfish.py",
          "input": [TRAIN_B, 20, 64, 64, 7], "warm_windows_steps": REMAT_TIMING,
          "models": trained, "nvidia_smi": smi_line,
          "seconds": round(time.time() - t0, 3)})

    # guided inference at batch 8 (DDIM cut to a few steps) with closed-loop
    # scoring, then 3 timed steps each of a guided DDIM and of the default
    # 1000-step DDPM loop
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    agg = infer_jellyfish.main(infer_jellyfish.build_parser().parse_args([
        "--dataset_path", root, "--n_test_samples", str(JELLY_TEST_SIMS),
        "--batch_size", str(JELLY_B), "--joint_folder", os.path.join(work, "jellyfish"),
        "--w_folder", os.path.join(work, "jellyfish_w"), "--diffusion_joint_checkpoint", "2",
        "--diffusion_w_checkpoint", "2", "--surrogate_folder", sur,
        "--sampling_timesteps", str(JELLY_DDIM_STEPS),
        "--inference_result_path", os.path.join(work, "results")]))
    torch.cuda.synchronize()
    infer_peak = torch.cuda.max_memory_allocated() / 1e9
    finite = all(math.isfinite(agg[k]) for k in ("objective", "objective_closed_loop",
                                                 "theta_mae_vs_gt"))
    if not finite:
        fail(f"non-finite jellyfish objectives: {agg}")

    from diffphycon_tpu_torch.apps.infer_jellyfish import _diffusion_net, _surrogates

    cfg = tbench.JellyfishConfig()
    _, net_force, net_bd = _surrogates(tbench, cfg, sur, "cuda")
    joint = _diffusion_net(tbench.build_joint_unet, cfg, os.path.join(work, "jellyfish"), 2,
                           True, "cuda")
    thetas = _diffusion_net(tbench.build_thetas_unet, cfg, os.path.join(work, "jellyfish_w"),
                            2, True, "cuda")
    test = load_jellyfish_dataset(root, "test", n=JELLY_B)
    s0, b0, th0 = (torch.as_tensor(test[k][:, 0], device="cuda")
                   for k in ("states", "bd", "thetas"))
    design_fn = tbench.make_force_design_fn(cfg, net_force, net_bd, -1.0, 1.0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    step_s = {}
    for name, steps in (("ddim", 10), ("ddpm", 1000)):  # a warm-up step, then 3 timed
        gd = tbench.JellyfishDiffusion(
            tbench.JellyfishConfig(sampling_timesteps=steps), joint, thetas_model=thetas,
            bd_updater=net_bd, device="cuda")
        cond = gd._cond(s0, b0, th0)
        x = gd.sample_init(s0, b0, th0, generator=gen)
        ts = gd.sample_ts()
        x = gd.step(x, ts[0], cond, design_fn, gen)
        torch.cuda.synchronize()
        tic = time.perf_counter()
        for ts_i in ts[1:4]:
            x = gd.step(x, ts_i, cond, design_fn, gen)
        torch.cuda.synchronize()
        step_s[name] = (time.perf_counter() - tic) / 3
        if not torch.isfinite(x).all():
            fail(f"non-finite jellyfish samples ({name})")
    emit({"phase": "jellyfish_infer", "app": "diffphycon_tpu_torch/apps/infer_jellyfish.py",
          "sampler": f"guided ddim {JELLY_DDIM_STEPS} steps, eta 0, batch {JELLY_B}, "
                     "joint + thetas UNet3D, bd-updater in the loop, force guidance",
          "result": agg, "finite": finite, "peak_memory_gb": infer_peak,
          "guided_step_s": step_s, "steps_timed": 3,
          "projected_default_ddpm_run_s": 1000 * step_s["ddpm"],
          "rollout_s": agg["rollout_s"], "nvidia_smi": smi_line,
          "seconds": round(time.time() - t0, 3)})
    del joint, thetas, net_force, net_bd, gd, x
    torch.cuda.empty_cache()

    t0 = time.time()
    rec, ok = _jelly_cpu_check(torch, tbench)
    emit({"phase": "jellyfish_cuda_vs_cpu", **rec, "seconds": round(time.time() - t0, 3)})
    if not ok:
        fail(f"jellyfish on CUDA differs from the CPU: {rec}")


# phase 16 (bf16 weights on the Burgers path, the Pallas kernels'
# weight_dtype=bfloat16): the kernels with a bf16 variant
BF16_KERNELS = ("conv2d_nhwc", "downsample_nhwc", "linear_attention_block", "attention_block")
BF16ACT_KERNELS = ("conv2d_nhwc", "downsample_nhwc", "group_norm_act",
                   "linear_attention_block", "attention_block")
BF16_PEAK = 989e12   # H100 SXM dense bf16 tensor-core FLOP/s
# a bf16 variant against its bf16 plain version on the same inputs: both
# round the same operands to bf16 and sum exact products in fp32, so they
# differ in summation order, and (K5, K6) where a ChanLN output summed in
# another order lies an fp32 ulp apart and rounds to the neighbouring bf16
# value; the CPU tests' per-block bound (tests/test_torch_port_bf16.py)
BF16_KERNEL_RTOL = 2e-3
# the bf16 UNet2D's kernel forward against its plain forward: the blocks'
# rounding flips cascade through 17 ResBlocks (on the CPU a 1e-7 relative
# change of the input moves the dim-8 bf16 net by 6.6e-3); the CPU tests'
# whole-net bound
BF16_UNET_RTOL = 1e-2
# the bf16 forward differs from the fp32 forward by more than this, so a
# silent fp32 path fails (the CPU tests' guard)
BF16_GUARD = 1e-3
# one training step at batch 16, CUDA (kernels) against the CPU (plain
# versions): the loss and the parameter gradients (relative norm per
# tensor), apart by the forwards' rounding flips; measured 1.2e-5 and
# 2.0e-3 on an H100 80GB HBM3 at 700 W, so a 100x and a 10x margin
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_RTOL = 2e-2
# K1 and K2 see the same activations as their plain versions (no flips:
# 2e-7 to 4e-7 measured) and are 1.5e-3 to 2.1e-3 from the plain version on
# unrounded activations; a kernel that rounded nothing would sit there, so
# the bf16 variant must be 10x closer to its plain version than that
BF16_ROUNDING_MARGIN = 10
BF16_DDPM_STEPS = 20
BF16_TRAIN_STEPS = 6


def attention_plan_bf16(ka, kname, args):
    """The host plan of K5's or K6's bf16 variant at one site: K5a's chunks
    and head groups, K5b's and K6's tiles over the flattened (B n) tokens,
    and each stage's CTAs."""
    b, h, w, c = args
    tiles = -(-b * h * w // 64)
    if kname == "attention_block":
        return {"tile_rows": ka.attn_tile_rows(b, h * w, bf16=True), "k6a_ctas": 3 * tiles,
                "k6c_ctas": tiles * -(-c // 128)}
    _, _, _, n_chunks, chunk, groups = ka._linear_shapes((b, h, w, c), True)[0]
    tr, ctas = ka.la_output_plan(b, h * w, c)
    return {"chunk": chunk, "S": n_chunks, "head_groups": groups,
            "k5a_ctas": b * n_chunks * groups, "k5b_tile_rows": tr,
            "k5b_tiles": -(-b * h * w // tr), "k5b_ctas": ctas}


def bf16_phase(torch, F, smi_line, calls):
    """Phase 16: bf16 weights on the Burgers path (``BurgersConfig(bf16=True,
    impl="pallas")``, ``infer_burgers --impl pallas --bf16 True``):
    each bf16 variant (K1, K2, K5, K6) at every signature of one forward at
    batch 50 against its bf16 plain version, bit-equal repeats, timed (event
    pairs, device time from a CUDA graph, the plain version, cuDNN's bf16
    conv for K1/K2, SDPA on K6's q, k, v) beside its bound at the bf16 rate;
    the bf16 UNet2D's kernel forward against its plain forward with the
    launch counts of one forward (every K1, K2, K5, K6 launch a bf16 one),
    timed beside the fp32 forward in turns; ``apps/infer_burgers.py``
    ``main()`` with ``--bf16 True`` (two seeded models, DDIM 50, batch 50);
    guided DDPM at batch 50, bf16 and fp32 in turns; one training step's
    loss and gradients on CUDA against the CPU, ``apps/train_burgers.py``
    ``main()`` with ``--bf16 True`` (float32 checkpoints), and the training
    step bf16 beside fp32 in turns. Returns the kernels line's bf16
    records."""
    from diffphycon_tpu_torch.apps import infer_burgers, train_burgers
    from diffphycon_tpu_torch.benchmarks import burgers as bench
    from diffphycon_tpu_torch.kernels import attention as ka
    from diffphycon_tpu_torch.kernels import unet2d_blocks as kb
    from diffphycon_tpu_torch.training import data
    from diffphycon_tpu_torch.training.trainer import Trainer, TrainerConfig

    t_phase = time.time()
    work = os.path.join("build", "chip_smoke")
    data_root = os.path.join(work, "data")
    gen = torch.Generator(device="cuda").manual_seed(16)

    # 16a. the bf16 variants at every signature of one forward
    t0 = time.time()
    per_fwd = {}
    for k, a, _ in calls:
        if k in BF16_KERNELS:
            per_fwd[(k, a)] = per_fwd.get((k, a), 0) + 1
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms",
            "max_abs_err")
    agg = {k: dict.fromkeys(keys, 0.0) for k in BF16_KERNELS}
    bad = []
    with torch.no_grad():
        for (kname, args), count in per_fwd.items():
            kern, plain, library, flops, nbytes, extra = kernel_case(torch, F, kb, gen, kname,
                                                                     args, bf16=True)
            unrounded = extra.pop("unrounded")
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            scale = max(1.0, ref.abs().max().item())
            tol = BF16_KERNEL_RTOL * scale
            gap = (out - unrounded()).abs().max().item()
            repeat_equal = torch.equal(out, kern())
            ms, plain_ms = timed(torch, kern), timed(torch, plain)
            lib_ms = None if library is None else timed(torch, library)
            dev_ms, why = timed_graph(torch, kern)
            extra_ms = {f"{key}_ms": timed(torch, fn) for key, fn in extra.items()}
            b_ms, b_by = bound(flops, nbytes, BF16_PEAK)
            tc = {}
            if kname in ("linear_attention_block", "attention_block"):
                tc = {"plan": attention_plan_bf16(ka, kname, args)}
                for key in ("k5a", "k5b") if kname == "linear_attention_block" else ():
                    tc[f"{key}_device_ms"] = timed_graph(torch, extra[key])[0]
            if kname in TC_KERNELS:
                plan = kb.tile_plan(*gemm_dims(kname, args), True)
                tc = {"tile_plan": {"bm": plan.bm, "bn": plan.bn, "splits": plan.splits,
                                    "per": plan.per},
                      "tflop_per_s": flops / ms / 1e9}
            emit({"phase": "kernel_bf16", "kernel": kname, "args": list(args),
                  "per_forward": count, "max_abs_err": err, "tol": tol,
                  "rel_err": err / scale, "unrounded_gap": gap / scale,
                  "repeat_bit_equal": repeat_equal, "ms": ms, "device_ms": dev_ms,
                  **({"device_ms_error": why} if why else {}), "plain_ms": plain_ms,
                  "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                  "gflop": flops / 1e9, "mbytes": nbytes / 1e6, **extra_ms, **tc})
            if not err <= tol:
                bad.append((kname, args, err, tol))
            if not repeat_equal:
                bad.append((kname, args, "two calls are not bit-equal"))
            if kname in TC_KERNELS and not gap >= BF16_ROUNDING_MARGIN * err:
                bad.append((kname, args, f"{gap} from the unrounded plain version, {err} "
                                         "from the bf16 one: the activations are not rounded"))
            a = agg[kname]
            for key, v in (("ms", ms), ("device_ms", dev_ms), ("plain_ms", plain_ms),
                           ("library_ms", lib_ms), ("bound_ms", b_ms),
                           ("ops_ms", 1e3 * flops / BF16_PEAK),
                           ("bytes_ms", 1e3 * nbytes / HBM_RATE)):
                a[key] = None if v is None or a[key] is None else a[key] + count * v
            a["max_abs_err"] = max(a["max_abs_err"], err)
            del out, ref
    emit({"phase": "kernels_bf16_checked", "signatures": len(per_fwd), "tol_rel": BF16_KERNEL_RTOL,
          "seconds": round(time.time() - t0, 3)})
    if bad:
        fail(f"bf16 kernel mismatches: {bad}")
    torch.cuda.empty_cache()

    # 16b. the bf16 UNet2D: kernel forward against the plain forward, its
    # launches, and beside the fp32 forward
    t0 = time.time()
    cfg16 = bench.BurgersConfig(is_condition_u0=True, is_condition_uT=True, bf16=True,
                                impl="pallas")
    cfg32 = bench.BurgersConfig(is_condition_u0=True, is_condition_uT=True)
    nets = {"bf16": bench.init_params(cfg16, seed=0, device="cuda"),
            "fp32": bench.init_params(cfg32, seed=0, device="cuda")}
    x = torch.randn(B, cfg16.pad_t, cfg16.nx, 2, generator=gen, device="cuda")
    t = torch.linspace(0, 999, B, device="cuda")
    with torch.no_grad():
        kb.reset_launch_counts()
        out = nets["bf16"](x, t)
        torch.cuda.synchronize()
        counts = kb.launch_counts()
        ref = nets["bf16"].forward_plain(x, t)
        out32 = nets["fp32"](x, t)
        scale = max(1.0, ref.abs().max().item())
        err = (out - ref).abs().max().item()
        gap32 = (out - out32).abs().max().item() / max(1.0, out32.abs().max().item())
        fwd_ms = {"bf16": [], "fp32": []}
        for order in (("fp32", "bf16"), ("bf16", "fp32")):
            for name in order:
                fwd_ms[name].append(timed(torch, lambda: nets[name](x, t), n=10))
    want = expected_counts(calls, bf16=True)
    emit({"phase": "unet2d_bf16", "max_abs_err": err, "tol": BF16_UNET_RTOL * scale,
          "rel_err": err / scale, "rel_gap_to_fp32": gap32, "guard": BF16_GUARD,
          "launches_per_forward": counts, "expected": want, "forward_ms_in_turns": fwd_ms,
          "finite": bool(torch.isfinite(out).all()), "nvidia_smi": smi_line,
          "seconds": round(time.time() - t0, 3)})
    if not err <= BF16_UNET_RTOL * scale or not torch.isfinite(out).all():
        fail(f"bf16 UNet2D kernel forward differs from its plain forward: {err / scale}")
    if counts != want:
        fail(f"bf16 launch counts per forward {counts} != expected {want}")
    if not gap32 > BF16_GUARD:
        fail(f"the bf16 forward is within {gap32} of the fp32 forward: not bf16")
    del out, ref, out32

    # 16c. the app's main path with --bf16 True
    t0 = time.time()
    app_args = infer_burgers.build_parser().parse_args([
        "--init_seed", "0", "--synthetic_data", str(B), "--n_test_samples", str(B),
        "--batch_size", str(B), "--eval_two_models", "True", "--wus", "1000",
        "--is_condition_u0", "True", "--is_condition_uT", "True", "--bf16", "True",
        "--impl", "pallas",
        "--using_ddim", "True", "--ddim_sampling_steps", "50", "--ddim_eta", "0",
        "--data_root", data_root, "--save_file", os.path.join(work, "result_bf16.json")])
    kb.reset_launch_counts()
    entry = infer_burgers.main(app_args)["wu=1000.0,wf=0.0"]
    torch.cuda.synchronize()
    app_counts = kb.launch_counts()
    finite = all(math.isfinite(v) for v in entry.values())
    emit({"phase": "main_path_bf16", "app": "diffphycon_tpu_torch/apps/infer_burgers.py",
          "sampler": "ddim 50 steps, eta 0, two models, wu=1000, batch 50, --bf16 True",
          "result": entry, "launches": app_counts, "finite": finite,
          "seconds": round(time.time() - t0, 3)})
    if not finite:
        fail(f"non-finite bf16 main-path metrics: {entry}")
    for k in BF16_KERNELS:
        if not app_counts[f"{k}.bf16"] > 0 or app_counts[k] != app_counts[f"{k}.bf16"]:
            fail(f"bf16 main path: {k} launched {app_counts[k]} times, "
                 f"{app_counts[f'{k}.bf16']} of them bf16")
    if not app_counts["group_norm_act"] > 0:
        fail("bf16 main path: K3 was not launched")

    # 16d. guided DDPM at batch 50, fp32 and bf16 in turns
    t0 = time.time()
    models_w = {"bf16": bench.init_params(cfg16, seed=1, device="cuda"),
                "fp32": bench.init_params(cfg32, seed=1, device="cuda")}
    u_target = torch.randn(B, 11, 128, generator=gen, device="cuda")
    cond_vals = {"u0": u_target[:, 0, :] / bench.RESCALER,
                 "uT": u_target[:, 10, :] / bench.RESCALER}
    guidance = bench.build_guidance(cfg32, u_target, wu=1000.0)
    gds = {name: bench.build_diffusion(cfg, nets[name], model_w=models_w[name], device="cuda")
           for name, cfg in (("bf16", cfg16), ("fp32", cfg32))}
    rates, ddpm_counts = {"bf16": [], "fp32": []}, None
    for order in (("fp32", "bf16"), ("bf16", "fp32"), ("fp32", "bf16")):
        for name in order:
            gd = gds[name]
            ts = gd.sample_ts()
            xg = torch.Generator(device="cuda").manual_seed(1)
            xt = gd.sample_chunk(gd.sample_init(B, xg), ts[:2], cond_vals, guidance, xg)
            torch.cuda.synchronize()
            if name == "bf16" and ddpm_counts is None:
                kb.reset_launch_counts()
            tic = time.perf_counter()
            xt = gd.sample_chunk(xt, ts[2:2 + BF16_DDPM_STEPS], cond_vals, guidance, xg)
            torch.cuda.synchronize()
            rates[name].append(BF16_DDPM_STEPS / (time.perf_counter() - tic))
            if name == "bf16" and ddpm_counts is None:
                ddpm_counts = kb.launch_counts()
            if not torch.isfinite(xt).all():
                fail(f"non-finite samples in the {name} guided DDPM loop")
    busy = {}
    for name, gd in gds.items():
        xg = torch.Generator(device="cuda").manual_seed(2)
        ts = gd.sample_ts()
        xt = gd.sample_init(B, xg)
        wall_ms, dev_ms, _ = profile_window(
            torch, lambda: gd.sample_chunk(xt, ts[:3], cond_vals, guidance, xg))
        busy[name] = {"steps": 3, "wall_ms": wall_ms, "device_ms": dev_ms,
                      "busy_share": dev_ms / wall_ms}
    want_steps = {k: 2 * BF16_DDPM_STEPS * v for k, v in want.items()}
    emit({"phase": "guided_ddpm_bf16", "batch": B, "steps_timed": BF16_DDPM_STEPS,
          "guided_denoise_steps_per_sec_in_turns": rates, "profile": busy,
          "launches_bf16_run": ddpm_counts, "expected": want_steps, "nvidia_smi": smi_line,
          "seconds": round(time.time() - t0, 3)})
    if ddpm_counts != want_steps:
        fail(f"bf16 guided DDPM launches {ddpm_counts} != {want_steps}")
    del gds, models_w
    torch.cuda.empty_cache()

    # 16e. training at batch 16: one step on CUDA against the CPU, the train
    # app with --bf16 True, then the step bf16 beside fp32 in turns
    t0 = time.time()
    u, f = data.synthetic_burgers(64, seed=0, cache_dir=os.path.join(data_root, "synthetic"),
                                  device="cuda")
    stacked = data.stack_burgers_uf(u, f, rescaler=bench.RESCALER)
    xb = torch.from_numpy(stacked[:TRAIN_B])
    steps = {}
    for dev in ("cuda", "cpu"):
        net = bench.init_params(cfg16, seed=0, device=dev).train()
        gd = bench.build_diffusion(cfg16, net, device=dev)
        if dev == "cuda":
            tn = gd.draw_t_noise(xb.to(dev), torch.Generator(device=dev).manual_seed(5))
        t_, noise = (v.to(dev) for v in tn)
        xd = xb.to(dev)
        loss = gd.p_losses(xd, t_, bench.derive_cond(xd), noise)
        loss.backward()
        steps[dev] = (loss.item(), {n: p.grad.detach().cpu() for n, p in net.named_parameters()})
        del net, gd
    loss_err = abs(steps["cuda"][0] - steps["cpu"][0]) / abs(steps["cpu"][0])
    rel = {n: ((steps["cuda"][1][n] - g).norm() / g.norm()).item()
           for n, g in steps["cpu"][1].items()}
    zero = [n for n, g in steps["cuda"][1].items() if not g.abs().max() > 0]
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    emit({"phase": "train_bf16_cuda_vs_cpu", "batch": TRAIN_B, "loss_cuda": steps["cuda"][0],
          "loss_cpu": steps["cpu"][0], "loss_rel_err": loss_err, "loss_tol": BF16_LOSS_RTOL,
          "max_rel_grad_err": worst[0][1], "worst": worst, "grad_tol": BF16_GRAD_RTOL,
          "grad_dtypes": sorted({str(g.dtype) for g in steps["cuda"][1].values()}),
          "zero_grads": zero, "seconds": round(time.time() - t0, 3)})
    if zero or not loss_err <= BF16_LOSS_RTOL or not worst[0][1] <= BF16_GRAD_RTOL:
        fail(f"bf16 training step: CUDA against the CPU, loss {loss_err}, gradients {worst}, "
             f"zero {zero[:5]}")
    del steps

    t0 = time.time()
    folder = os.path.join(work, "trained_models_bf16")
    shutil.rmtree(folder, ignore_errors=True)
    args = train_burgers.build_parser().parse_args([
        "--dim", str(DIM), "--dim_mults", *map(str, MULTS), "--device", "cuda", "--bf16", "True",
        "--synthetic_data", "64", "--batch_size", str(TRAIN_B), "--train_num_steps",
        str(BF16_TRAIN_STEPS), "--checkpoint_interval", str(BF16_TRAIN_STEPS),
        "--is_condition_u0", "True", "--is_condition_uT", "True", "--data_root", data_root,
        "--exp_id", "bf16", "--seed", "0", "--results_folder", folder])
    kb.reset_launch_counts()
    trainer = train_burgers.main(args)
    torch.cuda.synchronize()
    counts = kb.launch_counts()
    # train_burgers --bf16 True trains the flax dtype=bfloat16 net (JAX's
    # train_burgers has no --impl): every launch a bf16-activation one
    want = {k: BF16_TRAIN_STEPS * v for k, v in expected_counts(calls, bf16act=True).items()}
    log = [json.loads(line) for line in open(os.path.join(folder, "train_log.jsonl"))]
    saved = {use_ema: Trainer.load_params(folder, BF16_TRAIN_STEPS, use_ema=use_ema)
             for use_ema in (False, True)}
    saved_dtypes = sorted({str(v.dtype) for d in saved.values() for v in d.values()})
    emit({"phase": "train_app_bf16", "app": "diffphycon_tpu_torch/apps/train_burgers.py",
          "steps": trainer.step, "launches": counts, "expected": want, "log": log,
          "checkpoint_dtypes": saved_dtypes, "seconds": round(time.time() - t0, 3)})
    if trainer.step != BF16_TRAIN_STEPS or counts != want:
        fail(f"bf16 train app: step {trainer.step}, launches {counts} (want {want})")
    if not log or not all(math.isfinite(r["loss"]) for r in log):
        fail(f"bf16 train app: non-finite or missing losses {log}")
    if saved_dtypes != ["torch.float32"]:
        fail(f"bf16 train app: checkpoint params and EMA are {saved_dtypes}, not float32")
    del trainer

    t0 = time.time()
    trainers = {}
    for name, cfg in (("fp32", cfg32), ("bf16", cfg16)):
        net = bench.init_params(cfg, seed=0, device="cuda").train()
        trainers[name] = Trainer(
            bench.build_diffusion(cfg, net, device="cuda"), net,
            data.ArrayDataset(stacked).batches(TRAIN_B, seed=1), bench.derive_cond,
            TrainerConfig(results_folder=os.path.join(work, f"train_timing_{name}")),
            device="cuda")
    step_ms = {"fp32": [], "bf16": []}
    for order in (("fp32", "bf16"), ("bf16", "fp32")):
        for name in order:
            tr = trainers[name]
            tm = _step_timing(torch, tr, lambda: torch.as_tensor(next(tr.batch_iter),
                                                                 device="cuda"), 1, 1, 2)
            step_ms[name].append(tm["ms_per_step"])
            if not all(math.isfinite(v) for v in tm["losses"]):
                fail(f"non-finite {name} training losses: {tm['losses']}")
    emit({"phase": "train_timing_bf16", "batch": TRAIN_B, "ms_per_step_in_turns": step_ms,
          "windows_steps": [1, 2], "nvidia_smi": smi_line, "seconds": round(time.time() - t0, 3)})
    del trainers, nets
    torch.cuda.empty_cache()

    emit({"phase": "bf16_done", "seconds": round(time.time() - t_phase, 3)})
    records = []
    for k in BF16_KERNELS:
        a = agg[k]
        records.append({
            "name": f"{k}_bf16", "route": SOURCES[k][0], "source": SOURCES[k][1],
            "replaces": REPLACES[k] + " under weight_dtype=bfloat16 (pack_unet2d_params :665)",
            "launches": app_counts[f"{k}.bf16"], "max_abs_err": a["max_abs_err"],
            "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
            "bound_by": "operations" if a["ops_ms"] >= a["bytes_ms"] else "bytes",
            "library_ms": a["library_ms"], "device_ms": a["device_ms"]})
    return records


# phase 17 (the UNet3D in bf16: the JAX ``UNet3D(dtype=bfloat16)``, flax's
# compute dtype, which bench.py deploys for smoke and jellyfish)
# one bf16 training step on CUDA against the same step on the CPU: both in
# bf16, they differ where a sum in another order rounds to the neighbouring
# bf16 value, as the port against JAX does on the CPU
# (tests/test_torch_port_bf16_unet3d.py: LOSS_RTOL 2e-2 of the loss); the
# whole parameter gradient within BF16_3D_GRAD_RTOL in relative L2 norm
BF16_3D_LOSS_RTOL = 2e-2
BF16_3D_GRAD_RTOL = 5e-2
# the CPU check's nets: phase 12's CUDA-against-CPU size, at batch 16
BF16_3D_CPU = dict(dim=16, dim_mults=(1, 2, 4), frames=8, image_size=32)
BF16_3D_SMOKE_DDIM = 2   # infer_smoke --bf16 True: DDIM steps (calibration off)
BENCH_SMOKE_B, BENCH_JELLY_B = 4, 1  # bench.py's bf16 profiles' batches
BENCH_STEPS = 2  # steps timed per turn in the bench profiles


def _dtype_turns(torch, fns, n=3, warm=1, peak=True):
    """{name: [ms, ms]} of fns["fp32"] and fns["bf16"] timed in turns
    (fp32, bf16, bf16, fp32), and ({name: peak GB} of one call each, or
    {} without ``peak``)."""
    ms = {"fp32": [], "bf16": []}
    for name in ("fp32", "bf16", "bf16", "fp32"):
        ms[name].append(timed(torch, fns[name], n=n, warm=warm))
    peaks = {}
    for name, fn in fns.items() if peak else ():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
    return ms, peaks


def _train_turns(torch, trainers, batch_fns):
    """ms per optimizer step (one step per turn, fp32, bf16, bf16, fp32,
    synchronised) and the peak GB of each dtype's steps."""
    ms, peak = {"fp32": [], "bf16": []}, {"fp32": 0.0, "bf16": 0.0}
    for name in ("fp32", "bf16", "bf16", "fp32"):
        tr = trainers[name]
        batch = batch_fns[name]()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tic = time.perf_counter()
        loss = tr.train_step(batch)
        torch.cuda.synchronize()
        ms[name].append(1e3 * (time.perf_counter() - tic))
        peak[name] = max(peak[name], torch.cuda.max_memory_allocated() / 1e9)
        if not math.isfinite(float(loss)):
            fail(f"non-finite {name} training loss {loss}")
    return ms, peak


def _bf16_3d_cpu_check(torch):
    """One smoke p_losses step and one EBM step (double backward) of bf16
    UNet3Ds at BF16_3D_CPU and batch 16, on CUDA against the CPU with the
    same weights and draws: the losses, and the whole parameter gradient in
    relative L2 norm (float32 gradients, none missing)."""
    import copy

    from diffphycon_tpu_torch.benchmarks import jellyfish as jbench
    from diffphycon_tpu_torch.benchmarks import smoke as sbench
    from diffphycon_tpu_torch.diffusion import smoke_derive_cond

    g = torch.Generator().manual_seed(17)
    b, f, h = TRAIN_B, BF16_3D_CPU["frames"], BF16_3D_CPU["image_size"]
    scfg = sbench.SmokeConfig(bf16=True, **BF16_3D_CPU)
    jcfg = jbench.JellyfishConfig(bf16=True, **BF16_3D_CPU)
    x = 0.5 * torch.randn(b, f, h, h, 6, generator=g)
    ts = torch.randint(0, 1000, (b,), generator=g)
    noise = torch.randn(x.shape, generator=g)
    state0 = torch.rand(b, f, h, h, 3, generator=g) * 2 - 1
    bd0 = torch.randn(b, f, h, h, 3, generator=g)
    thetas0 = torch.randn(b, f, generator=g)
    tj = torch.randint(0, 1000, (b,), generator=g)
    noise_j = torch.randn(state0.shape, generator=g)
    nets_cpu = {"smoke": sbench.init_params(scfg, seed=0, device="cpu").train(),
                "ebm": jbench.build_joint_unet(jcfg, seed=1, device="cpu").train()}
    out = {}
    for dev in ("cpu", "cuda"):
        res = {}
        for name, net0 in nets_cpu.items():
            net = copy.deepcopy(net0).to(dev)
            tic = time.perf_counter()
            if name == "smoke":
                gd = sbench.build_diffusion(scfg, net, device=dev)
                xd = x.to(dev)
                loss = gd.p_losses(xd, ts.to(dev), smoke_derive_cond(xd), noise.to(dev))
            else:
                gd = jbench.JellyfishDiffusion(jcfg, net, device=dev)
                loss = gd.p_losses_states(*(a.to(dev) for a in (state0, bd0, thetas0, tj,
                                                                noise_j)))
            loss.backward()
            if dev == "cuda":
                torch.cuda.synchronize()
            grads = [p.grad for p in net.parameters()]
            res[name] = (loss.item(), grads, time.perf_counter() - tic)
        out[dev] = res
    rec, ok = {"batch": b, **BF16_3D_CPU, "loss_tol": BF16_3D_LOSS_RTOL,
               "grad_tol": BF16_3D_GRAD_RTOL}, True
    for name in nets_cpu:
        (lc, gc, sc), (lg, gg, sg) = out["cpu"][name], out["cuda"][name]
        complete = all(a is not None and c is not None and a.dtype == torch.float32
                       for a, c in zip(gg, gc))
        if complete:
            vc = torch.cat([v.reshape(-1) for v in gc])
            vg = torch.cat([v.reshape(-1).cpu() for v in gg])
            grad_err = ((vg - vc).norm() / vc.norm()).item()
        else:
            grad_err = math.inf
        rec[name] = {"loss_cpu": lc, "loss_cuda": lg, "loss_rel_err": abs(lg - lc) / abs(lc),
                     "grad_rel_l2_err": grad_err, "grads_fp32_complete": complete,
                     "cpu_seconds": sc, "cuda_seconds": sg}
        ok = ok and (rec[name]["loss_rel_err"] <= BF16_3D_LOSS_RTOL and math.isfinite(lg)
                     and grad_err <= BF16_3D_GRAD_RTOL)
    return rec, ok


def bf16_unet3d_phase(torch, smi_line):
    """Phase 17: the smoke and jellyfish UNet3Ds in bf16 (``SmokeConfig`` /
    ``JellyfishConfig(bf16=True)``: flax ``dtype=bf16`` on float32
    parameters; no kernel of their own, cuDNN bf16 convs). 17a: the smoke
    (8, 32, 64, 64, 6) and jellyfish joint (8, 20, 64, 64, 7) forwards, bf16
    and fp32 from the same weights in turns, their peak memory and the bf16
    output's distance from fp32 (above BF16_GUARD); 17b: ``train_smoke`` and
    ``train_jellyfish --model_type states`` (the EBM) at batch 16, one step
    each with ``--bf16 True`` (float32 checkpoints) and with fp32 (the EBM
    at the micro-batch phase 12 found), then one step of each in turns, ms
    and peak GB, and whether the bf16 EBM step takes batch 16 as one
    micro-batch; 17c: one smoke step and one EBM step of bf16 nets on CUDA
    against the CPU (:func:`_bf16_3d_cpu_check`); 17d: ``infer_smoke.main()``
    (two seeded bf16 UNet3Ds, batch 8, DDIM BF16_3D_SMOKE_DDIM, K4 in the
    evaluation rollout: exactly 255 launches) and ``infer_jellyfish.main()``
    (phase 12's checkpoints and surrogates, guided DDIM JELLY_DDIM_STEPS at
    batch 8) with ``--bf16 True``; 17e: bench.py's own bf16 profiles as
    records, the smoke two-model guided DDIM step at batch 4 and the
    jellyfish guided DDPM step at batch 1, bf16 and fp32 in turns. Needs
    the files of phases 7, 11 and 12 under build/chip_smoke (run it after
    them, as main does)."""
    from diffphycon_tpu_torch.apps import infer_jellyfish, infer_smoke, train_jellyfish
    from diffphycon_tpu_torch.apps import train_smoke
    from diffphycon_tpu_torch.benchmarks import jellyfish as jbench
    from diffphycon_tpu_torch.benchmarks import smoke as sbench
    from diffphycon_tpu_torch.kernels import cg_pressure as kcg
    from diffphycon_tpu_torch.training.data import load_jellyfish_dataset
    from diffphycon_tpu_torch.training.trainer import Trainer

    t_phase = time.time()
    work = os.path.join("build", "chip_smoke")
    out_dir = os.path.join(work, "bf16_unet3d")
    shutil.rmtree(out_dir, ignore_errors=True)
    jelly_root = os.path.join(work, "jellyfish", "data")
    smoke_train = os.path.join(work, "smoke_train_data")
    smoke_test = os.path.join(work, "smoke_data")
    for path in (jelly_root, smoke_train, smoke_test):
        if not os.path.isdir(path):
            fail(f"phase 17 needs {path}: run it after phases 7, 11 and 12")

    # 17a. forwards at batch 8, bf16 and fp32 in turns
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(170)
    fwd = {}
    for name, make, shape in (
            ("smoke", lambda bf: sbench.init_params(sbench.SmokeConfig(bf16=bf), seed=0,
                                                    device="cuda"), (SMOKE_B, 32, 64, 64, 6)),
            ("jellyfish_joint", lambda bf: jbench.build_joint_unet(
                jbench.JellyfishConfig(bf16=bf), seed=0, device="cuda"),
             (JELLY_B, 20, 64, 64, 7))):
        nets = {"fp32": make(False), "bf16": make(True)}
        x = torch.randn(*shape, generator=gen, device="cuda")
        t = torch.full((shape[0],), 500.0, device="cuda")
        with torch.no_grad():
            o32, o16 = nets["fp32"](x, t), nets["bf16"](x, t)
            gap = ((o16.float() - o32).abs().max() / o32.abs().max().clamp(min=1.0)).item()
            ms, peak = _dtype_turns(torch, {k: (lambda n=n: n(x, t)) for k, n in nets.items()})
        fwd[name] = {"input": list(shape), "forward_ms_in_turns": ms, "peak_memory_gb": peak,
                     "out_dtype": str(o16.dtype), "rel_gap_to_fp32": gap,
                     "finite": bool(torch.isfinite(o16).all())}
        if not (o16.dtype == torch.bfloat16 and gap > BF16_GUARD and fwd[name]["finite"]):
            fail(f"bf16 {name} UNet3D: {fwd[name]}")
        del nets, o32, o16, x
        torch.cuda.empty_cache()
    emit({"phase": "unet3d_bf16_forward", "models": fwd, "guard": BF16_GUARD,
          "nvidia_smi": smi_line, "seconds": round(time.time() - t0, 3)})

    # 17b. the train apps at batch 16: one step each, --bf16 True and fp32,
    # then steps in turns
    t0 = time.time()
    trainers, app_rec = {}, {}
    for model in ("smoke", "ebm"):
        trainers[model] = {}
        for name in ("fp32", "bf16"):
            folder = os.path.join(out_dir, f"{model}_{name}")

            def run(accum, folder=folder, name=name, model=model):
                shutil.rmtree(folder, ignore_errors=True)
                common = ["--batch_size", str(TRAIN_B), "--grad_accum", str(accum),
                          "--train_num_steps", "1", "--checkpoint_interval", "1",
                          "--bf16", str(name == "bf16"), "--results_folder", folder]
                if model == "smoke":
                    return train_smoke.main(train_smoke.build_parser().parse_args(
                        ["--dataset_path", smoke_train] + common))
                return train_jellyfish.main(train_jellyfish.build_parser().parse_args(
                    ["--dataset_path", jelly_root, "--model_type", "states"] + common))

            # the fp32 EBM starts at the micro-batch of 8 phase 12 needed
            first = 2 if (model, name) == ("ebm", "fp32") else 1
            tr, accum, why = _fit(torch, run, TRAIN_B, accum=first)
            torch.cuda.synchronize()
            saved = {use_ema: Trainer.load_params(folder, 1, use_ema=use_ema)
                     for use_ema in (False, True)}
            dtypes = sorted({str(v.dtype) for d in saved.values() for v in d.values()})
            app_rec[f"{model}_{name}"] = {"grad_accum": accum, "why_accum": why,
                                          "net_dtype": str(tr.model.dtype),
                                          "checkpoint_dtypes": dtypes, "step": tr.step}
            if tr.step != 1 or dtypes != ["torch.float32"] or not all(
                    p.dtype == torch.float32 for p in tr.params + tr.ema):
                fail(f"{model} train app ({name}): {app_rec[f'{model}_{name}']}")
            trainers[model][name] = tr
        if model == "smoke":
            batch_fns = {k: (lambda tr=tr: torch.as_tensor(next(tr.batch_iter), device="cuda"))
                         for k, tr in trainers[model].items()}
        else:
            data = load_jellyfish_dataset(jelly_root, "train")
            windows = train_jellyfish.window_batches(data["states"], data["bd"], data["thetas"],
                                                     TRAIN_B, 20, seed=3)
            batch_fns = dict.fromkeys(("fp32", "bf16"), lambda: tuple(
                torch.as_tensor(a, device="cuda") for a in next(windows)))
        ms, peak = _train_turns(torch, trainers[model], batch_fns)
        app_rec[f"{model}_ms_per_step_in_turns"] = ms
        app_rec[f"{model}_peak_memory_gb"] = peak
        del trainers[model]
        torch.cuda.empty_cache()
    ebm_fits = app_rec["ebm_bf16"]["grad_accum"] == 1
    emit({"phase": "unet3d_bf16_train", "batch": TRAIN_B,
          "apps": ["diffphycon_tpu_torch/apps/train_smoke.py",
                   "diffphycon_tpu_torch/apps/train_jellyfish.py --model_type states"],
          "runs": app_rec, "ebm_bf16_batch16_one_micro_batch": ebm_fits,
          "nvidia_smi": smi_line, "seconds": round(time.time() - t0, 3)})

    # 17c. CUDA against the CPU, bf16 on both
    t0 = time.time()
    rec, ok = _bf16_3d_cpu_check(torch)
    emit({"phase": "unet3d_bf16_cuda_vs_cpu", **rec, "seconds": round(time.time() - t0, 3)})
    if not ok:
        fail(f"bf16 UNet3D steps on CUDA differ from the CPU: {rec}")

    # 17d. the inference apps with --bf16 True
    t0 = time.time()
    kcg.cg_pressure.launches = 0
    agg = infer_smoke.main(infer_smoke.build_parser().parse_args([
        "--dataset_path", smoke_test, "--init_seed", "0", "--batch_size", str(SMOKE_B),
        "--n_test_samples", str(SMOKE_B), "--ddim_sampling_steps", str(BF16_3D_SMOKE_DDIM),
        "--ddim_eta", "1.0", "--calibrate", "False", "--bf16", "True",
        "--inference_result_path", os.path.join(out_dir, "smoke_results")]))
    torch.cuda.synchronize()
    cg_launches = kcg.cg_pressure.launches
    smoke_s = time.time() - t0
    jf = os.path.join(work, "jellyfish")
    tic = time.time()
    jagg = infer_jellyfish.main(infer_jellyfish.build_parser().parse_args([
        "--dataset_path", jelly_root, "--n_test_samples", str(JELLY_B),
        "--batch_size", str(JELLY_B), "--joint_folder", os.path.join(jf, "jellyfish"),
        "--w_folder", os.path.join(jf, "jellyfish_w"), "--diffusion_joint_checkpoint", "2",
        "--diffusion_w_checkpoint", "2", "--surrogate_folder", os.path.join(jf, "surrogates"),
        "--sampling_timesteps", str(JELLY_DDIM_STEPS), "--bf16", "True",
        "--inference_result_path", os.path.join(out_dir, "jellyfish_results")]))
    torch.cuda.synchronize()
    jelly_s = time.time() - tic
    finite = (all(math.isfinite(v) for v in agg.values())
              and all(math.isfinite(jagg[k]) for k in ("objective", "objective_closed_loop",
                                                        "theta_mae_vs_gt")))
    emit({"phase": "infer_bf16", "apps": ["diffphycon_tpu_torch/apps/infer_smoke.py",
                                          "diffphycon_tpu_torch/apps/infer_jellyfish.py"],
          "smoke": {"result": agg, "cg_launches": cg_launches, "cg_launches_expected": 255,
                    "sampler": f"ddim {BF16_3D_SMOKE_DDIM} steps, eta 1, two bf16 UNet3Ds, "
                               f"batch {SMOKE_B}, calibration off", "seconds": smoke_s},
          "jellyfish": {"result": jagg, "sampler": f"guided ddim {JELLY_DDIM_STEPS} steps, "
                        f"batch {JELLY_B}, bf16 joint + thetas UNet3D (phase 12's fp32 "
                        "checkpoints)", "seconds": jelly_s},
          "finite": finite, "seconds": round(time.time() - t0, 3)})
    if not finite:
        fail(f"non-finite bf16 inference metrics: {agg} {jagg}")
    if cg_launches != 255:
        fail(f"K4 launched {cg_launches} times in the bf16 smoke evaluation, expected 255")

    # 17e. bench.py's bf16 profiles (records), bf16 and fp32 in turns
    t0 = time.time()
    profiles = {}
    gds, runs = {}, {}
    for name in ("fp32", "bf16"):
        cfg = sbench.SmokeConfig(bf16=name == "bf16", ddim_sampling_steps=100)
        cfg_w = sbench.SmokeConfig(bf16=name == "bf16", ddim_sampling_steps=100,
                                   is_w_model=True)
        gds[name] = sbench.build_diffusion(
            cfg, sbench.init_params(cfg, seed=0, device="cuda"),
            model_w=sbench.init_params(cfg_w, seed=1, device="cuda"), device="cuda")
        guidance = sbench.build_guidance(cfg, device="cuda")
        cond = {"init": torch.randn(BENCH_SMOKE_B, 64, 64, generator=gen, device="cuda")}

        def run(gd=gds[name], guidance=guidance, cond=cond):
            xg = torch.Generator(device="cuda").manual_seed(5)
            ts = gd.sample_ts()
            x = gd.sample_chunk(gd.sample_init(BENCH_SMOKE_B, xg), ts[:BENCH_STEPS], cond,
                                guidance, xg)
            if not torch.isfinite(x).all():
                fail("non-finite samples in the smoke bench profile")

        runs[name] = run
    ms, _ = _dtype_turns(torch, runs, n=1, warm=1, peak=False)
    profiles["smoke_two_model_ddim"] = {
        "bench": "bench.py:202-233 (bench_smoke, bf16=True)", "batch": BENCH_SMOKE_B,
        "steps_per_turn": BENCH_STEPS,
        "steps_per_sec_in_turns": {k: [1e3 * BENCH_STEPS / v for v in vs]
                                   for k, vs in ms.items()}}
    del gds, runs
    torch.cuda.empty_cache()
    runs = {}
    test = load_jellyfish_dataset(jelly_root, "test", n=BENCH_JELLY_B)
    s0, b0, th0 = (torch.as_tensor(test[k][:, 0], device="cuda")
                   for k in ("states", "bd", "thetas"))
    for name in ("fp32", "bf16"):
        cfg = jbench.JellyfishConfig(bf16=name == "bf16", sampling_timesteps=1000)
        net_bd = jbench.build_bd_updater(cfg, seed=2, device="cuda")
        gd = jbench.JellyfishDiffusion(
            cfg, jbench.build_joint_unet(cfg, seed=0, device="cuda"),
            thetas_model=jbench.build_thetas_unet(cfg, seed=1, device="cuda"),
            bd_updater=net_bd, device="cuda")
        design_fn = jbench.make_force_design_fn(
            cfg, jbench.build_force_unet(cfg, seed=3, device="cuda"), net_bd, -1.0, 1.0)

        def run(gd=gd, design_fn=design_fn):
            xg = torch.Generator(device="cuda").manual_seed(6)
            cond = gd._cond(s0, b0, th0)
            x = gd.sample_init(s0, b0, th0, generator=xg)
            for ts_i in gd.sample_ts()[:BENCH_STEPS]:
                x = gd.step(x, ts_i, cond, design_fn, xg)
            if not torch.isfinite(x).all():
                fail("non-finite samples in the jellyfish bench profile")

        runs[name] = run
    ms, _ = _dtype_turns(torch, runs, n=1, warm=1, peak=False)
    profiles["jellyfish_guided_ddpm"] = {
        "bench": "bench.py:236-279 (bench_jellyfish, bf16=True)", "batch": BENCH_JELLY_B,
        "steps_per_turn": BENCH_STEPS,
        "steps_per_sec_in_turns": {k: [1e3 * BENCH_STEPS / v for v in vs]
                                   for k, vs in ms.items()}}
    del runs
    torch.cuda.empty_cache()
    emit({"phase": "bench_profiles_bf16", "profiles": profiles, "nvidia_smi": smi_line,
          "seconds": round(time.time() - t0, 3)})
    emit({"phase": "bf16_unet3d_done", "seconds": round(time.time() - t_phase, 3)})


# phase 18 (the flax dtype=bfloat16 UNet2D: bf16 activations, the JAX
# Burgers bench's and apps' default bf16; the bf16-activation variants of
# K1/K2, K3, K5 and K6)
# a bf16-activation kernel against its plain version on the same bf16
# inputs: both round the same values at the same points and differ only in
# fp32 summation order, so where a sum lands near a rounding tie one output
# value moves by one bf16 step (2^-8 to 2^-7 of it), and K3's and K5's
# later roundings may carry that by a step more: two steps of the largest
# value, 2^-6
BF16ACT_KERNEL_RTOL = 2 ** -6
# the whole forward, kernels against plain versions: the flips cascade
# through 17 ResBlocks with one GroupNorm group (the CPU tests' dim-8 net
# against flax: 7.9e-3; tests/test_torch_port_bf16_flax_unet2d.py), and
# the UNet3D's NET_RTOL for the same cascade is 5e-2
BF16ACT_UNET_RTOL = 5e-2
BF16ACT_APP_DDIM = 20  # infer_burgers steps per run, flax and weight-only bf16 in turns
BF16ACT_DDPM_STEPS = 20


# K1c and K2c at batch 50 as their parent (the old core, igemm_bf16.cuh, on
# bf16 sources) computed them: (kernel, args) -> (digest of the output, the
# parent's splits, stages per split), on kernel_case_bf16act's inputs drawn
# from a CUDA generator seeded 2100 + the signature's index among the
# forward's distinct K1 / K2 signatures (tools/sweep_igemm_tc.py --bf16act
# --root on the parent; NVIDIA H100 80GB HBM3). Where the persistent tile
# runs the parent's split its sums are the parent's, bit for bit.
PARENT_BF16ACT_DIGESTS = {
    ("conv2d_nhwc", (50, 16, 128, 64, 0, 64, 3, False)): ("8b0868439016e42e", 1, 9),
    ("downsample_nhwc", (50, 16, 128, 64, 64)): ("9ed2b845c6798249", 1, 4),
    ("conv2d_nhwc", (50, 8, 64, 64, 0, 64, 3, False)): ("18d0f4266e2fec5b", 1, 9),
    ("downsample_nhwc", (50, 8, 64, 64, 128)): ("80e0011ba43df8fb", 1, 4),
    ("conv2d_nhwc", (50, 4, 32, 128, 0, 128, 3, False)): ("6b36922bc9b284e5", 2, 9),
    ("downsample_nhwc", (50, 4, 32, 128, 256)): ("8b2d77178b2b020f", 2, 4),
    ("conv2d_nhwc", (50, 2, 16, 256, 0, 256, 3, False)): ("750c16da4dc50482", 5, 8),
    ("conv2d_nhwc", (50, 2, 16, 256, 0, 512, 3, False)): ("8b87f5d1d9c594f6", 2, 18),
    ("conv2d_nhwc", (50, 2, 16, 512, 0, 512, 3, False)): ("9e31e7e8189cfb6b", 5, 15),
    ("conv2d_nhwc", (50, 2, 16, 512, 256, 512, 3, False)): ("4ff1154c92fad23e", 5, 22),
    ("conv2d_nhwc", (50, 2, 16, 512, 256, 512, 1, False)): ("7ca6ab3ca76a1890", 1, 12),
    ("conv2d_nhwc", (50, 2, 16, 512, 0, 256, 3, True)): ("c9ebc702cd687b8b", 2, 36),
    ("conv2d_nhwc", (50, 4, 32, 256, 128, 256, 3, False)): ("10390eb4da1bb89d", 2, 27),
    ("conv2d_nhwc", (50, 4, 32, 256, 0, 256, 3, False)): ("ea119726c0e06f89", 2, 18),
    ("conv2d_nhwc", (50, 4, 32, 256, 128, 256, 1, False)): ("aad150d517596217", 1, 6),
    ("conv2d_nhwc", (50, 4, 32, 256, 0, 128, 3, True)): ("d621f4f16686c1f3", 1, 36),
    ("conv2d_nhwc", (50, 8, 64, 128, 64, 128, 3, False)): ("339e20e595af604f", 1, 27),
    ("conv2d_nhwc", (50, 8, 64, 128, 0, 128, 3, False)): ("e21dc915122f2087", 1, 18),
    ("conv2d_nhwc", (50, 8, 64, 128, 64, 128, 1, False)): ("ce345b777e4c757a", 1, 3),
    ("conv2d_nhwc", (50, 8, 64, 128, 0, 64, 3, True)): ("05d8441108504f9c", 1, 18),
    ("conv2d_nhwc", (50, 16, 128, 64, 64, 64, 3, False)): ("75614a565f2fccf8", 1, 18),
    ("conv2d_nhwc", (50, 16, 128, 64, 64, 64, 1, False)): ("20126030b83f1397", 1, 2),
}
BF16ACT_TC_SEED = 2100


def bf16_digest(torch, t) -> str:
    """The first 16 hex digits of the SHA-256 of a bf16 tensor's bytes."""
    import hashlib

    return hashlib.sha256(t.contiguous().view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]


def kernel_case_bf16act(torch, F, kb, gen, kind, args):
    """(kernel fn, plain fn, library fn or None, flops, bytes, extra
    timings) of one bf16-activation signature: bf16 activations (and FiLM,
    residual), bf16 matmul weights, fp32 biases, norms and gains. Bytes: each
    input read once and the output written once, activations and weights at
    2 bytes. The library call: cuDNN's bf16 conv on bf16 NCHW tensors (K1,
    K2), ``F.group_norm`` plus the FiLM, SiLU and residual ops in bf16 (K3);
    none for K5 and K6 (SDPA on K6's q, k, v is an extra yardstick)."""
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0, shift=0.0, dtype=bf):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale + shift).to(dtype)

    if kind in ("linear_attention_block", "attention_block"):
        from diffphycon_tpu_torch.kernels import attention as ka

        b_, h, w, c = args
        hidden = HEADS * DIM_HEAD
        x = rnd(b_, h, w, c, scale=2.0, shift=0.3)
        f32 = torch.float32
        p = {"norm_g": rnd(c, scale=0.1, shift=1.0, dtype=f32),
             "wqkv": rnd(c, 3 * hidden, scale=c ** -0.5),
             "wo": rnd(hidden, c, scale=hidden ** -0.5),
             "bo": rnd(c, scale=0.1, dtype=f32)}
        linear = kind == "linear_attention_block"
        if linear:
            p["out_g"] = rnd(c, scale=0.1, shift=1.0, dtype=f32)
        kern = ka.linear_attention_block if linear else ka.attention_block
        plain = ka.linear_attention_block_plain if linear else ka.attention_block_plain
        nbytes = 2 * 2 * x.numel() + 4 * (3 if linear else 2) * c + 2 * 4 * c * hidden
        extra = {}
        if not linear:
            q, k, v = (t.permute(0, 2, 1, 3).contiguous() for t in
                       ka._qkv_bf16(x, p["norm_g"], p["wqkv"], HEADS, DIM_HEAD))
            extra["sdpa_core"] = lambda: F.scaled_dot_product_attention(q, k, v)
        return (lambda: kern(x, p), lambda: plain(x, p), None,
                attention_flops(kind, b_, h * w, c), nbytes, extra)
    if kind == "conv2d_nhwc":
        b_, h, w, ca, cb, co, k, up = args
        ci = ca + cb
        xa = rnd(b_, h, w, ca)
        xb = rnd(b_, h, w, cb) if cb else None
        wt = rnd(k * k * ci, co, scale=1.0 / math.sqrt(k * k * ci))
        bias = rnd(co, scale=0.1, dtype=torch.float32)
        w_lib = wt.reshape(k, k, ci, co).permute(3, 2, 0, 1).contiguous()
        xa_l = xa.permute(0, 3, 1, 2).contiguous()
        xb_l = xb.permute(0, 3, 1, 2).contiguous() if cb else None
        b_lib = bias.to(bf)

        def library():
            x = xa_l if xb_l is None else torch.cat([xa_l, xb_l], dim=1)
            if up:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            return F.conv2d(x, w_lib, b_lib, padding=k // 2)

        ho, wo = (2 * h, 2 * w) if up else (h, w)
        flops = 2 * b_ * ho * wo * co * k * k * ci
        nbytes = 2 * (xa.numel() + (xb.numel() if cb else 0) + b_ * ho * wo * co + wt.numel()) \
            + 4 * co
        return (lambda: kb.conv2d_nhwc(xa, wt, bias, x_b=xb, k=k, upsample=up),
                lambda: kb.conv2d_nhwc_plain(xa, wt, bias, x_b=xb, k=k, upsample=up),
                library, flops, nbytes, {})
    if kind == "downsample_nhwc":
        b_, h, w, c, co = args
        x = rnd(b_, h, w, c)
        wt = rnd(4 * c, co, scale=1.0 / math.sqrt(4 * c))
        bias = rnd(co, scale=0.1, dtype=torch.float32)
        w_lib = wt.reshape(2, 2, c, co).permute(3, 2, 0, 1).contiguous()
        x_l = x.permute(0, 3, 1, 2).contiguous()
        b_lib = bias.to(bf)
        flops = 2 * b_ * (h // 2) * (w // 2) * co * 4 * c
        nbytes = 2 * (x.numel() + b_ * (h // 2) * (w // 2) * co + wt.numel()) + 4 * co
        return (lambda: kb.downsample_nhwc(x, wt, bias),
                lambda: kb.downsample_nhwc_plain(x, wt, bias),
                lambda: F.conv2d(x_l, w_lib, b_lib, stride=2), flops, nbytes, {})
    b_, h, w, c, film = args
    x = rnd(b_, h, w, c, scale=2.0, shift=0.5)
    gamma = rnd(c, scale=0.5, shift=1.0, dtype=torch.float32)
    beta = rnd(c, scale=0.1, dtype=torch.float32)
    ss = rnd(b_, 2 * c, scale=0.5) if film else None
    res = None if film else rnd(b_, h, w, c)
    x_l = x.permute(0, 3, 1, 2).contiguous()
    res_l = None if film else res.permute(0, 3, 1, 2).contiguous()
    g_l, b_l = gamma.to(bf), beta.to(bf)

    def library():
        y = F.group_norm(x_l, 1, g_l, b_l, eps=kb.GN_EPS)
        if film:
            y = y * (ss[:, :c, None, None] + 1.0) + ss[:, c:, None, None]
        y = F.silu(y)
        return y if film else y + res_l

    flops = x.numel() * (13 + (3 if film else 1))
    nbytes = 2 * (2 * x.numel() + (ss.numel() if film else res.numel())) + 4 * 2 * c
    return (lambda: kb.group_norm_act(x, gamma, beta, 1, ss=ss, res=res),
            lambda: kb.group_norm_act_plain(x, gamma, beta, 1, ss=ss, res=res),
            library, flops, nbytes, {})


def bf16act_phase(torch, F, smi_line, calls):
    """Phase 18: the flax ``dtype=bfloat16`` UNet2D (``BurgersConfig(bf16=
    True)``, ``infer_burgers --bf16 True``): each bf16-activation variant (K1,
    K2, K3, K5, K6) at every signature of one forward at batch 50 against its
    plain version on the same bf16 inputs (BF16ACT_KERNEL_RTOL), two calls
    bit-equal, timed per event pair and on the device (CUDA graph) beside the
    plain version, the library call and the bound at 2-byte activations (K1c
    and K2c also: their plan, grid and path, ``unet2d_blocks.bf16act_path``;
    the output's digest beside PARENT_BF16ACT_DIGESTS, which it must equal
    where the plan's split is the parent's; and their device ms a forward per
    output level, the ``k1c_k2c_levels`` line); the
    net's kernel forward against its plain forward (BF16ACT_UNET_RTOL) with
    the launch counts of one forward (52 / 3 / 38 / 8 / 1, every one a
    bf16-activation launch) and its distance from the weight-only bf16 and
    fp32 forwards; ``apps/infer_burgers.py`` ``main()`` with ``--bf16 True``
    and with ``--impl pallas --bf16 True`` in turns (two seeded models, DDIM
    BF16ACT_APP_DDIM steps, batch 50: seconds, peak memory, launches); and
    BF16ACT_DDPM_STEPS guided DDPM steps at batch 50, the two bf16 modes in
    turns (steps/s, busy share of 3 profiled steps, peak memory). Run alone:
    ``chip_smoke.bf16act_phase(torch, F, smi, chip_smoke.main_path_calls(64,
    (1, 2, 4, 8), 50))`` after ``_build.load_library()``, with
    ``torch.backends.cudnn.allow_tf32 = False``. Returns the kernels line's
    bf16act records."""
    from diffphycon_tpu_torch.apps import infer_burgers
    from diffphycon_tpu_torch.benchmarks import burgers as bench
    from diffphycon_tpu_torch.kernels import unet2d_blocks as kb

    t_phase = time.time()
    work = os.path.join("build", "chip_smoke")
    gen = torch.Generator(device="cuda").manual_seed(18)

    # 18a. every bf16-activation signature of one forward
    t0 = time.time()
    per_fwd = {}
    for k, a, _ in calls:
        per_fwd[(k, a)] = per_fwd.get((k, a), 0) + 1
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "ops_ms", "bytes_ms",
            "max_abs_err")
    agg = {k: dict.fromkeys(keys, 0.0) for k in BF16ACT_KERNELS}
    levels = {}  # K1c / K2c per (kernel, output level): launches, device ms, bound ms
    bad = []
    tc_index = 0
    with torch.no_grad():
        for (kname, args), count in per_fwd.items():
            case_gen = gen
            if kname in TC_KERNELS:  # the inputs PARENT_BF16ACT_DIGESTS were taken on
                case_gen = torch.Generator(device="cuda").manual_seed(BF16ACT_TC_SEED + tc_index)
                tc_index += 1
            kern, plain, library, flops, nbytes, extra = kernel_case_bf16act(
                torch, F, kb, case_gen, kname, args)
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = max(1.0, ref.float().abs().max().item())
            tol = BF16ACT_KERNEL_RTOL * scale
            ok_dtype = out.dtype == torch.bfloat16 and out.shape == ref.shape
            repeat_equal = torch.equal(out, kern())
            ms, plain_ms = timed(torch, kern), timed(torch, plain)
            lib_ms = None if library is None else timed(torch, library)
            dev_ms, why = timed_graph(torch, kern)
            extra_ms = {f"{key}_ms": timed(torch, fn) for key, fn in extra.items()}
            peak = FP32_PEAK if kname == "group_norm_act" else BF16_PEAK
            b_ms, b_by = bound(flops, nbytes, peak)
            tc = {}
            if kname in TC_KERNELS:
                plan = kb.tile_plan(*gemm_dims(kname, args), True, True)
                digest = bf16_digest(torch, out)
                parent = PARENT_BF16ACT_DIGESTS.get((kname, args))
                same_split = parent is not None and parent[1:] == (plan.splits, plan.per)
                tc = {"tile_plan": {"bm": plan.bm, "bn": plan.bn, "splits": plan.splits,
                                    "per": plan.per, "ctas": kb.act_ctas(plan, *gemm_dims(
                                        kname, args)[:2])},
                      "path": kb.bf16act_path(kname, args, plan),
                      "tflop_per_s": flops / ms / 1e9, "digest": digest,
                      "parent_digest": parent and parent[0],
                      "parent_split": parent and list(parent[1:]),
                      "bit_equal_to_parent": parent is not None and digest == parent[0]}
                if same_split and digest != parent[0]:
                    bad.append((kname, args, "the parent's split, not its sums", digest))
                h, w = args[1], args[2]
                level = ((h // 2, w // 2) if kname == "downsample_nhwc" else
                         (2 * h, 2 * w) if args[7] else (h, w))
                lv = levels.setdefault(f"{kname}@{level[0]}x{level[1]}",
                                       {"launches": 0, "device_ms": 0.0, "bound_ms": 0.0})
                lv["launches"] += count
                lv["device_ms"] = None if dev_ms is None or lv["device_ms"] is None else (
                    lv["device_ms"] + count * dev_ms)
                lv["bound_ms"] += count * bound(flops, nbytes, BF16_PEAK)[0]
            if kname == "group_norm_act":
                b_, h, w, c, _ = args
                tc = {"cluster": kb.gn_bf16_plan(b_, h * w * c)}
            emit({"phase": "kernel_bf16act", "kernel": kname, "args": list(args),
                  "per_forward": count, "max_abs_err": err, "tol": tol, "rel_err": err / scale,
                  "repeat_bit_equal": repeat_equal, "ms": ms, "device_ms": dev_ms,
                  **({"device_ms_error": why} if why else {}), "plain_ms": plain_ms,
                  "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                  "gflop": flops / 1e9, "mbytes": nbytes / 1e6, **extra_ms, **tc})
            if not err <= tol or not ok_dtype:
                bad.append((kname, args, err, tol, str(out.dtype)))
            if not repeat_equal:
                bad.append((kname, args, "two calls are not bit-equal"))
            a = agg[kname]
            for key, v in (("ms", ms), ("device_ms", dev_ms), ("plain_ms", plain_ms),
                           ("library_ms", lib_ms), ("bound_ms", b_ms),
                           ("ops_ms", 1e3 * flops / peak), ("bytes_ms", 1e3 * nbytes / HBM_RATE)):
                a[key] = None if v is None or a[key] is None else a[key] + count * v
            a["max_abs_err"] = max(a["max_abs_err"], err)
            del out, ref
    emit({"phase": "k1c_k2c_levels", "per_forward": levels, "timing": "device, CUDA graph",
          "nvidia_smi": smi_line})
    emit({"phase": "kernels_bf16act_checked", "signatures": len(per_fwd),
          "tol_rel": BF16ACT_KERNEL_RTOL, "seconds": round(time.time() - t0, 3)})
    if bad:
        fail(f"bf16-activation kernel mismatches: {bad}")
    torch.cuda.empty_cache()

    # 18b. the net: kernel forward against plain forward, launches, beside
    # the weight-only bf16 and the fp32 forwards
    t0 = time.time()
    kw = dict(is_condition_u0=True, is_condition_uT=True)
    cfgs = {"flax_bf16": bench.BurgersConfig(**kw, bf16=True),
            "pallas_bf16": bench.BurgersConfig(**kw, bf16=True, impl="pallas"),
            "fp32": bench.BurgersConfig(**kw)}
    nets = {name: bench.init_params(cfg, seed=0, device="cuda") for name, cfg in cfgs.items()}
    x = torch.randn(B, cfgs["fp32"].pad_t, cfgs["fp32"].nx, 2, generator=gen, device="cuda")
    t = torch.linspace(0, 999, B, device="cuda")
    with torch.no_grad():
        kb.reset_launch_counts()
        out = nets["flax_bf16"](x, t)
        torch.cuda.synchronize()
        counts = kb.launch_counts()
        ref = nets["flax_bf16"].forward_plain(x, t)
        others = {name: nets[name](x, t) for name in ("pallas_bf16", "fp32")}
        scale = max(1.0, ref.float().abs().max().item())
        err = (out.float() - ref.float()).abs().max().item()
        gaps = {name: (out.float() - o).abs().max().item() / max(1.0, o.abs().max().item())
                for name, o in others.items()}
        fwd_ms = {name: [] for name in nets}
        for order in (tuple(nets), tuple(reversed(nets))):
            for name in order:
                fwd_ms[name].append(timed(torch, lambda: nets[name](x, t), n=10))
    want = expected_counts(calls, bf16act=True)
    emit({"phase": "unet2d_bf16act", "out_dtype": str(out.dtype), "max_abs_err": err,
          "tol": BF16ACT_UNET_RTOL * scale, "rel_err": err / scale,
          "rel_gap_to": gaps, "launches_per_forward": counts, "expected": want,
          "forward_ms_in_turns": fwd_ms, "finite": bool(torch.isfinite(out).all()),
          "nvidia_smi": smi_line, "seconds": round(time.time() - t0, 3)})
    if out.dtype != torch.bfloat16 or not torch.isfinite(out).all():
        fail(f"flax bf16 UNet2D output {out.dtype}, finite {bool(torch.isfinite(out).all())}")
    if not err <= BF16ACT_UNET_RTOL * scale:
        fail(f"flax bf16 UNet2D kernel forward differs from its plain forward: {err / scale}")
    if counts != want:
        fail(f"flax bf16 launch counts per forward {counts} != expected {want}")
    if not min(gaps.values()) > BF16_GUARD:
        fail(f"the flax bf16 forward is within {gaps} of another mode's forward")
    del out, ref, others

    # 18c. the app, flax bf16 (--bf16 True) and weight-only bf16 (--impl
    # pallas --bf16 True) in turns
    t0 = time.time()
    app = {"flax_bf16": [], "pallas_bf16": []}
    app_counts = {}
    for order in (("flax_bf16", "pallas_bf16"), ("pallas_bf16", "flax_bf16")):
        for name in order:
            args = infer_burgers.build_parser().parse_args([
                "--init_seed", "0", "--synthetic_data", str(B), "--n_test_samples", str(B),
                "--batch_size", str(B), "--eval_two_models", "True", "--wus", "1000",
                "--is_condition_u0", "True", "--is_condition_uT", "True", "--bf16", "True",
                *(["--impl", "pallas"] if name == "pallas_bf16" else []),
                "--using_ddim", "True", "--ddim_sampling_steps", str(BF16ACT_APP_DDIM),
                "--ddim_eta", "0", "--data_root", os.path.join(work, "data"),
                "--save_file", os.path.join(work, f"result_{name}.json")])
            torch.cuda.reset_peak_memory_stats()
            kb.reset_launch_counts()
            tic = time.perf_counter()
            entry = infer_burgers.main(args)["wu=1000.0,wf=0.0"]
            torch.cuda.synchronize()
            app[name].append({"seconds": time.perf_counter() - tic,
                              "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                              "result": entry})
            app_counts.setdefault(name, kb.launch_counts())
            if not all(math.isfinite(v) for v in entry.values()):
                fail(f"non-finite {name} main-path metrics: {entry}")
    emit({"phase": "main_path_bf16act", "app": "diffphycon_tpu_torch/apps/infer_burgers.py",
          "sampler": f"ddim {BF16ACT_APP_DDIM} steps, eta 0, two models, wu=1000, batch 50",
          "runs_in_turns": app, "launches": app_counts, "seconds": round(time.time() - t0, 3)})
    launches = app_counts["flax_bf16"]
    for k in BF16ACT_KERNELS:
        if not launches[f"{k}.bf16act"] > 0 or launches[k] != launches[f"{k}.bf16act"]:
            fail(f"flax bf16 main path: {k} launched {launches[k]} times, "
                 f"{launches[f'{k}.bf16act']} of them bf16-activation ones")
    if any(launches[f"{k}.bf16"] for k in BF16_KERNELS):
        fail(f"flax bf16 main path launched weight-only bf16 variants: {launches}")

    # 18d. guided DDPM at batch 50, the two bf16 modes in turns
    t0 = time.time()
    modes = ("flax_bf16", "pallas_bf16")
    nets_w = {name: bench.init_params(cfgs[name], seed=1, device="cuda") for name in modes}
    u_target = torch.randn(B, 11, 128, generator=gen, device="cuda")
    cond_vals = {"u0": u_target[:, 0, :] / bench.RESCALER,
                 "uT": u_target[:, 10, :] / bench.RESCALER}
    guidance = bench.build_guidance(cfgs["fp32"], u_target, wu=1000.0)
    gds = {name: bench.build_diffusion(cfgs[name], nets[name], model_w=nets_w[name],
                                       device="cuda") for name in modes}
    rates, peaks, ddpm_counts = {m: [] for m in modes}, {m: [] for m in modes}, None
    for order in (modes, tuple(reversed(modes)), modes):
        for name in order:
            gd = gds[name]
            ts = gd.sample_ts()
            xg = torch.Generator(device="cuda").manual_seed(1)
            xt = gd.sample_chunk(gd.sample_init(B, xg), ts[:2], cond_vals, guidance, xg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if name == "flax_bf16" and ddpm_counts is None:
                kb.reset_launch_counts()
            tic = time.perf_counter()
            xt = gd.sample_chunk(xt, ts[2:2 + BF16ACT_DDPM_STEPS], cond_vals, guidance, xg)
            torch.cuda.synchronize()
            rates[name].append(BF16ACT_DDPM_STEPS / (time.perf_counter() - tic))
            peaks[name].append(torch.cuda.max_memory_allocated() / 1e9)
            if name == "flax_bf16" and ddpm_counts is None:
                ddpm_counts = kb.launch_counts()
            if not torch.isfinite(xt).all():
                fail(f"non-finite samples in the {name} guided DDPM loop")
    busy = {}
    for name, gd in gds.items():
        xg = torch.Generator(device="cuda").manual_seed(2)
        ts = gd.sample_ts()
        xt = gd.sample_init(B, xg)
        wall_ms, dev_ms, rows = profile_window(
            torch, lambda: gd.sample_chunk(xt, ts[:3], cond_vals, guidance, xg))
        busy[name] = {"steps": 3, "wall_ms": wall_ms, "device_ms": dev_ms,
                      "busy_share": dev_ms / wall_ms, "top": [[k[:60], v] for k, v in rows[:6]]}
    want_steps = {k: 2 * BF16ACT_DDPM_STEPS * v for k, v in want.items()}
    emit({"phase": "guided_ddpm_bf16act", "batch": B, "steps_timed": BF16ACT_DDPM_STEPS,
          "guided_denoise_steps_per_sec_in_turns": rates, "peak_gb_in_turns": peaks,
          "profile": busy, "launches_flax_run": ddpm_counts, "expected": want_steps,
          "nvidia_smi": smi_line, "seconds": round(time.time() - t0, 3)})
    if ddpm_counts != want_steps:
        fail(f"flax bf16 guided DDPM launches {ddpm_counts} != {want_steps}")
    del gds, nets_w, nets
    torch.cuda.empty_cache()

    emit({"phase": "bf16act_done", "seconds": round(time.time() - t_phase, 3)})
    records = []
    for k in BF16ACT_KERNELS:
        a = agg[k]
        src = BF16ACT_SOURCES.get(k, SOURCES[k][1])
        records.append({
            "name": f"{k}_bf16act", "route": "cuda", "source": src,
            "replaces": REPLACES[k] + " as the flax UNet2D computes it under dtype=bfloat16 "
                        "(diffphycon_tpu/nets/blocks.py; bench.py:46)",
            "launches": launches[f"{k}.bf16act"], "max_abs_err": a["max_abs_err"],
            "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
            "bound_by": "operations" if a["ops_ms"] >= a["bytes_ms"] else "bytes",
            "library_ms": a["library_ms"], "device_ms": a["device_ms"]})
    return records


BF16ACT_SOURCES = {
    "conv2d_nhwc": "diffphycon_tpu_torch/csrc/igemm_bf16act.cu",
    "downsample_nhwc": "diffphycon_tpu_torch/csrc/igemm_bf16act.cu",
    "linear_attention_block": "diffphycon_tpu_torch/csrc/attention_bf16act.cu",
    "attention_block": "diffphycon_tpu_torch/csrc/attention_bf16act.cu",
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    try:
        from diffphycon_tpu_torch.apps import infer_burgers
        from diffphycon_tpu_torch.benchmarks import burgers as bench
        from diffphycon_tpu_torch.kernels import _build
        from diffphycon_tpu_torch.kernels import attention as ka
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
             if "registers" in ln or "spill" in ln or "wgmma" in ln]
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
    for k in TC_KERNELS:
        agg[k]["library_tuned_ms"] = 0.0
    for k in DEVICE_TIMED:
        agg[k]["device_ms"] = 0.0
    agg["linear_attention_block"].update(
        {"k5a_ms": 0.0, "k5b_ms": 0.0, "k5a_device_ms": 0.0, "k5b_device_ms": 0.0})
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
            b_ms, b_by, ops_ms = kernel_bound(kname, flops, nbytes)
            tc = {}
            if kname in TC_KERNELS:
                m, n, k = gemm_dims(kname, args)
                plan = kb.tile_plan(m, n, k)
                tuned_ms = timed_tuned(torch, library)
                tc = {"tile_plan": {"bm": plan.bm, "bn": plan.bn, "splits": plan.splits,
                                    "ctas": plan.ctas(m, n)},
                      "library_tuned_ms": tuned_ms, "ratio_vs_library": ms / lib_ms,
                      "ratio_vs_library_tuned": ms / tuned_ms,
                      "bound_fp32_simt_ms": bound(flops, nbytes)[0],
                      "tflop_per_s": flops / ms / 1e9, "stream_ms": timed_stream(torch, kern)}
            extra_ms = {f"{k}_ms": timed(torch, fn) for k, fn in extra.items()}
            dev = {}
            if kname in DEVICE_TIMED:
                repeat_equal = torch.equal(out, kern())
                dev = {"repeat_bit_equal": repeat_equal}
                fns = {"device_ms": kern}
                if kname == "linear_attention_block":
                    b_, h, w, _ = args
                    chunk, n_chunks = ka.la_chunk_plan(b_, h * w)
                    dev.update({"chunk": chunk, "S": n_chunks,
                                "head_groups": ka.la_head_groups(b_, n_chunks),
                                "bound_fp32_ms": bound(flops, nbytes)[0]})
                    fns.update({"k5a_device_ms": extra["k5a"], "k5b_device_ms": extra["k5b"]})
                elif kname == "attention_block":
                    b_, h, w, _ = args
                    dev.update({"tile_rows": ka.attn_tile_rows(b_, h * w),
                                "bound_fp32_ms": bound(flops, nbytes)[0]})
                else:
                    b_, h, w, c, _ = args
                    dev["cluster"] = kb.gn_cluster_plan(b_, h * w * c)
                for key, fn in fns.items():
                    dev[key], why = timed_graph(torch, fn)
                    if why is not None:
                        dev[key + "_error"] = why
                if not repeat_equal:
                    bad.append((kname, args, "two calls are not bit-equal"))
            emit({"phase": "kernel", "kernel": kname, "args": list(args),
                  "per_forward": count, "max_abs_err": err, "tol": tol,
                  "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                  "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
                  "mbytes": nbytes / 1e6, **tc, **extra_ms, **dev})
            if not err <= tol:
                bad.append((kname, args, err, tol))
            sig_times[(kname, args)] = {"ms": ms, "plain_ms": plain_ms,
                                        "library_ms": lib_ms, "bound_ms": b_ms}
            a = agg[kname]
            a["ms"] += count * ms
            a["plain_ms"] += count * plain_ms
            a["library_ms"] = None if lib_ms is None else a["library_ms"] + count * lib_ms
            a["bound_ms"] += count * b_ms
            a["ops_ms"] += count * ops_ms
            a["bytes_ms"] += count * 1e3 * nbytes / HBM_RATE
            a["max_abs_err"] = max(a["max_abs_err"], err)
            if "library_tuned_ms" in tc:
                a["library_tuned_ms"] += count * tc["library_tuned_ms"]
            for key in ("device_ms", "k5a_device_ms", "k5b_device_ms"):
                if key in dev:  # a failed graph capture leaves the sum unknown
                    known = dev[key] is not None and a[key] is not None
                    a[key] = a[key] + count * dev[key] if known else None
            for key in ("k5a_ms", "k5b_ms"):
                if key in extra_ms:
                    a[key] += count * extra_ms[key]
            del out, ref
    # K6 at 128 and 2048 tokens: checked, bit-equal, timed (a record)
    for args in K6_EXTRA:
        kern, plain, _, flops, nbytes, _ = kernel_case(torch, F, kb, gen, "attention_block",
                                                       args)
        out, ref = kern(), plain()
        err = (out - ref).abs().max().item()
        tol = KERNEL_RTOL * max(1.0, ref.abs().max().item())
        repeat_equal = torch.equal(out, kern())
        b_ms, b_by, _ = kernel_bound("attention_block", flops, nbytes)
        dev_ms, why = timed_graph(torch, kern)
        emit({"phase": "kernel", "kernel": "attention_block", "args": list(args),
              "per_forward": 0, "tokens": args[1] * args[2], "max_abs_err": err, "tol": tol,
              "repeat_bit_equal": repeat_equal, "ms": timed(torch, kern),
              "plain_ms": timed(torch, plain), "device_ms": dev_ms,
              **({"device_ms_error": why} if why else {}), "bound_ms": b_ms, "bound_by": b_by,
              "bound_fp32_ms": bound(flops, nbytes)[0],
              "tile_rows": ka.attn_tile_rows(args[0], args[1] * args[2])})
        if not err <= tol:
            bad.append(("attention_block", args, err, tol))
        if not repeat_equal:
            bad.append(("attention_block", args, "two calls are not bit-equal"))
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
            "busy_share": dev_ms / wall_ms, "top": [[k[:60], v] for k, v in rows[:8]],
            "k3_device_ms": sum(v for k, v in rows if "group_norm_act_kernel" in k),
            "k5_device_ms": sum(v for k, v in rows if "la_" in k and "_tc_kernel" in k),
            "k6_device_ms": sum(v for k, v in rows if "attn_" in k and "_kernel" in k)}
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
    torch.cuda.empty_cache()

    # -- 9-10. the persistent kernel: K7, then K8 (fp32 and bf16 weights) ----
    persistent = resblock_pair_phase(torch, F, smi_line)
    torch.cuda.empty_cache()
    persistent.update(unet2d_mega_phase(torch, smi_line, bench, cfg))
    torch.cuda.empty_cache()

    # -- 11-12. smoke training; the jellyfish pipeline ----------------------
    smoke_training_phase(torch, smi_line)
    jellyfish_phase(torch, smi_line)

    # -- 13. the baselines (Burgers solver gradient, PID/SL/RL apps, MPC) ---
    baselines_phase(torch, smi_line)

    # -- 14. the smoke and jellyfish RL environments and apps ----------------
    rl_launches = rl_env_phase(torch, smi_line)

    # -- 15. fuse_two_models, objectives, DDP, reference files, KS -----------
    remaining_modules_phase(torch, smi_line, fwd_counts)

    # -- 16. bf16 weights on the Burgers path ----------------------------------
    bf16_records = bf16_phase(torch, F, smi_line, calls)

    # -- 17. the smoke and jellyfish UNet3Ds in bf16 ------------------------------
    bf16_unet3d_phase(torch, smi_line)

    # -- 18. the flax dtype=bfloat16 UNet2D on the bf16-activation kernels --------
    bf16act_records = bf16act_phase(torch, F, smi_line, calls)

    # -- kernels line ---------------------------------------------------------
    kernels = []
    for k, (route, src) in SOURCES.items():
        a = agg[k]
        kernels.append({
            "name": k, "route": route, "source": src, "replaces": REPLACES[k],
            "launches": main_counts[k], "max_abs_err": a["max_abs_err"],
            "ms": a["ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
            "bound_by": "operations" if a["ops_ms"] >= a["bytes_ms"] else "bytes",
            "library_ms": a["library_ms"],
            **({"library_tuned_ms": a["library_tuned_ms"]} if k in TC_KERNELS else {}),
            **{key: a[key] for key in ("device_ms", "k5a_ms", "k5b_ms", "k5a_device_ms",
                                       "k5b_device_ms") if key in a}})
    for k, (route, src) in SMOKE_SOURCES.items():
        kernels.append({"name": k, "route": route, "source": src, "replaces": REPLACES[k],
                        "launches": cg_launches, "rl_env_launches": rl_launches, **cg_row})
    for k, row in persistent.items():
        base = k.removesuffix("_bf16")
        replaces = REPLACES[base] + BF16_PACKS.get(k, "")
        src = PERSISTENT_BF16_SRC if k.endswith("_bf16") else PERSISTENT_SRC[1]
        kernels.append({"name": k, "route": PERSISTENT_SRC[0], "source": src,
                        "replaces": replaces, **row})
    kernels += bf16_records + bf16act_records
    emit({"phase": "done", "seconds": round(time.time() - t_all, 3),
          "note": "K1-K3, K5 (linear_attention_block: K5a, the merge and K5b per "
                  "call) and K6 (attention_block: K6a, K6b and K6c per call): "
                  "ms/plain_ms/bound_ms/library_ms are "
                  "sums over one UNet2D forward at batch 50 (library_ms null where "
                  "no single PyTorch call computes the block), launches those of the "
                  "Burgers main path; K1, K2, K5 and K6 (3xTF32 tensor cores): bound_ms at "
                  "3 TF32 products per FMA (495 TFLOP/s; K5's and K6's fp32 bounds per site "
                  "in their phase-3 kernel records), library_tuned_ms cuDNN under "
                  "cudnn.benchmark; K3, K5 and K6: device_ms the device time alone "
                  "(CUDA-graph replay), "
                  "k5a/k5b the stages apart (K5b with the merge); "
                  "cg_pressure's are per solve at batch 8 (no single PyTorch call "
                  "solves the system, so library_ms is null; cluster its CTAs per "
                  "element, us_per_iteration ms over the most iterations), launches "
                  "those of the smoke main path, rl_env_launches those of phase 14's "
                  "smoke RL app runs (one per SmokeRLEnv sub-step); resblock_pair (K7): sums over its five "
                  "shapes at batch 50, launches those of the phase-9 path (one "
                  "per shape), library_ms the pair from cuDNN convs and "
                  "F.group_norm (TF32 off), bound_ms with the convs at 3xTF32 (the fp32 "
                  "bounds in the phase-9 records); "
                  "unet2d_mega (K8): per forward at "
                  "batch 50, launches those of 20 guided DDPM steps through "
                  "forward_mega (2 per step), bound_ms at 3xTF32 (the fp32 bound "
                  "in the phase-10 record), device_ms from a CUDA graph of 10 launches, "
                  "library_ms null (no PyTorch call "
                  "computes the net; phase 10 times the K1-K6 forward beside it); "
                  "resblock_pair_bf16 / unet2d_mega_bf16 (phases 9-10, bf16 weights, the "
                  "kernel's bf16 instantiation): the same sums and launches, bound_ms at "
                  "989 TFLOP/s (bf16) with the weights at 2 bytes, library_ms for K7 the "
                  "pair from cuDNN bf16 convs; "
                  "*_bf16 (phase 16, the bf16 variants): sums over one bf16 UNet2D forward "
                  "at batch 50, launches those of the --bf16 True main path, bound_ms at "
                  "989 TFLOP/s (bf16) with the weights at 2 bytes, library_ms cuDNN's bf16 "
                  "conv (K1, K2; null for K5, K6: SDPA on K6's q, k, v is in its phase-16 "
                  "record), device_ms from CUDA graphs of 20 calls; "
                  "*_bf16act (phase 18, the bf16-activation variants, flax dtype=bfloat16): "
                  "sums over one flax bf16 UNet2D forward at batch 50, launches those of the "
                  "--bf16 True main path (DDIM 20), bound_ms with 2-byte activations and "
                  "weights (K1, K2, K5, K6 at 989 TFLOP/s, K3 at the fp32 rate), library_ms "
                  "cuDNN's bf16 conv on bf16 tensors (K1, K2), F.group_norm plus the ops in "
                  "bf16 (K3), null for K5, K6"})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
