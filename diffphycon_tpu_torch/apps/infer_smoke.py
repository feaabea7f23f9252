#!/usr/bin/env python
"""Guided inference / control evaluation for 2D smoke on the GPU.

Port of ``apps/infer_smoke.py``: samples controls by two-model DDIM with
the joint 6-channel and the prior 2-channel UNet3D (prior reweighting
gamma = ``--w_prob_exp``, smoke-out guidance, the smoke ordering
``combine_w_with_guidance``), re-simulates them for 256 frames with the
batched smoke solver (K4 pressure solves) and scores them. With
``--calibrate True`` (the default) it also re-simulates the zero-control and
the dataset-control rows.

Weights come from ``--params_npz_joint`` / ``--params_npz_w`` (flat
flax-path npz files of the JAX package's UNet3D trees, see
``utils/convert.py``), from ``--init_seed N`` (seeded random weights; the
prior model takes N + 1), or else from the port's checkpoints
``<joint_folder>/ckpt/<diffusion_joint_checkpoint>/`` and the w model's
(``apps/train_smoke.py``). Orbax checkpoints are not ported (ROADMAP.md). ``--scan_chunks`` is accepted and has no effect: the port's
sampler is a Python loop.

Example:
  python -m diffphycon_tpu_torch.apps.infer_smoke --dataset_path data/smoke \\
      --init_seed 0 --ddim_sampling_steps 100
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from pathlib import Path


def build_parser():
    p = argparse.ArgumentParser(description="Smoke guided inference (PyTorch/CUDA)")
    p.add_argument("--dataset_path", default="data/smoke", type=str)
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--n_test_samples", default=8, type=int)
    p.add_argument("--joint_folder", default="trained_models/smoke", type=str)
    p.add_argument("--w_folder", default="trained_models/smoke_w", type=str)
    p.add_argument("--diffusion_joint_checkpoint", default=50, type=int)
    p.add_argument("--diffusion_w_checkpoint", default=17, type=int)
    p.add_argument("--use_ema", default=True, type=eval)
    p.add_argument("--params_npz_joint", default=None, type=str,
                   help="joint-model weights: flat flax-path npz (utils/convert.py)")
    p.add_argument("--params_npz_w", default=None, type=str)
    p.add_argument("--init_seed", default=None, type=int,
                   help="seeded random weights (the prior model takes seed + 1)")
    p.add_argument("--device", default=None, type=str,
                   help="default cuda; pass cpu explicitly to run on the CPU")
    p.add_argument("--inference_result_path", default="smoke_results", type=str)

    p.add_argument("--w_energy", default=0.0, type=float)
    p.add_argument("--using_ddim", default=True, type=eval)
    p.add_argument("--ddim_eta", default=1.0, type=float)
    p.add_argument("--ddim_sampling_steps", default=100, type=int)
    p.add_argument("--w_prob_exp", default=0.97, type=float)
    p.add_argument("--design_guidance", default="standard", type=str)
    p.add_argument("--standard_fixed_ratio", default=100000.0, type=float)
    p.add_argument("--coeff_ratio", default=0.0, type=float)
    p.add_argument("--dim", default=64, type=int)
    p.add_argument("--dim_mults", nargs="+", default=[1, 2, 4], type=int)
    p.add_argument("--beta_schedule", default="linear", type=str)
    p.add_argument("--solver_accuracy", default=1e-6, type=float)
    p.add_argument("--bf16", default=False, type=eval)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    p.add_argument("--calibrate", default=True, type=eval,
                   help="also evaluate zero-control and dataset-control rollouts "
                        "to anchor the J scale")
    p.add_argument("--calibrate_only", default=False, type=eval,
                   help="skip the models and sampling; emit only the calibration rows")
    p.add_argument("--scan_chunks", default=1, type=int,
                   help="accepted for the JAX app's command lines; no effect here")
    return p


def _load_net(bench, cfg, npz, seed, device, folder, milestone, use_ema):
    from diffphycon_tpu_torch.training.trainer import CKPT_FILE, Trainer
    from diffphycon_tpu_torch.utils.convert import load_flax_npz, load_flax_unet3d

    if npz is not None:
        return load_flax_unet3d(bench.build_unet(cfg, device), load_flax_npz(npz))
    if seed is not None:
        return bench.init_params(cfg, seed=seed, device=device)
    if (Path(folder) / "ckpt" / str(milestone) / CKPT_FILE).is_file():
        net = bench.build_unet(cfg, device)
        net.load_state_dict(Trainer.load_params(folder, milestone, use_ema))
        return net
    raise NotImplementedError(
        f"no port checkpoint {folder}/ckpt/{milestone} (apps/train_smoke.py writes them), "
        "and orbax checkpoints are not ported (ROADMAP.md): pass --params_npz_joint / "
        "--params_npz_w (flax-path npz files of the weights) or --init_seed")


def main(args):
    import numpy as np
    import torch

    from diffphycon_tpu_torch.benchmarks import smoke as bench
    from diffphycon_tpu_torch.device import resolve_device
    from diffphycon_tpu_torch.physics.fluids.smoke_env import SmokeSim
    from diffphycon_tpu_torch.training.data import load_smoke_dataset

    device = resolve_device("cpu" if args.cpu else args.device)
    cfg = bench.SmokeConfig(
        dim=args.dim, dim_mults=tuple(args.dim_mults), using_ddim=args.using_ddim,
        ddim_eta=args.ddim_eta, ddim_sampling_steps=args.ddim_sampling_steps,
        w_prob_exp=args.w_prob_exp, standard_fixed_ratio=args.standard_fixed_ratio,
        coeff_ratio=args.coeff_ratio, design_guidance=args.design_guidance,
        w_energy=args.w_energy, beta_schedule=args.beta_schedule, bf16=args.bf16)
    cfg_w = dataclasses.replace(cfg, is_w_model=True)
    if not args.calibrate_only:
        net_joint = _load_net(bench, cfg, args.params_npz_joint, args.init_seed, device,
                              args.joint_folder, args.diffusion_joint_checkpoint, args.use_ema)
        seed_w = None if args.init_seed is None else args.init_seed + 1
        net_w = _load_net(bench, cfg_w, args.params_npz_w, seed_w, device,
                          args.w_folder, args.diffusion_w_checkpoint, args.use_ema)
        gd = bench.build_diffusion(cfg, net_joint, model_w=net_w, device=device)
        guidance = bench.build_guidance(cfg, device=device)

    data = load_smoke_dataset(args.dataset_path, "test", n=args.n_test_samples)
    if data.shape[1] >= 256:
        # reference-layout test sims keep all 256 frames; the model runs at
        # every 8th (self-generated sims are already recorded at 33 frames)
        data = data[:, ::8]
    n = data.shape[0]
    bs = min(args.batch_size, n)
    r = torch.as_tensor(bench.RESCALER, device=device)
    sim = SmokeSim.create(accuracy=args.solver_accuracy, device=device)

    def evaluate(pred, d):
        m = bench.evaluate_samples(sim, pred, d, w_energy=args.w_energy)
        return {k: v.cpu().numpy() for k, v in m.items() if k != "sim_traj"}

    def batches():
        for i in range(0, n, bs):
            yield i, torch.from_numpy(np.ascontiguousarray(data[i : i + bs])).to(device)

    metrics = []
    sample_s = 0.0
    steps_per_s = 0.0
    t0 = time.time()
    if not args.calibrate_only:
        for i, d in batches():
            init = d[:, 0, :, :, 0] / r[0]
            gen = torch.Generator(device=device).manual_seed(args.seed + i)
            tic = time.time()
            with torch.no_grad():
                x = gd.sample(batch_size=d.shape[0], cond_vals={"init": init},
                              guidance=guidance, generator=gen)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            sample_s += time.time() - tic
            m = evaluate(x, d)
            metrics.append(m)
            print(f"batch {i // bs}: J_target={float(m['J_target'].mean()):.4f} "
                  f"mse={float(m['mse'].mean()):.4f}", flush=True)
        n_loops = max(1, (n + bs - 1) // bs)
        steps_per_s = args.ddim_sampling_steps * n_loops / max(sample_s, 1e-9)
        print(f"two-model DDIM loop: {steps_per_s:.2f} denoise steps/s (batch {bs})",
              flush=True)
    walltime = time.time() - t0

    agg = ({k: float(np.concatenate([m[k] for m in metrics]).mean()) for k in metrics[0]}
           if metrics else {})
    if args.calibrate or args.calibrate_only:
        # anchor rows: J with no control at all and with the dataset's own
        # control schedule
        cal = {"zero_control": [], "dataset_control": []}
        for _, d in batches():
            base = d[:, :32] / r
            zero = base.clone()
            zero[..., 3:5] = 0.0
            cal["zero_control"].append(evaluate(zero, d)["J_target"])
            cal["dataset_control"].append(evaluate(base, d)["J_target"])
        agg["J_target_zero_control"] = float(np.concatenate(cal["zero_control"]).mean())
        agg["J_target_dataset_control"] = float(np.concatenate(cal["dataset_control"]).mean())
        print(f"calibration: J_target zero-control {agg['J_target_zero_control']:.4f}, "
              f"dataset-control {agg['J_target_dataset_control']:.4f}", flush=True)
    agg["walltime_s"] = round(walltime, 2)
    agg["sampling_steps_per_s"] = round(steps_per_s, 2)
    agg["n"] = n
    os.makedirs(args.inference_result_path, exist_ok=True)
    out_file = os.path.join(args.inference_result_path, "results.json")
    with open(out_file, "a") as fh:
        fh.write(json.dumps({"args": vars(args), "metrics": agg}) + "\n")
    if "J_total" in agg:
        print("J_total =", agg["J_total"], "J_target =", agg["J_target"],
              "J_energy =", agg["J_energy"])
        print("mse =", agg["mse"], "n_l2 =", agg["n_l2"])
    print("saved", out_file, flush=True)
    return agg


if __name__ == "__main__":
    main(build_parser().parse_args())
