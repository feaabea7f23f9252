#!/usr/bin/env python
"""Guided inference / control evaluation for Burgers on the GPU.

Port of ``apps/infer_burgers.py``: samples controls with the joint p(u, w)
UNet2D (and, with ``--eval_two_models True``, the prior p(w) UNet2D for
prior reweighting) under guidance, re-simulates them with the solver, and
reports J_actual and control energy. Each denoise step runs the UNet2D
forwards through the port's hand-written kernels.

Weights come from ``--params_npz`` (a flat flax-path npz of the JAX
package's UNet2D tree, see ``utils/convert.py``), from ``--init_seed N``
(seeded random weights), or else from the port's own checkpoints (written by
``apps/train_burgers.py``): ``--checkpoint`` under
``<model_root>/burgers/<exp_id>`` and ``--checkpoint__model_w`` under
``<model_root>/burgers_w/<exp_id__model_w>`` (default: ``exp_id``), the EMA
weights unless ``--use_ema False``. A checkpoint directory written by the
JAX trainer (orbax) raises. ``--checkpoint_sweep K1 K2 ...`` evaluates each
listed checkpoint in turn (the prior model at the same step under
``--eval_two_models``), one row per checkpoint keyed
``ckpt={k},wu={wu},wf={wf}``, and rewrites ``--save_file`` after every row.

Example:
  python -m diffphycon_tpu_torch.apps.infer_burgers --init_seed 0 \\
      --synthetic_data 50 --eval_two_models True --wus 1000 \\
      --is_condition_u0 True --is_condition_uT True \\
      --using_ddim True --ddim_sampling_steps 50
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time


def none_or_str(x):
    return None if x in ("None", None) else x


def build_parser():
    p = argparse.ArgumentParser(description="Burgers guided inference (PyTorch/CUDA)")
    p.add_argument("--exp_id", default="gen-control", type=str)
    p.add_argument("--exp_id__model_w", default=None, type=str)
    p.add_argument("--model_root", default="./trained_models", type=str)
    p.add_argument("--checkpoint", default=10, type=int)
    p.add_argument("--checkpoint__model_w", default=10, type=int)
    p.add_argument("--checkpoint_sweep", nargs="+", default=None, type=int)
    p.add_argument("--params_npz", default=None, type=str,
                   help="joint-model weights: flat flax-path npz (utils/convert.py)")
    p.add_argument("--params_npz__model_w", default=None, type=str)
    p.add_argument("--init_seed", default=None, type=int,
                   help="seeded random weights (the prior model takes seed + 1)")
    p.add_argument("--device", default=None, type=str,
                   help="default cuda; pass cpu explicitly to run on the CPU")
    p.add_argument("--save_file", default="burgers_results/result.json", type=str)
    p.add_argument("--dataset", default="free_u_f_1e5", type=str)
    p.add_argument("--data_root", default="data", type=str)
    p.add_argument("--synthetic_data", default=0, type=int)
    p.add_argument("--n_test_samples", default=50, type=int)
    p.add_argument("--batch_size", default=50, type=int)
    p.add_argument("--use_ema", default=True, type=eval)

    p.add_argument("--partial_control", default="full", type=none_or_str)
    p.add_argument("--synthetic_partial_control", default=None, type=none_or_str)
    p.add_argument("--partially_observed", default=None, type=none_or_str)
    p.add_argument("--train_on_partially_observed", default=None, type=none_or_str)  # training-side
    p.add_argument("--set_unobserved_to_zero_during_sampling", default=False, type=eval)

    p.add_argument("--using_ddim", default=False, type=eval)
    p.add_argument("--ddim_eta", default=0.0, type=float)
    p.add_argument("--ddim_sampling_steps", default=1000, type=int)
    p.add_argument("--J_scheduler", default=None, type=none_or_str)
    p.add_argument("--w_scheduler", default=None, type=none_or_str)
    p.add_argument("--proj_guidance", default=None, type=none_or_str,
                   choices=[None, "ep_orthogonal_F", "ep_orthogonal_1D_x",
                            "ep_orthogonal_1D_t"])
    p.add_argument("--recurrence", default=False, type=eval)
    p.add_argument("--recurrence_k", default=1, type=int)
    p.add_argument("--wfs", nargs="+", default=[0.0], type=float)
    p.add_argument("--wus", nargs="+", default=[0.0], type=float)
    p.add_argument("--wreg", default=0.0, type=float)

    p.add_argument("--is_condition_u0", default=False, type=eval)
    p.add_argument("--is_condition_uT", default=False, type=eval)
    # training-side flags of the reference CLI: accepted, no effect on sampling
    p.add_argument("--is_condition_u0_zero_pred_noise", default=True, type=eval)
    p.add_argument("--is_condition_uT_zero_pred_noise", default=True, type=eval)

    p.add_argument("--dim", default=64, type=int)
    p.add_argument("--resnet_block_groups", default=1, type=int)
    p.add_argument("--dim_mults", "--dim_muls", dest="dim_mults", nargs="+",
                   default=[1, 2, 4, 8], type=int)
    p.add_argument("--dim__model_w", default=None, type=int)
    p.add_argument("--dim_mults__model_w", "--dim_muls__model_w",
                   dest="dim_mults__model_w", nargs="+", default=None, type=int)

    p.add_argument("--eval_two_models", default=False, type=eval)
    p.add_argument("--prior_beta", default=1, type=float)
    p.add_argument("--normalize_beta", default=False, type=eval)
    p.add_argument("--bf16", default=False, type=eval)
    return p


def get_target(args, device):
    """Test-split ground-truth trajectories (N, 11, 128), unscaled, numpy."""
    from diffphycon_tpu_torch.training import data

    if args.synthetic_data > 0:
        u, _ = data.synthetic_burgers(
            args.synthetic_data, seed=12345,
            partial_control=args.synthetic_partial_control,
            cache_dir=os.path.join(args.data_root, "synthetic"), device=device)
        return u[: args.n_test_samples]
    path = os.path.join(args.data_root, args.dataset, "burgers_test.h5")
    u, _ = data.load_burgers_h5(path, "test")
    return u[: args.n_test_samples]


def _load_net(bench, cfg, npz, seed, device, ckpt_folder, milestone, use_ema):
    from diffphycon_tpu_torch.training.trainer import Trainer
    from diffphycon_tpu_torch.utils.convert import load_flax_npz, load_flax_unet2d

    if npz is not None:
        return load_flax_unet2d(bench.build_unet(cfg, device), load_flax_npz(npz))
    if seed is not None:
        return bench.init_params(cfg, seed=seed, device=device)
    net = bench.build_unet(cfg, device)
    if milestone is not None:  # a sweep loads each of its checkpoints later
        net.load_state_dict(Trainer.load_params(ckpt_folder, milestone, use_ema=use_ema))
    return net


def main(args):
    import numpy as np
    import torch

    from diffphycon_tpu_torch.benchmarks import burgers as bench
    from diffphycon_tpu_torch.device import resolve_device
    from diffphycon_tpu_torch.training.trainer import Trainer

    sweep = args.checkpoint_sweep  # None: the one checkpoint (or weights) loaded below
    if sweep and (args.params_npz or args.params_npz__model_w or args.init_seed is not None):
        raise ValueError("--checkpoint_sweep reads the port's checkpoints; it takes no "
                         "--params_npz / --init_seed")
    device = resolve_device(args.device)
    cfg = bench.BurgersConfig(
        dim=args.dim,
        dim_mults=tuple(args.dim_mults),
        resnet_block_groups=args.resnet_block_groups,
        using_ddim=args.using_ddim,
        ddim_sampling_steps=args.ddim_sampling_steps,
        ddim_eta=args.ddim_eta,
        is_condition_u0=args.is_condition_u0,
        is_condition_uT=args.is_condition_uT,
        partially_observed=args.partially_observed,
        partial_control=args.partial_control,
        set_unobserved_to_zero_during_sampling=args.set_unobserved_to_zero_during_sampling,
        prior_beta=args.prior_beta,
        normalize_beta=args.normalize_beta,
        recurrence=args.recurrence,
        recurrence_k=args.recurrence_k,
        bf16=args.bf16,
    )
    folder = os.path.join(args.model_root, "burgers", args.exp_id)
    folder_w = os.path.join(args.model_root, "burgers_w", args.exp_id__model_w or args.exp_id)
    net = _load_net(bench, cfg, args.params_npz, args.init_seed, device, folder,
                    None if sweep else args.checkpoint, args.use_ema)
    net_w = None
    if args.eval_two_models:
        cfg_w = dataclasses.replace(
            cfg, dim=args.dim__model_w or args.dim,
            dim_mults=tuple(args.dim_mults__model_w or args.dim_mults))
        seed_w = None if args.init_seed is None else args.init_seed + 1
        net_w = _load_net(bench, cfg_w, args.params_npz__model_w, seed_w, device, folder_w,
                          None if sweep else args.checkpoint__model_w, args.use_ema)
    gd = bench.build_diffusion(cfg, net, model_w=net_w, device=device)

    u_target_all = get_target(args, device)
    n, bs = args.n_test_samples, min(args.batch_size, args.n_test_samples)
    if n % bs:
        raise ValueError(f"n_test_samples={n} is not a multiple of batch_size={bs}")

    results = {}
    for wu, wf, ck in ((wu, wf, ck) for wu in args.wus for wf in args.wfs
                       for ck in (sweep or [None])):
        if ck is not None:
            net.load_state_dict(Trainer.load_params(folder, ck, use_ema=args.use_ema))
            if net_w is not None:
                net_w.load_state_dict(Trainer.load_params(folder_w, ck, use_ema=args.use_ema))
        rows = []
        t_start = time.time()
        for i in range(n // bs):
            tgt = torch.from_numpy(u_target_all[i * bs : (i + 1) * bs]).to(device)
            guidance = bench.build_guidance(
                cfg, tgt, wu=wu, wf=wf, wreg=args.wreg,
                j_scheduler=args.J_scheduler, w_scheduler=args.w_scheduler,
                proj_guidance=args.proj_guidance)
            cond_vals = {"u0": tgt[:, 0, :] / bench.RESCALER,
                         "uT": tgt[:, 10, :] / bench.RESCALER}
            gen = torch.Generator(device=device).manual_seed(i)
            x = gd.sample(batch_size=bs, cond_vals=cond_vals, guidance=guidance,
                          generator=gen)
            rows.append(bench.evaluate_samples(x, tgt, cfg))
        walltime = time.time() - t_start

        def cat(get):
            return np.concatenate([get(r) for r in rows])

        entry = {
            "J_actual_mse": float(cat(lambda r: r.j_actual[0]).mean()),
            "J_actual_mae": float(cat(lambda r: r.j_actual[2]).mean()),
            "J_actual_nmse": float(cat(lambda r: r.j_actual[4]).mean()),
            "J_actual_nmae": float(cat(lambda r: r.j_actual[5]).mean()),
            "control_energy": float(cat(lambda r: r.control_energy).mean()),
            "ddpm_mse": float(cat(lambda r: r.ddpm_mse).mean()),
            "walltime_s": round(walltime, 3),
            "n": n,
        }
        key_name = f"wu={wu},wf={wf}" if ck is None else f"ckpt={ck},wu={wu},wf={wf}"
        results[key_name] = entry
        print(f"[{key_name}] J_actual(mse)={entry['J_actual_mse']:.6f} "
              f"energy={entry['control_energy']:.2f} "
              f"ddpm_mse={entry['ddpm_mse']:.6f} ({walltime:.1f}s)", flush=True)
        os.makedirs(os.path.dirname(args.save_file) or ".", exist_ok=True)
        with open(args.save_file, "w") as fh:
            json.dump(results, fh, indent=2)
    print("saved", args.save_file, flush=True)
    return results


if __name__ == "__main__":
    main(build_parser().parse_args())
