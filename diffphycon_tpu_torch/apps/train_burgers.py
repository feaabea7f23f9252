#!/usr/bin/env python
"""Train the Burgers joint p(u, w) or prior p(w) diffusion model on the GPU.

Port of ``apps/train_burgers.py`` (the reference's train_1d_burgers.py flag
names), plus ``--device`` (default cuda; ``--cpu`` means ``--device cpu``).
The UNet2D forward runs through the port's hand-written kernels; their
backward is the VJP of the plain versions. Under ``torchrun
--nproc_per_node N`` it trains data-parallel, one GPU a rank, on global
batches of ``--batch_size`` (``parallel.make_mesh``); run plainly it
trains on one device. Checkpoints are torch files under
``<results_folder>/ckpt/<step>/`` (default results folder
``./trained_models/{burgers|burgers_w}/<exp_id>/``), which
``apps/infer_burgers.py --checkpoint`` reads.

Examples:
  python -m diffphycon_tpu_torch.apps.train_burgers --dataset free_u_f_1e5 \\
      --is_condition_u0 True --is_condition_uT True
  python -m diffphycon_tpu_torch.apps.train_burgers --is_model_w True \\
      --is_condition_u0 True --is_condition_uT True
  python -m diffphycon_tpu_torch.apps.train_burgers --synthetic_data 2048 \\
      --train_num_steps 2000
  torchrun --nproc_per_node 4 -m diffphycon_tpu_torch.apps.train_burgers \\
      --batch_size 64 --is_condition_u0 True --is_condition_uT True
"""

from __future__ import annotations

import argparse
import os


def none_or_str(x):
    return None if x in ("None", None) else x


def build_parser():
    p = argparse.ArgumentParser(description="Train Burgers DDPM (PyTorch/CUDA)")
    p.add_argument("--exp_id", default="gen-control", type=str)
    p.add_argument("--dataset", default="free_u_f_1e5", type=str)
    p.add_argument("--data_root", default="data", type=str,
                   help="directory holding <dataset>/burgers_train.h5")
    p.add_argument("--synthetic_partial_control", default=None, type=none_or_str,
                   help="synthetic data with control restricted to the front/rear "
                        "quarter (the reference's FOPC/POPC dataset)")
    p.add_argument("--synthetic_data", default=0, type=int,
                   help="if >0, solve N synthetic samples on the device instead of "
                        "reading h5")
    p.add_argument("--train_num_steps", default=100000, type=int)
    p.add_argument("--checkpoint_interval", default=10000, type=int)
    p.add_argument("--batch_size", default=16, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--results_folder", default=None, type=str)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default=None, type=str,
                   help="default cuda; pass cpu explicitly to run on the CPU")
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    p.add_argument("--resume", default=False, type=eval,
                   help="restore the latest checkpoint in results_folder")

    p.add_argument("--is_condition_u0", default=False, type=eval)
    p.add_argument("--is_condition_uT", default=False, type=eval)
    p.add_argument("--is_condition_u0_zero_pred_noise", default=True, type=eval)
    p.add_argument("--is_condition_uT_zero_pred_noise", default=True, type=eval)
    p.add_argument("--partially_observed", default=None, type=none_or_str)
    p.add_argument("--train_on_partially_observed", default=None, type=none_or_str)
    p.add_argument("--set_unobserved_to_zero_during_sampling", default=False, type=eval)
    p.add_argument("--recurrence", default=False, type=eval)
    p.add_argument("--recurrence_k", default=1, type=int)
    p.add_argument("--using_ddim", default=False, type=eval)
    p.add_argument("--ddim_eta", default=0.0, type=float)
    p.add_argument("--ddim_sampling_steps", default=1000, type=int)

    p.add_argument("--dim", default=64, type=int)
    p.add_argument("--resnet_block_groups", default=1, type=int)
    p.add_argument("--dim_mults", "--dim_muls", dest="dim_mults", nargs="+",
                   default=[1, 2, 4, 8], type=int)

    p.add_argument("--is_model_w", default=False, type=eval)
    p.add_argument("--prior_beta", default=1, type=float)
    p.add_argument("--bf16", default=False, type=eval)
    return p


def main(args):
    """Train; returns the Trainer (its ``step`` is the final step)."""
    from diffphycon_tpu_torch.benchmarks import burgers as bench
    from diffphycon_tpu_torch.parallel import make_mesh
    from diffphycon_tpu_torch.training import data
    from diffphycon_tpu_torch.training.trainer import Trainer, TrainerConfig

    mesh = make_mesh(device="cpu" if args.cpu else args.device)
    device = mesh.device
    cfg = bench.BurgersConfig(
        dim=args.dim,
        dim_mults=tuple(args.dim_mults),
        resnet_block_groups=args.resnet_block_groups,
        using_ddim=args.using_ddim,
        ddim_sampling_steps=args.ddim_sampling_steps,
        ddim_eta=args.ddim_eta,
        is_condition_u0=args.is_condition_u0,
        is_condition_uT=args.is_condition_uT,
        is_condition_u0_zero_pred_noise=args.is_condition_u0_zero_pred_noise,
        is_condition_uT_zero_pred_noise=args.is_condition_uT_zero_pred_noise,
        train_on_partially_observed=args.train_on_partially_observed,
        set_unobserved_to_zero_during_sampling=args.set_unobserved_to_zero_during_sampling,
        partially_observed=args.partially_observed,
        is_model_w=args.is_model_w,
        prior_beta=args.prior_beta,
        recurrence=args.recurrence,
        recurrence_k=args.recurrence_k,
        bf16=args.bf16,
    )

    if args.synthetic_data > 0:
        with mesh.main_first():  # rank 0 writes the cache the others read
            u, f = data.synthetic_burgers(
                args.synthetic_data, seed=args.seed,
                partial_control=args.synthetic_partial_control,
                cache_dir=os.path.join(args.data_root, "synthetic"), device=device)
    else:
        u, f = data.load_burgers_h5(
            os.path.join(args.data_root, args.dataset, "burgers_train.h5"), "train")
    stacked = data.stack_burgers_uf(u, f, rescaler=bench.RESCALER,
                                    partially_observed_fill_zero=args.partially_observed)
    print(f"data: {stacked.shape} (rescaled by {bench.RESCALER})", flush=True)

    net = bench.init_params(cfg, args.seed, device=device)
    gd = bench.build_diffusion(cfg, net, device=device)
    sub = "burgers_w" if args.is_model_w else "burgers"
    results_folder = args.results_folder or f"./trained_models/{sub}/{args.exp_id}/"
    tcfg = TrainerConfig(
        train_batch_size=args.batch_size,
        train_lr=args.lr,
        train_num_steps=args.train_num_steps,
        save_and_sample_every=args.checkpoint_interval,
        results_folder=results_folder,
        seed=args.seed,
    )
    trainer = Trainer(gd, net, data.ArrayDataset(stacked).batches(args.batch_size, seed=args.seed),
                      bench.derive_cond, tcfg, mesh=mesh)
    if args.resume:
        if trainer.resume():
            print(f"resumed from step {trainer.step}", flush=True)
        else:
            print("no checkpoint found; starting fresh", flush=True)
    trainer.train()
    trainer.save()
    print("training complete", flush=True)
    return trainer


if __name__ == "__main__":
    main(build_parser().parse_args())
