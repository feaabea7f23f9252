#!/usr/bin/env python
"""Train the smoke joint p(u, w) or prior p(w) video diffusion model on the
GPU.

Port of ``apps/train_smoke.py`` (the same flags), plus ``--device`` (default
cuda; ``--cpu`` means ``--device cpu``). A UNet3D over (B, 32, 64, 64, C)
is trained with ``p_losses`` under the initial-density conditioning; the w
model trains on the control channels [..., 3:5] and keeps the JAX frame-0
pin of its channel 0. ``--remat_all`` (default True) recomputes every UNet3D
block in the backward (``torch.utils.checkpoint``), a memory switch that
leaves the numbers as they are. Checkpoints are torch files under
``<results_folder>/ckpt/<step>/`` (default ``./trained_models/{smoke,
smoke_w}/``), which ``apps/infer_smoke.py`` reads. Under ``torchrun
--nproc_per_node N`` it trains data-parallel, one GPU a rank, on global
batches of ``--batch_size``.

Examples:
  python -m diffphycon_tpu_torch.apps.train_smoke --dataset_path data/smoke
  python -m diffphycon_tpu_torch.apps.train_smoke --is_w_model True
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description="Train smoke DDPM (PyTorch/CUDA)")
    p.add_argument("--dataset_path", default="data/smoke", type=str)
    p.add_argument("--n_sims", default=None, type=int,
                   help="limit number of training sims (None = all)")
    p.add_argument("--is_w_model", default=False, type=eval)
    p.add_argument("--train_num_steps", default=400000, type=int)
    p.add_argument("--checkpoint_interval", default=10000, type=int)
    p.add_argument("--batch_size", default=16, type=int)
    p.add_argument("--grad_accum", default=1, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--results_folder", default=None, type=str)
    p.add_argument("--dim", default=64, type=int)
    p.add_argument("--dim_mults", nargs="+", default=[1, 2, 4], type=int)
    p.add_argument("--frames", default=32, type=int)
    p.add_argument("--image_size", default=64, type=int)
    p.add_argument("--beta_schedule", default="linear", type=str)
    p.add_argument("--bf16", default=False, type=eval)
    p.add_argument("--remat_all", default=True, type=eval,
                   help="recompute every UNet3D block in the backward (memory only)")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default=None, type=str,
                   help="default cuda; pass cpu explicitly to run on the CPU")
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    p.add_argument("--resume", default=False, type=eval,
                   help="restore the latest checkpoint in results_folder")
    return p


def main(args):
    """Train; returns the Trainer (its ``step`` is the final step)."""
    import torch

    from diffphycon_tpu_torch.benchmarks import smoke as bench
    from diffphycon_tpu_torch.diffusion import smoke_derive_cond
    from diffphycon_tpu_torch.parallel import make_mesh
    from diffphycon_tpu_torch.training.data import ArrayDataset, load_smoke_dataset
    from diffphycon_tpu_torch.training.trainer import Trainer, TrainerConfig

    mesh = make_mesh(device="cpu" if args.cpu else args.device)
    device = mesh.device
    cfg = bench.SmokeConfig(dim=args.dim, dim_mults=tuple(args.dim_mults), frames=args.frames,
                            image_size=args.image_size, is_w_model=args.is_w_model,
                            beta_schedule=args.beta_schedule, bf16=args.bf16,
                            remat_all=args.remat_all)
    data = load_smoke_dataset(args.dataset_path, "train", n=args.n_sims, frames=args.frames)
    if args.is_w_model:
        data = data[..., 3:5]  # the control channels only
    print(f"data: {data.shape}", flush=True)

    net = bench.init_params(cfg, args.seed, device=device).train()
    gd = bench.build_diffusion(cfg, net, device=device)
    sub = "smoke_w" if args.is_w_model else "smoke"
    tcfg = TrainerConfig(
        train_batch_size=args.batch_size,
        train_lr=args.lr,
        train_num_steps=args.train_num_steps,
        gradient_accumulate_every=args.grad_accum,
        save_and_sample_every=args.checkpoint_interval,
        results_folder=args.results_folder or f"./trained_models/{sub}/",
        lr_schedule="multistep",
        seed=args.seed,
    )
    trainer = Trainer(gd, net, ArrayDataset(data).batches(args.batch_size, seed=args.seed),
                      smoke_derive_cond, tcfg, mesh=mesh)
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
