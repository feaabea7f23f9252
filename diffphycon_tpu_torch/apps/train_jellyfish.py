#!/usr/bin/env python
"""Train the jellyfish joint (EBM "states") or prior ("thetas") diffusion
model on the GPU.

Port of ``apps/train_jellyfish.py`` (the same flags), plus ``--device``
(default cuda). The joint model trains with the energy parameterisation
(the loss is on the gradient of -||net(x)||^2 with respect to the noisy
state: double backward); the thetas model is a plain eps matcher. Batches
are 20-frame windows of the 40-frame sims. The port's ``Trainer`` runs the
step (global-norm clip, Adam, MultiStepLR, EMA) through an adapter that
routes its loss to ``JellyfishDiffusion.loss``. ``--remat_all`` (default
True) recomputes every UNet3D block in the backward, which carries the
double backward and changes no number. Checkpoints are torch files under
``<results_folder>/ckpt/<step>/`` (default ``./trained_models/{jellyfish,
jellyfish_w}/``), which ``apps/infer_jellyfish.py`` reads. Under ``torchrun
--nproc_per_node N`` it trains data-parallel, one GPU a rank, on global
batches of ``--batch_size``.

Example:
  python -m diffphycon_tpu_torch.apps.train_jellyfish \\
      --dataset_path data/jellyfish --model_type states
"""

from __future__ import annotations

import argparse
import os


def build_parser():
    p = argparse.ArgumentParser(description="Train jellyfish DDPM (PyTorch/CUDA)")
    p.add_argument("--dataset_path", default="data/jellyfish", type=str)
    p.add_argument("--synthetic_data", default=0, type=int,
                   help="if >0, generate N synthetic sims into dataset_path")
    p.add_argument("--model_type", default="states", choices=["states", "thetas"])
    p.add_argument("--n_sims", default=None, type=int)
    p.add_argument("--frames", default=20, type=int)
    p.add_argument("--cond_steps", default=1, type=int)
    p.add_argument("--only_vis_pressure", default=False, type=eval)
    p.add_argument("--train_num_steps", default=700000, type=int)
    p.add_argument("--checkpoint_interval", default=10000, type=int)
    p.add_argument("--batch_size", default=16, type=int)
    p.add_argument("--grad_accum", default=1, type=int,
                   help="micro-batch accumulation")
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--results_folder", default=None, type=str)
    p.add_argument("--dim", default=64, type=int)
    p.add_argument("--dim_mults", nargs="+", default=[1, 2, 4], type=int)
    p.add_argument("--joint_out_dim", default=None, type=int,
                   help="accepted as the JAX app accepts it; the joint model "
                        "always outputs n_state + 1 channels")
    p.add_argument("--bf16", default=False, type=eval)
    p.add_argument("--remat_all", default=True, type=eval,
                   help="recompute every UNet3D block in the backward (memory only)")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--resume", default=False, type=eval,
                   help="restore the latest checkpoint in results_folder")
    p.add_argument("--device", default=None, type=str,
                   help="default cuda; pass cpu explicitly to run on the CPU")
    return p


class _GD:
    """The Trainer's loss seam: draws (t, noise tuple) for a batch tuple
    (states, bd, thetas) and routes the loss to the jellyfish diffusion."""

    def __init__(self, gd, model_type: str):
        self.gd, self.model_type = gd, model_type

    def draw_t_noise(self, batch, generator):
        return self.gd.draw(batch, generator, self.model_type)

    def loss(self, batch, cond, t, noise):
        del cond
        return self.gd.loss(batch, t, noise, self.model_type)


def window_batches(states, bd, thetas, batch_size: int, frames: int, seed: int = 0):
    """Endless (states, bd, thetas) batches: random sims, one random window
    of ``frames`` consecutive frames per batch (numpy's generator, as the
    JAX app draws them)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_windows = states.shape[1] - frames
    while True:
        i = rng.integers(0, states.shape[0], batch_size)
        t0 = rng.integers(0, max(n_windows, 1))
        sl = slice(t0, t0 + frames)
        yield states[i, sl], bd[i, sl], thetas[i, sl]


def main(args):
    """Train; returns the Trainer (its ``step`` is the final step)."""
    import torch

    from diffphycon_tpu_torch.benchmarks import jellyfish as bench
    from diffphycon_tpu_torch.parallel import make_mesh
    from diffphycon_tpu_torch.training.data import load_jellyfish_dataset, synthetic_jellyfish
    from diffphycon_tpu_torch.training.trainer import Trainer, TrainerConfig

    mesh = make_mesh(device=args.device)
    device = mesh.device
    if args.synthetic_data > 0:
        train_dir = os.path.join(args.dataset_path, "train_data")
        with mesh.main_first():  # rank 0 writes the sims the others read
            if not os.path.exists(os.path.join(train_dir, "states")):
                print(f"generating {args.synthetic_data} synthetic sims...", flush=True)
                synthetic_jellyfish(args.synthetic_data, train_dir, seed=args.seed)
    cfg = bench.JellyfishConfig(dim=args.dim, dim_mults=tuple(args.dim_mults),
                                frames=args.frames, cond_steps=args.cond_steps,
                                only_vis_pressure=args.only_vis_pressure, bf16=args.bf16,
                                remat_all=args.remat_all)
    data = load_jellyfish_dataset(args.dataset_path, "train", n=args.n_sims,
                                  only_vis_pressure=args.only_vis_pressure)
    states, bd, thetas = data["states"], data["bd"], data["thetas"]
    print(f"states {states.shape} bd {bd.shape} thetas {thetas.shape}", flush=True)

    build = bench.build_joint_unet if args.model_type == "states" else bench.build_thetas_unet
    net = build(cfg, seed=args.seed, device=device).train()
    gd = bench.JellyfishDiffusion(cfg, net, thetas_model=net, device=device)
    sub = "jellyfish" if args.model_type == "states" else "jellyfish_w"
    tcfg = TrainerConfig(
        train_batch_size=args.batch_size, train_lr=args.lr,
        train_num_steps=args.train_num_steps,
        gradient_accumulate_every=args.grad_accum,
        save_and_sample_every=args.checkpoint_interval,
        results_folder=args.results_folder or f"./trained_models/{sub}/",
        lr_schedule="multistep", seed=args.seed)
    trainer = Trainer(_GD(gd, args.model_type), net,
                      window_batches(states, bd, thetas, args.batch_size, cfg.frames, args.seed),
                      lambda b: None, tcfg, mesh=mesh)
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
