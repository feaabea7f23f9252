#!/usr/bin/env python
"""Train a jellyfish surrogate on the GPU: the force readout, the neural
simulator or the boundary updater.

Port of ``apps/train_surrogates_jellyfish.py`` (the same flags), plus
``--device`` (default cuda). The nets start from seeded random weights
(``--seed``); the EMA weights are written to
``<results_folder>/<model>/params.pt``, which ``apps/infer_jellyfish.py``
reads. Force labels come from ``--force_labels``, else from
``<root>/train_data/forces`` (``apps/generate_jellyfish_forces.py``), else
a synthetic pseudo-force, with a warning.

Example:
  python -m diffphycon_tpu_torch.apps.train_surrogates_jellyfish \\
      --dataset_path data/jellyfish --model force --num_steps 2000
"""

from __future__ import annotations

import argparse
import os


def build_parser():
    p = argparse.ArgumentParser(description="Train a jellyfish surrogate (PyTorch/CUDA)")
    p.add_argument("--dataset_path", default="data/jellyfish", type=str)
    p.add_argument("--model", default="force",
                   choices=["force", "simulator", "boundary_updater"])
    p.add_argument("--n_sims", default=None, type=int)
    p.add_argument("--sim_offset", default=0, type=int,
                   help="skip the first N sims: train on a disjoint split, for "
                        "closed-loop scoring that guidance cannot exploit")
    p.add_argument("--num_steps", default=10000, type=int)
    p.add_argument("--batch_size", default=16, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--results_folder", default="trained_models/surrogates", type=str)
    p.add_argument("--only_vis_pressure", default=False, type=eval)
    p.add_argument("--force_labels", default=None, type=str,
                   help="npy of (N, T) force labels")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--resume_training", default=False, type=eval,
                   help="restore <results_folder>/<model>/resume_state.pt")
    p.add_argument("--save_every", default=0, type=int,
                   help="periodic full-state checkpoint interval (steps)")
    p.add_argument("--log_every", default=100, type=int)
    p.add_argument("--device", default=None, type=str,
                   help="default cuda; pass cpu explicitly to run on the CPU")
    return p


def _force_labels(args, data):
    import numpy as np

    forces_dir = os.path.join(args.dataset_path, "train_data", "forces")
    if args.force_labels:
        return np.load(args.force_labels)
    if os.path.isdir(forces_dir):
        # (T, n_bd, 2) per sim; the label is the x-force summed over boundaries
        sims = sorted(f for f in os.listdir(forces_dir) if f.startswith("sim_"))[
            args.sim_offset:]
        if args.n_sims is not None:
            sims = sims[: args.n_sims]
        print(f"using {len(sims)} sims of pressure-force labels from {forces_dir}", flush=True)
        return np.stack([np.load(os.path.join(forces_dir, f))[..., 0].sum(axis=1)
                         for f in sims])
    th = data["thetas"]
    dth = np.concatenate([np.zeros_like(th[:, :1]), np.diff(th, axis=1)], 1)
    print("WARNING: no forces/ dir found; falling back to synthetic pseudo-force labels "
          "(run apps/generate_jellyfish_forces.py for the reference recipe)", flush=True)
    return (-np.sin(th) * np.abs(dth) * 100).astype(np.float32)


def main(args):
    """Train and save; returns (SurrogateState, last logged loss)."""
    import torch

    from diffphycon_tpu_torch.benchmarks import jellyfish as bench
    from diffphycon_tpu_torch.device import resolve_device
    from diffphycon_tpu_torch.training.data import load_jellyfish_dataset
    from diffphycon_tpu_torch.training.surrogates import (
        SurrogateTrainConfig,
        make_surrogate_pairs,
        save_surrogate,
        train_surrogate,
    )

    device = resolve_device(args.device)
    cfg = bench.JellyfishConfig(only_vis_pressure=args.only_vis_pressure)
    data = load_jellyfish_dataset(args.dataset_path, "train", n=args.n_sims,
                                  only_vis_pressure=args.only_vis_pressure,
                                  offset=args.sim_offset)
    labels = _force_labels(args, data) if args.model == "force" else None
    inputs, targets = make_surrogate_pairs(data, args.model, labels)
    build = {"force": bench.build_force_unet, "simulator": bench.build_simulator_unet,
             "boundary_updater": bench.build_bd_updater}[args.model]
    net = build(cfg, seed=args.seed, device=device)
    scfg = SurrogateTrainConfig(
        lr=args.lr, batch_size=args.batch_size, num_steps=args.num_steps,
        lr_milestones=(args.num_steps // 2, (args.num_steps * 4) // 5),
        results_folder=os.path.join(args.results_folder, args.model),
        seed=args.seed, save_every=args.save_every, log_every=args.log_every)
    state, last = train_surrogate(net, inputs, targets, scfg, resume=args.resume_training,
                                  device=device)
    save_surrogate(state, args.results_folder, args.model)
    print(f"{args.model} trained: final loss {last}", flush=True)
    return state, last


if __name__ == "__main__":
    main(build_parser().parse_args())
