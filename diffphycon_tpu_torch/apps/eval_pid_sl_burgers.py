#!/usr/bin/env python
"""Evaluate the PID and SL Burgers baselines on the held-out set on the GPU
and append rows to burgers_results/baselines.json.

Port of ``apps/eval_pid_sl_burgers.py``, plus ``--device`` (default cuda).
Each controller is scored by re-simulating its forcing through the solver:
J_actual (final-state MSE) and the control energy, on the held-out tail of
the generator stream that ``train_baselines_burgers.py`` also holds out.
Methods:

  - pid: per-point PID gains tuned by Adam through the solver rollout;
  - sl: Adam on the forcing through the differentiable solver;
  - sl_surrogate: Adam on the forcing through the latent operator trained
    by ``apps/train_burgers_operator.py`` (its ``params_sob128.pt``; the
    JAX app reads an orbax directory). Without that file it is skipped.

Example:
  python -m diffphycon_tpu_torch.apps.eval_pid_sl_burgers --n_data 512 --n_test 32
"""

from __future__ import annotations

import argparse
import json
import os


def build_parser():
    p = argparse.ArgumentParser(description="PID / SL Burgers baselines (PyTorch/CUDA)")
    p.add_argument("--n_data", default=512, type=int,
                   help="offset into the generator stream; the held-out targets match "
                        "train_baselines_burgers.py defaults")
    p.add_argument("--n_test", default=32, type=int)
    p.add_argument("--pid_steps", default=100, type=int)
    p.add_argument("--sl_steps", default=100, type=int)
    p.add_argument("--sl_lr", default=5e-2, type=float)
    p.add_argument("--solver_dt", default=1e-3, type=float)
    p.add_argument("--partial_control", default=None, type=str)
    p.add_argument("--operator_folder", default="trained_models/burgers_operator", type=str)
    p.add_argument("--methods", default="pid,sl,sl_surrogate", type=str,
                   help="comma-separated subset of pid,sl,sl_surrogate")
    p.add_argument("--save_file", default="burgers_results/baselines.json")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default=None, type=str,
                   help="default cuda; pass cpu explicitly to run on the CPU")
    return p


def _row(args, method, j, e):
    return {"method": method, "partially_observed": None,
            "partial_control": args.partial_control, "n_test": args.n_test,
            "J_actual_mse": j, "control_energy": e}


def main(args):
    """Run the chosen methods; returns their rows (also appended to
    ``--save_file``)."""
    import torch

    from diffphycon_tpu_torch.baselines.pid_burgers import pid_control
    from diffphycon_tpu_torch.baselines.sl_burgers import control_mask, sl_optimize_control
    from diffphycon_tpu_torch.device import resolve_device
    from diffphycon_tpu_torch.nets.burgers_operator import SurrogateOperator
    from diffphycon_tpu_torch.physics.burgers import burgers_solve, make_burgers_data

    device = resolve_device(args.device)
    u0_all, f_all = make_burgers_data(args.n_data + args.n_test, seed=args.seed,
                                      partial_control=args.partial_control)
    with torch.no_grad():  # only the held-out tail is ever scored
        target = burgers_solve(torch.as_tensor(u0_all[args.n_data:], device=device),
                               torch.as_tensor(f_all[args.n_data:], device=device),
                               dt=args.solver_dt)  # (n_test, 11, Nx)
    u0, tgt_T = target[:, 0], target[:, -1]

    @torch.no_grad()
    def score(f):
        """Re-simulate through the solver: (J_actual, control energy)."""
        sim = burgers_solve(u0, f, visc=0.01, T=1.0, dt=args.solver_dt, num_t=10)
        return (float(((sim[:, -1] - tgt_T) ** 2).mean(-1).mean()),
                float((f ** 2).sum(dim=(-1, -2)).mean()))

    rows = []
    methods = set(args.methods.split(","))
    if "pid" in methods:
        mask = (control_mask(u0.shape[-1], args.partial_control, device)
                if args.partial_control == "front_rear_quarter" else None)
        _, f_pid, _, _ = pid_control(u0, target, lr=1e-2, steps=args.pid_steps,
                                     dt=args.solver_dt, seed=args.seed, control_mask=mask)
        rows.append(_row(args, "pid", *score(f_pid)))
        print(f"pid: J_actual={rows[-1]['J_actual_mse']:.6f} "
              f"energy={rows[-1]['control_energy']:.2f}", flush=True)
    if "sl" in methods:
        f_sl, _ = sl_optimize_control(u0, tgt_T, lr=args.sl_lr, steps=args.sl_steps,
                                      solver_dt=args.solver_dt,
                                      partial_control=args.partial_control)
        rows.append(_row(args, "sl", *score(f_sl)))
        print(f"sl (true solver): J_actual={rows[-1]['J_actual_mse']:.6f} "
              f"energy={rows[-1]['control_energy']:.2f}", flush=True)
    if "sl_surrogate" in methods:
        ckpt = os.path.join(args.operator_folder, "params_sob128.pt")
        if os.path.isfile(ckpt):
            op = SurrogateOperator(s=128, s_ob=128, device=device)
            state = torch.load(ckpt, map_location=device, weights_only=True)
            f_ss, _ = sl_optimize_control(u0, tgt_T, lr=args.sl_lr, steps=args.sl_steps,
                                          solver_dt=args.solver_dt,
                                          partial_control=args.partial_control,
                                          surrogate=(op, state))
            rows.append(_row(args, "sl_surrogate", *score(f_ss)))
            print(f"sl (latent operator): J_actual={rows[-1]['J_actual_mse']:.6f} "
                  f"energy={rows[-1]['control_energy']:.2f}", flush=True)
        else:
            print(f"no operator checkpoint at {ckpt}; skipping sl_surrogate", flush=True)

    os.makedirs(os.path.dirname(args.save_file) or ".", exist_ok=True)
    with open(args.save_file, "a") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")
    return rows


if __name__ == "__main__":
    main(build_parser().parse_args())
