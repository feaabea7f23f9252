#!/usr/bin/env python
"""Train and evaluate the RL baselines (BC / BPPO / SAC) on Burgers control
on the GPU.

Port of ``apps/train_baselines_burgers.py``, plus ``--device`` (default
cuda): an offline buffer from solver trajectories (state u_t / 10 ->
action f_t / 10 clipped to [-1, 1], reward the negative deviation from the
trajectory's own final state), the policy trained on it, then run closed
loop frame by frame through the solver and scored by J_actual (final-state
MSE) and the control energy. ``--partially_observed front_rear_quarter``
zeroes the middle half of u in the policy's states; ``--partial_control``
restricts the data's forcing and the policy's actions to the front and rear
quarters. The row appended to ``--save_file`` is the JAX app's, plus
``updates`` and ``update_s`` (the update loop's seconds, synchronised).

Example:
  python -m diffphycon_tpu_torch.apps.train_baselines_burgers --method bppo
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_parser():
    p = argparse.ArgumentParser(description="BC / BPPO / SAC Burgers baselines (PyTorch/CUDA)")
    p.add_argument("--method", default="bc", choices=["bc", "bppo", "sac"])
    p.add_argument("--n_data", default=512, type=int)
    p.add_argument("--n_test", default=32, type=int)
    p.add_argument("--bc_steps", default=2000, type=int)
    p.add_argument("--critic_steps", default=2000, type=int)
    p.add_argument("--bppo_steps", default=200, type=int)
    p.add_argument("--sac_steps", default=2000, type=int)
    p.add_argument("--hidden_dim", default=512, type=int)
    p.add_argument("--depth", default=2, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--partial_control", default=None, type=str)
    p.add_argument("--partially_observed", default=None, type=str,
                   help="'front_rear_quarter' zeroes the unobserved middle half of u in "
                        "policy states")
    p.add_argument("--solver_dt", default=1e-3, type=float)
    p.add_argument("--save_file", default="burgers_results/baselines.json")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default=None, type=str,
                   help="default cuda; pass cpu explicitly to run on the CPU")
    return p


def obs_mask(nx, partially_observed):
    import numpy as np

    m = np.ones((nx,), np.float32)
    if partially_observed == "front_rear_quarter":
        m[nx // 4 : 3 * nx // 4] = 0.0
    return m


def closed_loop_eval(select_action, u_target, dt, device, partial_control=None,
                     partially_observed=None):
    """Roll the policy through the solver frame by frame (10 frames of 0.1)
    from u_target[:, 0]; returns (J_actual, control energy) means. The policy
    sees the masked state under partial observation; J is full-state."""
    import torch

    from diffphycon_tpu_torch.baselines.sl_burgers import control_mask
    from diffphycon_tpu_torch.physics.burgers import burgers_solve

    nx = u_target.shape[-1]
    omask = torch.as_tensor(obs_mask(nx, partially_observed), device=device)
    amask = control_mask(nx, partial_control, device)
    u_tgt = torch.as_tensor(u_target, device=device)
    u = u_tgt[:, 0]
    fs = []
    with torch.no_grad():
        for _ in range(10):
            a = select_action(u * omask / 10.0) * 10.0 * amask
            fs.append(a)
            u = burgers_solve(u, a[:, None, :], visc=0.01, T=0.1, dt=dt, num_t=1)[:, -1]
        f = torch.stack(fs, dim=1)
        j_actual = ((u - u_tgt[:, -1]) ** 2).mean(-1)
        energy = (f ** 2).sum(dim=(-1, -2))
    return float(j_actual.mean()), float(energy.mean())


def main(args):
    """Train the method, evaluate it closed loop; returns the row."""
    import numpy as np
    import torch

    from diffphycon_tpu_torch.baselines.rl import (
        BPPO,
        SAC,
        BehaviorCloning,
        QSarsaLearner,
        ReplayBuffer,
        ValueLearner,
    )
    from diffphycon_tpu_torch.device import resolve_device
    from diffphycon_tpu_torch.physics.burgers import burgers_solve, make_burgers_data

    device = resolve_device(args.device)
    u0, f = make_burgers_data(args.n_data + args.n_test, seed=args.seed,
                              partial_control=args.partial_control)
    with torch.no_grad():
        traj = burgers_solve(torch.as_tensor(u0, device=device), torch.as_tensor(f, device=device),
                             dt=args.solver_dt).cpu().numpy()
    # offline dataset: the expert actions are the generating forcings; the
    # reward is the negative deviation from the trajectory's own final state
    nx = u0.shape[-1]
    omask = obs_mask(nx, args.partially_observed)
    states = traj[: args.n_data] * omask / 10.0
    actions = (f[: args.n_data] / 10.0).clip(-1, 1)
    rewards = -((traj[: args.n_data, 1:] - traj[: args.n_data, -1:]) ** 2
                ).mean(-1).astype(np.float32)
    buf = ReplayBuffer.from_trajectories(states, actions, rewards)
    u_target = traj[args.n_data :]
    results = {"method": args.method, "partially_observed": args.partially_observed,
               "partial_control": args.partial_control, "n_test": args.n_test}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    tic = time.perf_counter()
    if args.method in ("bc", "bppo"):
        bc = BehaviorCloning(nx, nx, args.hidden_dim, args.depth, args.lr, seed=args.seed,
                             device=device)
        loss = float("nan")  # stays NaN when --bc_steps 0
        for _ in range(args.bc_steps):
            loss = bc.update(buf)
        results["bc_loss"] = loss
        select, updates = bc.select_action, args.bc_steps
        if args.method == "bppo":
            v = ValueLearner(nx, args.hidden_dim, args.depth, args.lr, seed=args.seed,
                             device=device)
            q = QSarsaLearner(nx, nx, args.hidden_dim, args.depth, args.lr, seed=args.seed,
                              device=device)
            for _ in range(args.critic_steps):
                v.update(buf)
                q.update(buf)
            bppo = BPPO(bc, q, v, lr=args.lr, seed=args.seed)
            for _ in range(args.bppo_steps):
                loss = bppo.update(buf)
            results["bppo_loss"] = loss
            select = bppo.select_action
            updates += 2 * args.critic_steps + args.bppo_steps
    else:
        sac = SAC(nx, nx, args.hidden_dim, args.depth, seed=args.seed, device=device)
        ql = pl = float("nan")
        for _ in range(args.sac_steps):
            ql, pl = sac.update(buf)
        results["sac_q_loss"], results["sac_pi_loss"] = ql, pl
        select, updates = sac.select_action, args.sac_steps
    sync()
    results["updates"], results["update_s"] = updates, time.perf_counter() - tic

    j, e = closed_loop_eval(select, u_target, args.solver_dt, device, args.partial_control,
                            args.partially_observed)
    results["J_actual_mse"] = j
    results["control_energy"] = e
    print(f"{args.method}: J_actual={j:.6f} energy={e:.2f}", flush=True)
    os.makedirs(os.path.dirname(args.save_file) or ".", exist_ok=True)
    with open(args.save_file, "a") as fh:
        fh.write(json.dumps(results) + "\n")
    return results


if __name__ == "__main__":
    main(build_parser().parse_args())
