#!/usr/bin/env python
"""Online SAC for Burgers control through the solver, on the GPU.

Port of ``apps/train_sac_burgers.py`` (reference
sac_burgers/burgers_sac_train_quarter.py), plus ``--device`` (default cuda).
The MDP state is [t, u_t, u_target] (2 Nx + 1), the action the control at
the controllable points (the front and rear quarters, Nx / 2, or all Nx),
the reward -|u_{t+1} - u_target|^2 / Nx - reward_f |f_t|^2. The replay
(host memory, ``baselines.rl.RingReplay``) is seeded with the dataset's
transitions; each episode rolls the exploring policy 10 frames through
``burgers_solve(..., num_t=1)`` for ``--train_batch_size`` trajectories,
pushes them, then runs ``--updates_per_step`` SAC updates. Every
``--eval_every`` episodes the deterministic policy is scored on the held-out
trajectories. Writes ``--save_file`` (JSON) with the episode rows, the last
J_actual and energy, and ``update_s`` (the update loops' seconds,
synchronised) and ``updates``.

Example:
  python -m diffphycon_tpu_torch.apps.train_sac_burgers --num_episode 100 \\
      --partial_control front_rear_quarter
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_parser():
    p = argparse.ArgumentParser(description="Online SAC on Burgers (PyTorch/CUDA)")
    p.add_argument("--n_data", default=512, type=int)
    p.add_argument("--n_test", default=50, type=int)
    p.add_argument("--num_episode", default=300, type=int,
                   help="online episodes (reference default 1500)")
    p.add_argument("--train_batch_size", default=32, type=int,
                   help="trajectories rolled per episode")
    p.add_argument("--updates_per_step", default=50, type=int)
    p.add_argument("--batch_size", default=1024, type=int,
                   help="SAC update minibatch (reference 8192)")
    p.add_argument("--hidden_dim", default=512, type=int)
    p.add_argument("--depth", default=2, type=int)
    p.add_argument("--lr", default=3e-4, type=float)
    p.add_argument("--gamma", default=0.5, type=float, help="discount (reference default 0.5)")
    p.add_argument("--tau", default=0.05, type=float)
    p.add_argument("--reward_f", default=0.0, type=float, help="control-energy penalty weight")
    p.add_argument("--action_scale", default=10.0, type=float,
                   help="tanh action -> physical forcing amplitude")
    p.add_argument("--replay_size", default=1_000_000, type=int)
    p.add_argument("--partial_control", default=None, type=str)
    p.add_argument("--partially_observed", default=None, type=str,
                   help="'front_rear_quarter' zeroes the unobserved middle half of u in "
                        "MDP states")
    p.add_argument("--solver_dt", default=1e-3, type=float)
    p.add_argument("--eval_every", default=25, type=int)
    p.add_argument("--save_file", default="burgers_results/sac.json")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default=None, type=str,
                   help="default cuda; pass cpu explicitly to run on the CPU")
    return p


def main(args):
    """Train online and score; returns the results dict (also written)."""
    import numpy as np
    import torch

    from diffphycon_tpu_torch.baselines.rl import SAC, RingReplay
    from diffphycon_tpu_torch.device import resolve_device
    from diffphycon_tpu_torch.physics.burgers import burgers_solve, make_burgers_data

    device = resolve_device(args.device)
    nx = 128
    partial = args.partial_control == "front_rear_quarter"
    act_dim = nx // 2 if partial else nx
    state_dim = 2 * nx + 1

    def expand_action(a):
        """Controllable slots -> the full grid."""
        if not partial:
            return a
        full = torch.zeros(a.shape[0], nx, device=a.device)
        full[:, : nx // 4] = a[:, : nx // 4]
        full[:, 3 * nx // 4 :] = a[:, nx // 4 :]
        return full

    def contract_action(f):
        if not partial:
            return f
        return np.concatenate([f[:, : nx // 4], f[:, 3 * nx // 4 :]], -1)

    omask = np.ones((nx,), np.float32)
    if args.partially_observed == "front_rear_quarter":
        omask[nx // 4 : 3 * nx // 4] = 0.0

    def mdp_state(t, u, u_tgt):
        return np.concatenate([np.full((u.shape[0], 1), float(t), np.float32), u * omask,
                               u_tgt * omask], -1)

    # trajectories of the generating distribution; each one's final state is
    # its own control target
    u0, f = make_burgers_data(args.n_data + args.n_test, seed=args.seed,
                              partial_control=args.partial_control)
    with torch.no_grad():
        traj = burgers_solve(torch.as_tensor(u0, device=device), torch.as_tensor(f, device=device),
                             dt=args.solver_dt).cpu().numpy()
    train_traj, train_f = traj[: args.n_data], f[: args.n_data]
    test_traj = traj[args.n_data :]

    replay = RingReplay(args.replay_size, state_dim, act_dim)
    tgt = train_traj[:, -1]
    for t in range(10):
        r = -((tgt - train_traj[:, t + 1]) ** 2).sum(-1) / nx
        r = r - args.reward_f * (train_f[:, t] ** 2).sum(-1)
        replay.push_batch(
            mdp_state(t, train_traj[:, t], tgt),
            np.clip(contract_action(train_f[:, t]) / args.action_scale, -1, 1),
            r, mdp_state(t + 1, train_traj[:, t + 1], tgt), 0.0 if t == 9 else 1.0)

    agent = SAC(state_dim, act_dim, args.hidden_dim, args.depth, lr=args.lr, gamma=args.gamma,
                tau=args.tau, batch_size=args.batch_size, seed=args.seed, device=device)

    @torch.no_grad()
    def rollout(trajs, explore=None):
        """The policy 10 frames through the solver (``explore``: a generator
        for the exploration noise); returns (u_T, f_full (B, 10, Nx),
        transitions)."""
        u = torch.as_tensor(trajs[:, 0], device=device)
        u_tgt = trajs[:, -1]
        u_tgt_d = torch.as_tensor(u_tgt, device=device)
        fs, trans = [], []
        for t in range(10):
            s = mdp_state(t, u.cpu().numpy(), u_tgt)
            s_d = torch.as_tensor(s, device=device)
            if explore is not None:
                noise = torch.randn(s.shape[0], act_dim, generator=explore, device=device)
                a = agent.select_action(s_d, noise=noise)
            else:
                a = agent.select_action(s_d)
            f_full = expand_action(a) * args.action_scale
            u2 = burgers_solve(u, f_full[:, None], visc=0.01, T=0.1, dt=args.solver_dt,
                               num_t=1)[:, -1]
            r = (-((u_tgt_d - u2) ** 2).sum(-1) / nx
                 - args.reward_f * (f_full ** 2).sum(-1)).cpu().numpy()
            u2_np = u2.cpu().numpy()
            trans.append((s, a.cpu().numpy(), r, mdp_state(t + 1, u2_np, u_tgt),
                          0.0 if t == 9 else 1.0))
            fs.append(f_full.cpu().numpy())
            u = u2
        return u.cpu().numpy(), np.stack(fs, 1), trans

    rng = np.random.default_rng(args.seed)
    explore = torch.Generator(device=device).manual_seed(args.seed + 17)
    os.makedirs(os.path.dirname(args.save_file) or ".", exist_ok=True)
    results = {"episodes": []}
    update_s = 0.0
    for ep in range(args.num_episode):
        idx = rng.integers(0, args.n_data, args.train_batch_size)
        _, _, trans = rollout(train_traj[idx], explore=explore)
        for tr in trans:
            replay.push_batch(*tr)
        tic = time.perf_counter()
        for _ in range(args.updates_per_step):
            ql, pl = agent.update(replay)
        update_s += time.perf_counter() - tic  # update() returns floats: synchronised
        if (ep + 1) % args.eval_every == 0 or ep == args.num_episode - 1:
            uT, f_all, _ = rollout(test_traj)  # deterministic policy
            j = float(((uT - test_traj[:, -1]) ** 2).mean())
            e = float((f_all ** 2).sum((-1, -2)).mean())
            print(f"episode {ep + 1}/{args.num_episode} q={ql:.4f} pi={pl:.4f} "
                  f"J_actual={j:.6f} energy={e:.1f}", flush=True)
            results["episodes"].append({"episode": ep + 1, "q_loss": ql, "pi_loss": pl,
                                        "J_actual_mse": j, "control_energy": e})

    results["J_actual_mse"] = results["episodes"][-1]["J_actual_mse"]
    results["control_energy"] = results["episodes"][-1]["control_energy"]
    results["updates"] = args.num_episode * args.updates_per_step
    results["update_s"] = update_s
    with open(args.save_file, "w") as fh:
        json.dump(results, fh, indent=2)
    print(json.dumps({k: results[k] for k in ("J_actual_mse", "control_energy")}), flush=True)
    return results


if __name__ == "__main__":
    main(build_parser().parse_args())
