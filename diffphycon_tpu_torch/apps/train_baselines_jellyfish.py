#!/usr/bin/env python
"""Train and evaluate the RL baselines (BC / BPPO / SAC) on jellyfish
control on the GPU.

Port of ``apps/train_baselines_jellyfish.py``, plus ``--device`` (default
cuda). The environment is ``JellyfishRLEnv`` on the surrogate pipeline
(ForceUNet thrust, simulator next state, boundary updater), loaded from
``--surrogate_folder`` (``apps/train_surrogates_jellyfish.py``); the action
is the per-step theta increment. The offline buffer replays the dataset's
flapping schedules (its theta steps, rescaled to [-1, 1]) through the env
from each train sim's first frame; ``--partially_observed`` gives the
policy the pressure channel alone. BC and BPPO train MLP policies on the
buffer; SAC trains MLPs with its replay seeded by the buffer and filled
online. Every method is scored closed loop on the test split with
``jellyfish_objective`` (weighted mean thrust - reg * sum dtheta^2). The row
appended to ``--save_file`` is the JAX app's, plus ``updates`` and
``update_s`` (the update loops' seconds, synchronised).

Examples:
  python -m diffphycon_tpu_torch.apps.train_baselines_jellyfish --method bc
  python -m diffphycon_tpu_torch.apps.train_baselines_jellyfish --method sac \\
      --partially_observed True
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time


def build_parser():
    p = argparse.ArgumentParser(description="BC / BPPO / SAC jellyfish baselines (PyTorch/CUDA)")
    p.add_argument("--method", default="bc", choices=["bc", "bppo", "sac"])
    p.add_argument("--dataset_path", default="data/jellyfish", type=str)
    p.add_argument("--surrogate_folder", default="trained_models/surrogates", type=str)
    p.add_argument("--n_sims", default=None, type=int)
    p.add_argument("--n_test", default=8, type=int)
    p.add_argument("--frames", default=20, type=int)
    p.add_argument("--bc_steps", default=2000, type=int)
    p.add_argument("--critic_steps", default=1000, type=int)
    p.add_argument("--bppo_steps", default=200, type=int)
    p.add_argument("--sac_steps", default=2000, type=int)
    p.add_argument("--sac_episodes_per_round", default=4, type=int)
    p.add_argument("--batch_size", default=256, type=int)
    p.add_argument("--hidden_dim", default=512, type=int)
    p.add_argument("--depth", default=2, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--act_scale", default=0.1, type=float)
    p.add_argument("--reg_ratio", default=1000.0, type=float)
    p.add_argument("--partially_observed", default=False, type=eval,
                   help="the policy sees the pressure channel, not the whole state")
    p.add_argument("--save_file", default="jellyfish_results/baselines.json")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default=None, type=str,
                   help="default cuda; pass cpu explicitly to run on the CPU")
    return p


def build_env(args, device):
    """(JellyfishRLEnv on the surrogates of ``--surrogate_folder``, the
    benchmark config). The ForceUNet reads raw pressure, so the pipeline
    denormalises the state's pressure with the dataset's p_min / p_max."""
    from diffphycon_tpu_torch.baselines.envs import JellyfishRLEnv
    from diffphycon_tpu_torch.benchmarks import jellyfish as bench
    from diffphycon_tpu_torch.training.surrogates import load_surrogate

    cfg = bench.JellyfishConfig()
    nets = [load_surrogate(args.surrogate_folder, name, build(cfg, device=device), device)
            for name, build in (("simulator", bench.build_simulator_unet),
                                ("force", bench.build_force_unet),
                                ("boundary_updater", bench.build_bd_updater))]
    with open(os.path.join(args.dataset_path, "train_data", "normalization_max_min.pkl"),
              "rb") as fh:
        norm = pickle.load(fh)
    ppl = bench.SurrogatePipeline(cfg, *nets, p_min=float(norm["p_min"]),
                                  p_max=float(norm["p_max"]))
    env = JellyfishRLEnv(ppl, frames=args.frames, act_scale=args.act_scale, reg=args.reg_ratio,
                         partially_observed=args.partially_observed, device=device)
    return env, cfg


def offline_buffer(args, env, states, bd, thetas, n_train):
    """(obs (n, F, D), actions (n, F-1, 1), rewards (n, F-1)) in numpy: each
    train sim's theta steps, rescaled to [-1, 1], replayed through the env
    from its first frame."""
    import numpy as np

    obs_traj, act_traj, rew_traj = [], [], []
    for i in range(n_train):
        obs = env.reset(states[i, :1], bd[i, :1], thetas[i, :1])
        o_list, a_list, r_list = [obs.cpu().numpy()], [], []
        for t in range(args.frames - 1):
            d = float(thetas[i, t + 1] - thetas[i, t])
            a = np.asarray([[np.clip(d / args.act_scale, -1, 1)]], np.float32)
            obs, r, _ = env.step(a)
            o_list.append(obs.cpu().numpy())
            a_list.append(a)
            r_list.append(r.cpu().numpy())
        obs_traj.append(np.concatenate(o_list))
        act_traj.append(np.concatenate(a_list))
        rew_traj.append(np.concatenate(r_list))
    return np.stack(obs_traj), np.stack(act_traj), np.stack(rew_traj).astype(np.float32)


def main(args):
    """Train the method, evaluate it closed loop on the test split; returns
    the row."""
    import numpy as np
    import torch

    from diffphycon_tpu_torch.baselines.rl import (
        BPPO,
        SAC,
        BehaviorCloning,
        QSarsaLearner,
        ReplayBuffer,
        RingReplay,
        ValueLearner,
    )
    from diffphycon_tpu_torch.device import resolve_device
    from diffphycon_tpu_torch.training.data import load_jellyfish_dataset

    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    env, _ = build_env(args, device)
    data = load_jellyfish_dataset(args.dataset_path, "train", n=args.n_sims,
                                  only_vis_pressure=False)
    states, bd, thetas = data["states"], data["bd"], data["thetas"]
    n = thetas.shape[0]

    t0 = time.time()
    n_train = min(n, 16) if args.n_sims is None else n
    obs_traj, act_traj, rew_traj = offline_buffer(args, env, states, bd, thetas, n_train)
    print(f"offline buffer {obs_traj.shape} in {time.time() - t0:.1f}s", flush=True)
    buf = ReplayBuffer.from_trajectories(obs_traj, act_traj, rew_traj)

    obs_dim = obs_traj.shape[-1]
    results = {"method": args.method, "partially_observed": bool(args.partially_observed)}
    update_s = 0.0
    if args.method in ("bc", "bppo"):
        bc = BehaviorCloning(obs_dim, 1, args.hidden_dim, args.depth, args.lr,
                             batch_size=args.batch_size, seed=args.seed, device=device)
        tic = time.perf_counter()
        loss = float("nan")  # stays NaN when --bc_steps 0
        for _ in range(args.bc_steps):
            loss = bc.update(buf)
        results["bc_loss"] = loss
        learner, updates = bc, args.bc_steps
        if args.method == "bppo":
            v = ValueLearner(obs_dim, args.hidden_dim, args.depth, args.lr,
                             batch_size=args.batch_size, seed=args.seed, device=device)
            q = QSarsaLearner(obs_dim, 1, args.hidden_dim, args.depth, args.lr,
                              batch_size=args.batch_size, seed=args.seed, device=device)
            for _ in range(args.critic_steps):
                v.update(buf)
                q.update(buf)
            learner = BPPO(bc, q, v, lr=args.lr, batch_size=args.batch_size, seed=args.seed)
            for _ in range(args.bppo_steps):
                loss = learner.update(buf)
            results["bppo_loss"] = loss
            updates += 2 * args.critic_steps + args.bppo_steps
        update_s = time.perf_counter() - tic  # update() returns floats: synchronised
        select = learner.select_action
    else:
        sac = SAC(obs_dim, 1, args.hidden_dim, args.depth, seed=args.seed,
                  batch_size=args.batch_size, device=device)
        replay = RingReplay(100_000, obs_dim, 1)
        mask = np.concatenate([np.ones(rew_traj.shape[1] - 1), [0.0]]).astype(np.float32)
        for ep in range(rew_traj.shape[0]):
            replay.push_batch(obs_traj[ep, :-1], act_traj[ep], rew_traj[ep], obs_traj[ep, 1:],
                              mask)
        explore = torch.Generator(device=device).manual_seed(args.seed + 17)
        ql = pl = float("nan")
        updates = 0
        while updates < args.sac_steps:
            for _ in range(args.sac_episodes_per_round):
                i = int(rng.integers(0, n))
                obs = env.reset(states[i, :1], bd[i, :1], thetas[i, :1])
                done = False
                while not done:
                    noise = torch.randn(obs.shape[0], 1, generator=explore, device=device)
                    a = sac.select_action(obs, noise=noise)
                    obs2, r, done = env.step(a)
                    replay.push_batch(obs.cpu().numpy(), a.cpu().numpy(), r.cpu().numpy(),
                                      obs2.cpu().numpy(), [0.0 if done else 1.0])
                    obs = obs2
            tic = time.perf_counter()
            for _ in range(args.frames * args.sac_episodes_per_round):
                ql, pl = sac.update(replay)
            update_s += time.perf_counter() - tic
            updates += args.frames * args.sac_episodes_per_round
        results["sac_q_loss"], results["sac_pi_loss"] = ql, pl
        select = sac.select_action
    results["updates"], results["update_s"] = updates, update_s

    # closed-loop evaluation on held-out initial conditions
    test = load_jellyfish_dataset(args.dataset_path, "test", n=args.n_test,
                                  only_vis_pressure=False)
    obs = env.reset(test["states"][:, 0], test["bd"][:, 0], test["thetas"][:, 0])
    done = False
    while not done:
        obs, _, done = env.step(select(obs))
    metrics = env.metrics()
    results.update(metrics)
    results["objective_convention"] = "jellyfish_objective"
    print(f"{args.method}: J={metrics['J_jellyfish']:.4f} avg_force={metrics['avg_force']:.4f} "
          f"theta_reg={metrics['theta_reg']:.5f}", flush=True)
    os.makedirs(os.path.dirname(args.save_file) or ".", exist_ok=True)
    with open(args.save_file, "a") as fh:
        fh.write(json.dumps(results) + "\n")
    return results


if __name__ == "__main__":
    main(build_parser().parse_args())
