#!/usr/bin/env python
"""Train and evaluate the RL baselines (BC / BPPO / SAC) on smoke control on
the GPU.

Port of ``apps/train_baselines_smoke.py``, plus ``--device`` (default cuda;
``--cpu`` is ``--device cpu``). The offline buffer comes from a generated
smoke dataset's trajectories (``--behavior_from_dataset``) or from
heuristic episodes of ``SmokeRLEnv``, the real 128^2 solver (one K4
pressure solve per physical sub-step on CUDA). BC and BPPO train flat MLP
policies on it; SAC trains a conv policy (``ConvGaussPolicy``) and twin conv
critics (``ConvQ``) on field observations, its replay seeded with the
behavior data and filled online from the env, exploring with noise from an
explicit ``torch.Generator``. Every method is then scored closed loop by
the smoke J metrics (J_target = -final target-bucket smoke-out, J_energy),
from fresh start boxes or the dataset's test-split initial densities
(``--eval_from_dataset``). The row appended to ``--save_file`` is the JAX
app's, plus ``updates`` and ``update_s`` (the update loops' seconds,
synchronised).

Examples:
  python -m diffphycon_tpu_torch.apps.train_baselines_smoke --method bc --n_episodes 8
  python -m diffphycon_tpu_torch.apps.train_baselines_smoke --method sac --sac_steps 500
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_parser():
    p = argparse.ArgumentParser(description="BC / BPPO / SAC smoke baselines (PyTorch/CUDA)")
    p.add_argument("--method", default="bc", choices=["bc", "bppo", "sac"])
    p.add_argument("--n_episodes", default=8, type=int,
                   help="behavior episodes for the offline buffer")
    p.add_argument("--behavior_from_dataset", default=None, type=str,
                   help="a generated smoke dataset whose train trajectories make the "
                        "offline buffer, instead of heuristic env episodes")
    p.add_argument("--n_test", default=4, type=int)
    p.add_argument("--frames", default=32, type=int)
    p.add_argument("--sub_steps", default=8, type=int)
    p.add_argument("--bc_steps", default=1000, type=int)
    p.add_argument("--critic_steps", default=500, type=int)
    p.add_argument("--bppo_steps", default=100, type=int)
    p.add_argument("--sac_steps", default=500, type=int)
    p.add_argument("--sac_episodes_per_round", default=2, type=int)
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--hidden_dim", default=512, type=int)
    p.add_argument("--depth", default=2, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--act_scale", default=2.0, type=float)
    p.add_argument("--w_energy", default=0.0, type=float)
    p.add_argument("--partially_observed", default=False, type=eval,
                   help="the policy sees the density and time channels only")
    p.add_argument("--eval_from_dataset", default=None, type=str,
                   help="score closed loop from this dataset's test-split initial "
                        "densities instead of fresh random start boxes")
    p.add_argument("--save_file", default="smoke_results/baselines.json")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (as --device cpu)")
    p.add_argument("--device", default=None, type=str,
                   help="default cuda; pass cpu explicitly to run on the CPU")
    return p


def behavior_action(env, rng, t):
    """The heuristic behavior policy of the offline data: a noisy upward
    push, (1, 64, 64, 2) in [-1, 1] (numpy)."""
    import numpy as np

    a = np.zeros((1, 64, 64, 2), np.float32)
    a[..., 1] = 0.4  # upward
    a += 0.2 * rng.normal(size=a.shape).astype(np.float32)
    return np.clip(a, -1, 1)


def mask_obs(obs, partially_observed):
    """Zero the velocity channels of a (B, 64, 64, 4) observation under
    partial observation."""
    import torch

    if not partially_observed:
        return obs
    return obs * torch.tensor([1.0, 0.0, 0.0, 1.0], device=obs.device)


def run_episode(env, select, batch, rng, partially_observed, density0=None):
    """One episode of ``select`` (masked obs -> action); returns the (obs,
    action, reward) transitions and the env's metrics."""
    obs = env.reset(batch, rng, density0=density0)
    done = False
    transitions = []
    while not done:
        o = mask_obs(obs, partially_observed)
        a = select(o)
        obs2, r, done = env.step(a)
        transitions.append((o, a, r))
        obs = obs2
    return transitions, env.metrics()


def behavior_data(args, env, rng):
    """(states (N, T+1, 64, 64, 4), actions (N, T, 64, 64, 2), rewards (N,
    T)) in numpy: the dataset's trajectories, or heuristic env episodes
    (their last state repeats the last observed one, as in the JAX app)."""
    import numpy as np

    if args.behavior_from_dataset:
        from diffphycon_tpu_torch.training.data import load_smoke_dataset

        traj = load_smoke_dataset(args.behavior_from_dataset, "train", n=args.n_episodes,
                                  rescale=False, frames=args.frames + 1)
        traj = traj[:, : args.frames + 1]  # (N, T+1, 64, 64, 6)
        tt = np.arange(traj.shape[1], dtype=np.float32) / args.frames
        tt = np.broadcast_to(tt[None, :, None, None], traj.shape[:4]).astype(np.float32)
        states = np.concatenate([traj[..., 0:3], tt[..., None]], axis=-1)
        actions = np.clip(traj[:, :-1, :, :, 3:5] / args.act_scale, -1, 1)
        rate = traj[:, :, 0, 0, 5]  # the smoke-portion channel (spatially constant)
        energy = (actions ** 2).mean(axis=(2, 3, 4))
        rewards = (np.diff(rate, axis=1) - args.w_energy * energy).astype(np.float32)
        states = states.astype(np.float32)
        if args.partially_observed:
            states = states * np.asarray([1.0, 0.0, 0.0, 1.0], np.float32)
        return states, actions.astype(np.float32), rewards
    states, actions, rewards = [], [], []
    for _ in range(args.n_episodes):
        trans, _ = run_episode(env, lambda o: behavior_action(env, rng, 0), 1, rng,
                               args.partially_observed)
        obs = [tr[0][0].cpu().numpy() for tr in trans]
        states.append(np.stack(obs + obs[-1:]))
        actions.append(np.stack([tr[1][0] for tr in trans]))
        rewards.append(np.stack([float(tr[2][0]) for tr in trans]))
    return np.stack(states), np.stack(actions), np.stack(rewards).astype(np.float32)


def main(args):
    """Train the method, evaluate it closed loop; returns the row."""
    import numpy as np
    import torch

    from diffphycon_tpu_torch.baselines.envs import SmokeRLEnv
    from diffphycon_tpu_torch.baselines.rl import (
        BPPO,
        SAC,
        BehaviorCloning,
        ConvGaussPolicy,
        ConvQ,
        QSarsaLearner,
        ReplayBuffer,
        RingReplay,
        ValueLearner,
    )
    from diffphycon_tpu_torch.device import resolve_device

    device = resolve_device("cpu" if args.cpu else args.device)
    rng = np.random.default_rng(args.seed)
    env = SmokeRLEnv(frames=args.frames, sub_steps=args.sub_steps, act_scale=args.act_scale,
                     w_energy=args.w_energy, device=device)
    obs_hw, act_hw = env.obs_shape, env.action_shape
    flat_obs, flat_act = int(np.prod(obs_hw)), int(np.prod(act_hw))

    t0 = time.time()
    states, actions, rewards = behavior_data(args, env, rng)
    print(f"behavior data: {states.shape} in {time.time() - t0:.1f}s", flush=True)

    results = {"method": args.method, "partially_observed": bool(args.partially_observed)}
    update_s = 0.0
    if args.method in ("bc", "bppo"):
        # flat MLP policies on the flattened fields
        def flat(a):
            return a.reshape(a.shape[0], a.shape[1], -1)

        buf = ReplayBuffer.from_trajectories(flat(states), flat(actions), rewards)
        bc = BehaviorCloning(flat_obs, flat_act, args.hidden_dim, args.depth, args.lr,
                             batch_size=args.batch_size, seed=args.seed, device=device)
        tic = time.perf_counter()
        loss = float("nan")  # stays NaN when --bc_steps 0
        for _ in range(args.bc_steps):
            loss = bc.update(buf)
        results["bc_loss"] = loss
        learner, updates = bc, args.bc_steps
        if args.method == "bppo":
            v = ValueLearner(flat_obs, args.hidden_dim, args.depth, args.lr,
                             batch_size=args.batch_size, seed=args.seed, device=device)
            q = QSarsaLearner(flat_obs, flat_act, args.hidden_dim, args.depth, args.lr,
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

        def select(o):
            return learner.select_action(o.reshape(o.shape[0], -1)).reshape(
                o.shape[0], *act_hw)
    else:
        # SAC: conv policy and twin conv critics on the field observations,
        # the replay seeded with the behavior data and filled online
        sac = SAC(flat_obs, flat_act, seed=args.seed, batch_size=args.batch_size,
                  policy=ConvGaussPolicy(in_channels=obs_hw[-1], action_channels=act_hw[-1]),
                  q_module=lambda: ConvQ(in_channels=obs_hw[-1] + act_hw[-1]),
                  action_shape=act_hw, device=device)
        replay = RingReplay(20_000, obs_hw, act_hw)
        mask = np.concatenate([np.ones(rewards.shape[1] - 1), [0.0]]).astype(np.float32)
        for ep in range(states.shape[0]):
            replay.push_batch(states[ep, :-1], actions[ep], rewards[ep], states[ep, 1:], mask)
        explore = torch.Generator(device=device).manual_seed(args.seed + 17)
        ql = pl = float("nan")
        rounds = updates = 0
        while rounds * args.sac_episodes_per_round * args.frames < args.sac_steps:
            for _ in range(args.sac_episodes_per_round):
                obs = env.reset(1, rng)
                done = False
                while not done:
                    o = mask_obs(obs, args.partially_observed)
                    noise = torch.randn(o.shape[:-1] + (act_hw[-1],), generator=explore,
                                        device=device)
                    a = sac.select_action(o, noise=noise)
                    obs2, r, done = env.step(a)
                    o2 = mask_obs(obs2, args.partially_observed)
                    replay.push_batch(o.cpu().numpy(), a.cpu().numpy(), r.cpu().numpy(),
                                      o2.cpu().numpy(), [0.0 if done else 1.0])
                    obs = obs2
            tic = time.perf_counter()
            for _ in range(args.frames * args.sac_episodes_per_round):
                ql, pl = sac.update(replay)
            update_s += time.perf_counter() - tic
            updates += args.frames * args.sac_episodes_per_round
            rounds += 1
        results["sac_q_loss"], results["sac_pi_loss"] = ql, pl
        select = sac.select_action
    results["updates"], results["update_s"] = updates, update_s

    # closed-loop evaluation: the dataset's test-split initial densities
    # (the episodes the diffusion evaluation scores), else fresh start boxes
    t0 = time.time()
    density0 = None
    if args.eval_from_dataset:
        from diffphycon_tpu_torch.training.data import load_smoke_dataset

        test = load_smoke_dataset(args.eval_from_dataset, "test", n=args.n_test)
        density0 = np.repeat(np.repeat(test[:, 0, :, :, 0], 2, -2), 2, -1)
    _, metrics = run_episode(env, select, args.n_test, rng, args.partially_observed,
                             density0=density0)
    metrics["eval_walltime_s"] = round(time.time() - t0, 2)
    results.update(metrics)
    print(f"{args.method}: J_target={metrics['J_target']:.4f} "
          f"smoke_out={metrics['smoke_out']:.4f} J_energy={metrics['J_energy']:.2f}",
          flush=True)
    os.makedirs(os.path.dirname(args.save_file) or ".", exist_ok=True)
    with open(args.save_file, "a") as fh:
        fh.write(json.dumps(results) + "\n")
    return results


if __name__ == "__main__":
    main(build_parser().parse_args())
