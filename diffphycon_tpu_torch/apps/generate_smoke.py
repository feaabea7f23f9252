#!/usr/bin/env python
"""Generate the 2D smoke dataset on the GPU.

Port of ``apps/generate_smoke.py``: sample a waypoint path from a random
start box through three horizontal target lines to the top exit, turn it
into per-segment control velocities, simulate 256 steps of the 128^2
obstacle scenario with the reference generator's control semantics
(``physics/fluids/smoke_env.py: generator_rollout``, one K4 pressure solve
per step), keep a scene only if more than ``--filter_rate`` of its smoke
leaves through the target bucket and its total mass stays in the
``--min_sum_rate``/``--max_sum_rate`` band, and write per-sim
Density/Velocity/Control/Smoke .npy files in the reference layout
(H, W, C, T), downsampled to 64^2 x 33 frames, plus ``gen_stats.json``.

The waypoints and segment velocities come from numpy (``--seed``); the
per-cell control noise from a ``torch.Generator`` on the device, seeded per
batch as the JAX app seeds its keys (the draws themselves differ).

Example:
  python -m diffphycon_tpu_torch.apps.generate_smoke --n_train 512 --n_test 16 \\
      --out data/smoke
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def closest_multiple(num, scale):
    lower = (num // scale) * scale
    upper = lower + scale
    return lower if abs(num - lower) < abs(num - upper) else upper


def sample_waypoints(rng):
    """Start (x, y), three targets and the exit: (xs, ys) of 5 points."""
    m = 4
    start_x = closest_multiple(int(rng.integers(16 + 2 + m, 112 - 10 - m)), 2)
    start_y = closest_multiple(int(rng.integers(16 + 2 + m, 40 - 10 - m)), 2)
    a = 0 if start_x < 64 - 8 else 1
    t1_x = int(rng.integers(16 + m, 64 - 8)) if a == 0 else int(rng.integers(64, 112 - 8 - m))
    t2_x = int(rng.integers(16 + m, 64 - 8)) if a == 0 else int(rng.integers(64, 112 - 8 - m))
    t3_x = int(rng.integers(50, 80 - 1 - 8))
    end_x = int(rng.integers(64 - 8, 64 + 8 - 8))
    return [start_x, t1_x, t2_x, t3_x, end_x], [start_y, 40, 50, 64, 112]


def segment_schedule(rng, xs, ys, num_t=256, y_scale=8.0, min_scale=2.0,
                     max_scale=5.0, record_scale=8):
    """Per-segment (vx, vy) with N(v, |v|/4) jitter, and the frames of the
    fresh control draws (steps 0, i0-1, i0+i1-1, i0+i1+i2-1).

    Returns (seg_v (4, 2) float32, seg_starts (4,) int32)."""
    seg = [np.hypot(xs[i + 1] - xs[i], ys[i + 1] - ys[i]) for i in range(4)]
    dist = sum(seg)
    v = dist / num_t
    scale = rng.uniform(min_scale, max_scale)

    def real_vel(vel):
        return rng.normal(vel, abs(vel) / 4.0)

    seg_v = np.zeros((4, 2), np.float32)
    for i in range(4):
        seg_v[i, 0] = real_vel(scale * v * (xs[i + 1] - xs[i]) / seg[i])
        seg_v[i, 1] = real_vel(y_scale * v * (ys[i + 1] - ys[i]) / seg[i])
    iv = [closest_multiple(int(num_t * s / dist), record_scale) for s in seg[:3]]
    intervals = [iv[0] + 1, iv[1], iv[2]]
    seg_starts = np.array(
        [0, intervals[0] - 1, intervals[0] + intervals[1] - 1,
         intervals[0] + intervals[1] + intervals[2] - 1], np.int32)
    return seg_v, seg_starts


def build_parser():
    p = argparse.ArgumentParser(description="Smoke dataset generator (PyTorch/CUDA)")
    p.add_argument("--out", default="data/smoke", type=str)
    p.add_argument("--n_train", default=64, type=int)
    p.add_argument("--n_test", default=8, type=int)
    p.add_argument("--batch", default=8, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--initial_vy", default=0.8, type=float)
    p.add_argument("--y_scale", default=8.0, type=float)
    p.add_argument("--min_scale", default=2.0, type=float)
    p.add_argument("--max_scale", default=5.0, type=float)
    p.add_argument("--filter_rate", default=0.8, type=float,
                   help="reject scenes whose target-bucket share of the total "
                        "smoke is not above this")
    p.add_argument("--min_sum_rate", default=0.2, type=float)
    p.add_argument("--max_sum_rate", default=2.0, type=float)
    p.add_argument("--accuracy", default=1e-6, type=float)
    p.add_argument("--max_iterations", default=500, type=int)
    p.add_argument("--device", default=None, type=str,
                   help="default cuda; pass cpu explicitly to run on the CPU")
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    return p


def main(args):
    import torch

    from diffphycon_tpu_torch.device import resolve_device
    from diffphycon_tpu_torch.physics.fluids.smoke_env import SmokeSim, generator_rollout

    device = resolve_device("cpu" if args.cpu else args.device)
    sim = SmokeSim.create(accuracy=args.accuracy, max_iterations=args.max_iterations,
                          device=device)
    stats = {"attempted": 0, "accepted": 0, "rates": []}
    # the test split first: a run cut short must not leave the evaluator
    # without test sims (seeds are keyed by split, so the order does not
    # change what is written)
    for split, n_sims in [("test/control", args.n_test), ("train", args.n_train)]:
        if n_sims == 0:
            continue
        base = os.path.join(args.out, split)
        os.makedirs(base, exist_ok=True)
        rng = np.random.default_rng(args.seed + (0 if split == "train" else 1))
        bs = args.batch
        written = 0
        batch_i = 0
        # rejection sampling must end even if acceptance is ~0
        max_batches = max(1, (50 * n_sims + bs - 1) // bs)
        while written < n_sims:
            if batch_i >= max_batches:
                rates = stats["rates"]
                raise SystemExit(
                    f"generate_smoke: acceptance rate "
                    f"{stats['accepted'] / max(stats['attempted'], 1):.4f} after "
                    f"{stats['attempted']} attempts (cap {max_batches} batches); max "
                    f"target_rate seen {max(rates) if rates else 0:.3f} vs filter_rate "
                    f"{args.filter_rate}: recalibrate y_scale/filter_rate")
            dens0 = np.zeros((bs, 128, 128), np.float32)
            seg_v = np.zeros((bs, 4, 2), np.float32)
            seg_starts = np.zeros((bs, 4), np.int32)
            for j in range(bs):
                xs, ys = sample_waypoints(rng)
                dens0[j, ys[0] : ys[0] + 10, xs[0] : xs[0] + 10] = 1.0
                seg_v[j], seg_starts[j] = segment_schedule(
                    rng, xs, ys, y_scale=args.y_scale, min_scale=args.min_scale,
                    max_scale=args.max_scale)
            gen = torch.Generator(device=device).manual_seed(
                args.seed * 100003 + batch_i + (0 if split == "train" else 50021))
            batch_i += 1
            with torch.no_grad():
                out = generator_rollout(sim, torch.from_numpy(dens0).to(device),
                                        torch.from_numpy(seg_v), torch.from_numpy(seg_starts),
                                        initial_vy=args.initial_vy, num_steps=256,
                                        generator=gen)
            bucket = out["bucket_mass"].cpu().numpy()                     # (b, 257, 7)
            remain = out["zero_densitys"].sum((-1, -2)).cpu().numpy()     # (b, 257)
            total = bucket[:, -1].sum(-1) + remain[:, -1]
            target_rate = bucket[:, -1, 1] / np.maximum(total, 1e-9)
            mass_ok = (total > 100.0 * args.min_sum_rate) & (total < 100.0 * args.max_sum_rate)
            accept = (target_rate > args.filter_rate) & mass_ok
            stats["attempted"] += bs
            stats["rates"].extend(np.round(target_rate, 4).tolist())

            dens = out["densitys"][:, ::8, ::2, ::2].cpu().numpy()
            vel = out["velocitys"][:, ::8, ::2, ::2].cpu().numpy()
            # 256 applied controls recorded at 0, 8, ..., 248 (32 frames);
            # the 33rd frame is zeros, as in the reference
            ctrl = out["controls"][:, ::8, ::2, ::2].cpu().numpy()
            ctrl = np.concatenate([ctrl, np.zeros_like(ctrl[:, :1])], 1)
            bucket_rec, remain = bucket[:, ::8], remain[:, ::8]

            for j in range(bs):
                if not accept[j] or written >= n_sims:
                    continue
                sim_dir = os.path.join(base, f"sim_{written:06d}")
                os.makedirs(sim_dir, exist_ok=True)
                cc = np.ascontiguousarray
                np.save(os.path.join(sim_dir, "Density.npy"),
                        cc(np.transpose(dens[j][..., None], (1, 2, 3, 0))))
                np.save(os.path.join(sim_dir, "Velocity.npy"),
                        cc(np.transpose(vel[j], (1, 2, 3, 0))))
                np.save(os.path.join(sim_dir, "Control.npy"),
                        cc(np.transpose(ctrl[j], (1, 2, 3, 0))))
                np.save(os.path.join(sim_dir, "Smoke.npy"),
                        cc(np.concatenate([bucket_rec[j], remain[j][:, None]], -1)))
                written += 1
                stats["accepted"] += 1
            print(f"{split}: batch {batch_i}: rates {np.round(target_rate, 3).tolist()} -> "
                  f"{int(accept.sum())} accepted, {written}/{n_sims} written", flush=True)
    with open(os.path.join(args.out, "gen_stats.json"), "w") as fh:
        json.dump({**stats, "args": vars(args)}, fh)
    return stats


if __name__ == "__main__":
    main(build_parser().parse_args())
