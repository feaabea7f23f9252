#!/usr/bin/env python
"""Train the 1D Burgers latent surrogate operator (NetF / NetU / NetTrans)
on the GPU.

Port of ``apps/train_burgers_operator.py`` (reference
burgers_operator.py:255-358, one-step branch), plus ``--device`` (default
cuda). Per (u_t, f_t, u_{t+1}) triple of ``synthetic_burgers`` data, fields
scaled by RESCALER:

    loss = rel(f_rec, f) + 0.5 rel(u_rec, u_t) + 2.5 rel(decode(trans), u_{t+1})
         + rel(trans, enc_u(u_{t+1})),   rel = per-sample relative L2, batch mean

with the global-norm clip, then AdamW (weight decay 1e-4, applied as optax's
adamw applies it) under optax's cosine decay over ``--num_steps``.
``--s_ob 64`` trains on the front/rear quarters of u. The weights are a
torch file ``<results_folder>/params_sob<s_ob>.pt`` (the JAX app writes an
orbax directory), which ``--init_from`` and ``apps/eval_pid_sl_burgers.py``
read.

Example:
  python -m diffphycon_tpu_torch.apps.train_burgers_operator --synthetic_data 4096 \\
      --num_steps 5000
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time


def build_parser():
    p = argparse.ArgumentParser(description="Train the Burgers latent operator (PyTorch/CUDA)")
    p.add_argument("--synthetic_data", default=4096, type=int)
    p.add_argument("--data_root", default="data", type=str)
    p.add_argument("--num_steps", default=5000, type=int)
    p.add_argument("--batch_size", default=256, type=int)
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--weight_decay", default=1e-4, type=float)
    p.add_argument("--grad_clip", default=1.0, type=float)
    p.add_argument("--s_ob", default=128, type=int,
                   help="observed resolution (64 = front/rear quarter PO)")
    p.add_argument("--results_folder", default="trained_models/burgers_operator", type=str)
    p.add_argument("--init_from", default=None, type=str,
                   help="warm-start from a params_sob*.pt file of this app")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default=None, type=str,
                   help="default cuda; pass cpu explicitly to run on the CPU")
    return p


def rel(a, b):
    """Per-sample relative L2 |a - b| / (|b| + 1e-8)."""
    num = (a - b).flatten(1).norm(dim=1)
    return num / (b.flatten(1).norm(dim=1) + 1e-8)


def operator_loss(op, ut, ft, un):
    """The four-term loss on scaled fields ut (B, s_ob), ft (B, s), un
    (B, s_ob)."""
    from diffphycon_tpu_torch.nets.burgers_operator import transition

    u_in, f_in, un_in = ut[:, None], ft[:, None], un[:, None]
    f_rec, u_rec, trans = transition(op.net_f, op.net_u, op.net_trans, u_in, f_in)
    u_next = op.net_u.decode(trans)
    un_lat = op.net_u.encode(un_in)
    return (rel(f_rec, f_in).mean() + 0.5 * rel(u_rec, u_in).mean()
            + 2.5 * rel(u_next, un_in).mean() + rel(trans, un_lat).mean())


def cosine_decay(lr: float, num_steps: int):
    """optax.cosine_decay_schedule(lr, num_steps): update i (from 0) gets
    lr * (1 + cos(pi * min(i, N) / N)) / 2."""
    return lambda i: lr * 0.5 * (1.0 + math.cos(math.pi * min(i, num_steps) / num_steps))


def make_train_step(op, lr: float, num_steps: int, weight_decay: float, grad_clip: float):
    """step(i, ut, ft, un) -> loss: the loss's gradient clipped to global
    norm ``grad_clip``, then one AdamW step (0.9, 0.999, eps 1e-8; torch's
    decoupled decay p * (1 - lr * wd) is optax adamw's lr * wd * p) at the
    schedule's lr for update i."""
    import torch

    from diffphycon_tpu_torch.training.train_state import clip_by_global_norm_, set_lr

    params = [p for p in op.parameters() if p.requires_grad]
    opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    sched = cosine_decay(lr, num_steps)

    def step(i, ut, ft, un):
        set_lr(opt, sched(i))
        opt.zero_grad(set_to_none=True)
        loss = operator_loss(op, ut, ft, un)
        loss.backward()
        clip_by_global_norm_([p.grad for p in params], grad_clip)
        opt.step()
        return loss.detach()

    return step


def main(args):
    """Train, save and check; returns {"checkpoint", "losses" (every
    step), "train_s" (the step loop, synchronised), "final_one_step_rel_l2"}."""
    import numpy as np
    import torch

    from diffphycon_tpu_torch.device import resolve_device
    from diffphycon_tpu_torch.nets.burgers_operator import RESCALER, SurrogateOperator
    from diffphycon_tpu_torch.training.data import synthetic_burgers

    device = resolve_device(args.device)
    u, f = synthetic_burgers(args.synthetic_data, seed=0,
                             cache_dir=os.path.join(args.data_root, "synthetic"), device=device)
    u, f = u / RESCALER, f / RESCALER
    ut = u[:, :-1].reshape(-1, u.shape[-1])
    un = u[:, 1:].reshape(-1, u.shape[-1])
    ft = f.reshape(-1, f.shape[-1])
    if args.s_ob == 64:
        # front/rear-quarter observation (reference s_ob=64 branch)
        sl = np.r_[0:32, 96:128]
        ut, un = ut[:, sl], un[:, sl]
    print(f"triples: {ut.shape[0]}", flush=True)

    op = SurrogateOperator(s=128, s_ob=args.s_ob, seed=args.seed, device=device)
    if args.init_from:
        op.load_state_dict(torch.load(args.init_from, map_location=device, weights_only=True))
        print(f"warm-started from {args.init_from}", flush=True)
    op.train()
    step = make_train_step(op, args.lr, args.num_steps, args.weight_decay, args.grad_clip)
    ut_d, ft_d, un_d = (torch.as_tensor(a, device=device) for a in (ut, ft, un))

    rng = np.random.default_rng(args.seed)
    n = ut.shape[0]
    os.makedirs(args.results_folder, exist_ok=True)
    losses = []
    with open(os.path.join(args.results_folder, "train_log.jsonl"), "a") as log:
        t0 = time.perf_counter()
        for i in range(args.num_steps):
            idx = torch.as_tensor(rng.integers(0, n, args.batch_size), device=device)
            losses.append(step(i, ut_d[idx], ft_d[idx], un_d[idx]))
            if (i + 1) % 100 == 0:
                log.write(json.dumps({"step": i + 1, "loss": float(losses[-1]),
                                      "wall_s": round(time.perf_counter() - t0, 2)}) + "\n")
                log.flush()
                print(f"step {i + 1} loss {float(losses[-1]):.5f}", flush=True)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        train_s = time.perf_counter() - t0

        op.eval()
        path = os.path.join(args.results_folder, f"params_sob{args.s_ob}.pt")
        torch.save(op.state_dict(), path)
        # one-step relative L2 on training triples, at the solver's scale
        m = min(256, n)
        with torch.no_grad():
            pred = op.simulate(ut_d[:m] * RESCALER, ft_d[:m] * RESCALER) / RESCALER
            rel_err = float((pred - un_d[:m]).norm() / (un_d[:m].norm() + 1e-8))
        print(f"one-step relative L2 on {m} train triples: {rel_err:.4f}", flush=True)
        log.write(json.dumps({"final_one_step_rel_l2": rel_err}) + "\n")
    return {"checkpoint": path, "losses": [float(v) for v in losses], "train_s": train_s,
            "final_one_step_rel_l2": rel_err}


if __name__ == "__main__":
    main(build_parser().parse_args())
