"""Plain reference of the smoke joint model's training step.

``p_losses`` (pred_noise, the frame-0 density pinned and its noise target
zeroed) on t and noise drawn from a ``torch.Generator`` in the order the
port's trainer draws them, the global-norm clip, and Adam (bias-corrected,
eps outside the root) over the UNet3D reference's parameter dict, in
float32.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import diffusion as rdiff
from portbench.reference import unet3d as ref
from portbench.weights import make_params, sub_seed


class ReferenceTrainer:
    """The joint model's training step in plain torch: p_losses (pred_noise)
    on t and noise drawn from a generator as the port's trainer draws them,
    the global-norm clip, Adam (bias-corrected, eps outside the root).
    ``rnd`` rounds the forward's operands (straight through in the backward);
    the batch runs in ``chunks`` blocks of rows whose gradients add up."""

    def __init__(self, cfg, seed, device, rnd=None, chunks: int = 1):
        self.cfg, self.dev, self.chunks = cfg, device, chunks
        self.rnd = None if rnd is None else (lambda t: t + (rnd(t) - t).detach())
        self.shapes = ref.param_shapes(cfg, cfg["channels"])
        self.P = {n: v.clone().requires_grad_(True)
                  for n, v in make_params(self.shapes, seed, 1, device).items()}
        self.m = {n: torch.zeros_like(v) for n, v in self.P.items()}
        self.v = {n: torch.zeros_like(v) for n, v in self.P.items()}
        self.gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 5))
        self.consts = rdiff.Constants(cfg["beta_schedule"], cfg["timesteps"])
        self.step_no = 0
        self.grads = None

    def step(self, batch):
        tc = self.cfg["train"]
        b = batch.shape[0]
        t = torch.randint(0, self.cfg["timesteps"], (b,), generator=self.gen, device=self.dev)
        noise = torch.randn(batch.shape, generator=self.gen, device=self.dev)
        P, cfg, rnd = self.P, self.cfg, self.rnd

        def net(x, tt):
            return ref.forward(P, x, tt, cfg, rnd)

        total = 0.0
        for sl in torch.arange(b, device="cpu").chunk(self.chunks):
            sl = slice(int(sl[0]), int(sl[-1]) + 1)
            loss = rdiff.smoke_loss_per_sample(self.consts, batch[sl], t[sl], noise[sl],
                                               net).sum() / b
            loss.backward()
            total += float(loss.detach())
        with torch.no_grad():
            grads = {n: p.grad for n, p in self.P.items()}
            norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
            if norm > tc["max_grad_norm"]:
                for g in grads.values():
                    g.mul_(tc["max_grad_norm"] / norm)
            self.grads = {n: g.clone() for n, g in grads.items()}
            self.step_no += 1
            b1, b2, eps, lr = tc["adam_b1"], tc["adam_b2"], 1e-8, tc["lr"]
            c1, c2 = 1 - b1 ** self.step_no, 1 - b2 ** self.step_no
            for n, p in self.P.items():
                g = grads[n]
                self.m[n].mul_(b1).add_(g, alpha=1 - b1)
                self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                p.sub_(lr * (self.m[n] / c1) / ((self.v[n] / c2).sqrt() + eps))
                p.grad = None
        return total
