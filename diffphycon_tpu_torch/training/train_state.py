"""Train state: LR schedules, global-norm clipping, Adam and the EMA.

Port of ``diffphycon_tpu/training/train_state.py`` (the reference recipe:
Adam(0.9, 0.99) with torch-style CosineAnnealingLR, global gradient-norm
clip 1.0, and an EMA of the weights with ema_pytorch's warm-up, decay 0.995,
updated every 10 steps; MultiStepLR for smoke and jellyfish).

The learning rate is a pure function of the optimizer step, as an optax
schedule is, so resuming needs no scheduler state. Clipping uses optax's
formula ``g * max_norm / norm`` when ``norm > max_norm`` (not
``torch.nn.utils.clip_grad_norm_``, which divides by ``norm + 1e-6``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch


def torch_cosine_annealing(base_lr: float, t_max: int = 10000,
                           eta_min: float = 0.0) -> Callable[[int], float]:
    """CosineAnnealingLR in closed form, eta_min + (lr0 - eta_min) * (1 +
    cos(pi t / T_max)) / 2; it keeps following the cosine past T_max."""

    def schedule(step: int) -> float:
        return eta_min + (base_lr - eta_min) * 0.5 * (1.0 + math.cos(math.pi * step / t_max))

    return schedule


def multistep_lr(base_lr: float, milestones: Sequence[int],
                 gamma: float = 0.1) -> Callable[[int], float]:
    """MultiStepLR as optax's piecewise_constant_schedule: gamma applies from
    step m on (milestone 10: steps 9, 10, 11 get 1, gamma, gamma)."""
    bounds = sorted(int(m) for m in milestones)

    def schedule(step: int) -> float:
        return base_lr * gamma ** sum(step >= m for m in bounds)

    return schedule


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by max_norm / norm when the global norm
    exceeds max_norm (optax.clip_by_global_norm); returns the norm. No host
    sync: the choice is made on the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def make_optimizer(params, b1: float = 0.9, b2: float = 0.99) -> torch.optim.Adam:
    """Adam(b1, b2), eps 1e-8 (optax.adam's). Its learning rate is set from
    the schedule before every step (:func:`set_lr`)."""
    return torch.optim.Adam(params, lr=0.0, betas=(b1, b2), eps=1e-8)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


@dataclasses.dataclass(frozen=True)
class EMAConfig:
    """ema_pytorch-compatible EMA (reference EMA(beta=.995, update_every=10)):
    up to ``update_after_step`` an update copies the online weights; after
    it the decay warms up as min(beta, 1 - (1 + k / inv_gamma)^-power)."""

    beta: float = 0.995
    update_every: int = 10
    update_after_step: int = 100
    inv_gamma: float = 1.0
    power: float = 0.75


def ema_decay(cfg: EMAConfig, step: int):
    """Decay of the EMA update after optimizer step ``step`` (1-based), or
    None when that step does not update. The warm-up counts raw optimizer
    steps (ema_pytorch: epoch = step - update_after_step - 1)."""
    if step % cfg.update_every:
        return None
    k = max(step - cfg.update_after_step - 1, 0)
    warm = 1.0 - (1.0 + k / cfg.inv_gamma) ** (-cfg.power)
    return min(max(warm, 0.0), cfg.beta)


@torch.no_grad()
def ema_update_(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
                cfg: EMAConfig, step: int) -> None:
    """ema = d * ema + (1 - d) * params in place after optimizer step
    ``step`` (d = 0 copies)."""
    d = ema_decay(cfg, step)
    if d is None:
        return
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, list(params), alpha=1.0 - d)
