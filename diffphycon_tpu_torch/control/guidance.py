"""Guidance objectives for controlled sampling (port of
``diffphycon_tpu/control/guidance.py``).

The guidance gradient is ``torch.autograd.grad`` of the summed control
objective with respect to the predicted clean sample x_start; it never
differentiates through a network.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from diffphycon_tpu_torch.utils.profiling import span


def make_nabla_j(loss_fn: Callable) -> Callable:
    """nabla_J(x) = d loss_fn(x).sum() / dx."""

    def nabla_j(x):
        with span("sampler.guidance"), torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(loss_fn(xx).sum(), xx)
        return g

    return nabla_j


def mse_dist_reg(u):
    """Temporal smoothness sum_t ||u_{t+1} - u_t||^2; u: (B, Nt, Nx)."""
    return ((u[:, 1:, :] - u[:, :-1, :]) ** 2).sum()


def ddpm_guidance_loss(u_target, u, f, wu: float = 0.0, wf: float = 0.0,
                       wreg: float = 0.0, dist_reg: Callable = lambda u: 0.0,
                       partially_observed: Optional[str] = None):
    """wu * sum_endpoints (u - u*)^2 / (B * Nx) + wf * mean_b sum f^2
    + wreg * dist_reg(u); u_target, u: (B, Nt, Nx), f: (B, Nt-1, Nx)."""
    nt, nx = u.shape[1], u.shape[2]
    tmask = torch.zeros(nt, dtype=u.dtype, device=u.device)
    tmask[0] = 1.0
    tmask[nt - 1] = 1.0
    diff2 = (u - u_target) ** 2 * tmask[None, :, None]
    if partially_observed == "front_rear_quarter":
        mask = torch.ones(nx, dtype=u.dtype, device=u.device)
        mask[nx // 4 : (3 * nx) // 4] = 0.0
        diff2 = diff2 * mask
    elif partially_observed is not None:
        raise ValueError(f"unknown partially observed mode {partially_observed!r}")
    loss_u = diff2.sum() / (u.shape[0] * nx)
    loss_f = (f**2).sum(dim=(-1, -2)).mean()
    return loss_u * wu + loss_f * wf + dist_reg(u) * wreg


def burgers_guidance_from_x(u_target, wu: float = 0.0, wf: float = 0.0,
                            wreg: float = 0.0, use_dist_reg: bool = False,
                            partially_observed: Optional[str] = None,
                            nt_u: int = 11, nt_f: int = 10) -> Callable:
    """loss_fn(x) over the stacked channels-last sample x (B, 16, 128, 2)."""
    reg = mse_dist_reg if use_dist_reg else (lambda u: 0.0)

    def loss_fn(x):
        return ddpm_guidance_loss(u_target, x[:, :nt_u, :, 0], x[:, :nt_f, :, 1],
                                  wu=wu, wf=wf, wreg=wreg, dist_reg=reg,
                                  partially_observed=partially_observed)

    return loss_fn
