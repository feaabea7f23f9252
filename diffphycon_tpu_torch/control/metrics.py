"""Control evaluation metrics (port of the Burgers part of
``diffphycon_tpu/control/metrics.py``, solver as oracle, and of
``jellyfish_objective``)."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from diffphycon_tpu_torch.physics.burgers import burgers_solve


def _observed_slice(a, partially_observed: Optional[str]):
    if partially_observed is None:
        return a
    if partially_observed == "front_rear_quarter":
        nx = a.shape[-1]
        return torch.cat([a[..., : nx // 4], a[..., (3 * nx) // 4 :]], dim=-1)
    raise NotImplementedError(partially_observed)


def mse_deviation(u1, u2, partially_observed=None, report_all: bool = False):
    """Per-sample MSE over (Nt, Nx); u1, u2: (B, Nt, Nx). With report_all,
    (mse, mae, nmse, nmae), normalised by the mean of (u2 + 1e-5)^2 and of
    |u2 + 1e-5| over the batch."""
    u1 = _observed_slice(u1, partially_observed)
    u2 = _observed_slice(u2, partially_observed)
    mse = ((u1 - u2) ** 2).mean(dim=(-1, -2))
    if not report_all:
        return mse
    mae = (u1 - u2).abs().mean(dim=(-1, -2))
    ep = 1e-5
    return mse, mae, mse / ((u2 + ep) ** 2).mean(), mae / (u2 + ep).abs().mean()


def _torch_median(a):
    """Lower of the two middle elements for even n (torch.median's rule)."""
    return torch.sort(a, dim=-1).values[..., (a.shape[-1] - 1) // 2]


def burgers_metric(u_target, f, partial_control: Optional[str] = "full",
                   report_all: bool = False, diffused_u=None, evaluate_u: bool = False,
                   partially_observed: Optional[str] = None,
                   solver: Optional[Callable] = None):
    """J_actual (final-state deviation of the re-simulated trajectory) and
    control energy. u_target: (B, Nt, Nx) unscaled; f: (B, Nt-1, Nx).
    solver: fn(u0 (B, Nx), f) -> (B, Nt, Nx) re-simulating the control
    (default the Burgers solver at visc 0.01, dt 1e-4), run without a
    gradient."""
    if partial_control == "front_rear_quarter":
        nx = f.shape[-1]
        f = f.clone()
        f[:, :, nx // 4 : (3 * nx) // 4] = 0.0

    if evaluate_u:
        u_controlled = diffused_u
    else:
        if solver is None:
            def solver(u0, ff):
                return burgers_solve(u0, ff, visc=0.01, T=1.0, dt=1e-4, num_t=ff.shape[1])
        with torch.no_grad():  # a score: no graph through the solver
            u_controlled = solver(u_target[:, 0, :], f)

    u_controlled = _observed_slice(u_controlled, partially_observed)
    u_tgt = _observed_slice(u_target, partially_observed)
    d = u_controlled[:, -1, :] - u_tgt[:, -1, :]
    mse = (d**2).mean(-1)
    control_energy = (f**2).sum(dim=(-1, -2))
    if not report_all:
        return mse, control_energy
    ep = 1e-5
    mae = d.abs().mean(-1)
    nmse = mse / ((u_tgt[:, -1, :] ** 2).mean() + ep)
    nmae = mae / (u_tgt[:, -1, :].abs().mean() + ep)
    return ((mse, _torch_median(d**2), mae, _torch_median(d.abs()), nmse, nmae),
            control_energy)


def jellyfish_objective(forces: torch.Tensor, dthetas: torch.Tensor,
                        reg_ratio: float = 0.0) -> torch.Tensor:
    """The jellyfish control objective, the one convention of the RL envs,
    MPC scoring and the diffusion evaluation:

        J = mean_t(force_t * weight_t) - reg_ratio * sum_t dtheta_t^2,
        weight = (T, T-1, ..., 1),

    forces: (B, T) thrust per frame; dthetas: (B, T') theta steps."""
    forces, dthetas = torch.as_tensor(forces), torch.as_tensor(dthetas)
    t = forces.shape[1]
    weight = torch.arange(t, 0, -1, dtype=forces.dtype, device=forces.device)[None]
    return (forces * weight).mean(dim=1) - reg_ratio * (dthetas ** 2).sum(dim=1)
