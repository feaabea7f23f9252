"""PID baseline for Burgers control.

Port of ``diffphycon_tpu/baselines/pid_burgers.py``: per-grid-point PID
gains make the forcing from the tracking error, f_t = Kp e_t + Ki sum e +
Kd (e_t - e_{t-1}), held over each frame's solver substeps; the gains are
tuned by Adam through the differentiable rollout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from diffphycon_tpu_torch.physics.burgers import _stencil_step


@dataclasses.dataclass
class PIDController:
    kp: torch.Tensor  # (Nx,)
    ki: torch.Tensor
    kd: torch.Tensor


def pid_rollout(ctrl: PIDController, u0, u_target_traj, dt: float = 1e-3, num_t: int = 10,
                visc: float = 0.01, control_mask: Optional[torch.Tensor] = None):
    """Roll the PID loop through the solver's step: at each of the num_t
    frames f = PID(error against the target at that frame), times the
    actuation mask inside the loop (so tuning sees the plant that scores
    it), held over the frame's substeps. Returns (traj (B, num_t + 1, Nx),
    f (B, num_t, Nx))."""
    nx = u0.shape[-1]
    record = int(round(1.0 / dt)) // num_t
    dx = 1.0 / (nx + 1)
    u, err_sum, err_prev = u0, torch.zeros_like(u0), torch.zeros_like(u0)
    us, fs = [u0], []
    for t in range(num_t):
        err = u_target_traj[:, t + 1] - u
        err_sum = err_sum + err
        f = ctrl.kp * err + ctrl.ki * err_sum + ctrl.kd * (err - err_prev)
        if control_mask is not None:
            f = f * control_mask
        for _ in range(record):
            u = _stencil_step(u, f, dt, dx, visc)
        err_prev = err
        us.append(u)
        fs.append(f)
    return torch.stack(us, dim=1), torch.stack(fs, dim=1)


def _initial_gains(nx: int, seed: int = 0, device="cpu") -> dict:
    """kp, ki, kd ~ 0.1 N(0, 1) from a torch generator (the JAX package
    draws its own from jax.random; tests feed those in)."""
    gen = torch.Generator().manual_seed(seed)
    return {k: (0.1 * torch.randn(nx, generator=gen)).to(device) for k in ("kp", "ki", "kd")}


def pid_control(u0, u_target_traj, lr: float = 1e-2, steps: int = 100, dt: float = 1e-3,
                seed: int = 0, lamb: float = 0.0, control_mask=None, gains=None):
    """Tune the gains by Adam (optax.adam's defaults) through the rollout,
    from ``gains`` ({"kp", "ki", "kd"} each (Nx,); :func:`_initial_gains`
    of ``seed`` when None). Returns (controller, f, traj, J history)."""
    if gains is None:
        gains = _initial_gains(u0.shape[-1], seed, u0.device)
    g = {k: torch.as_tensor(v, device=u0.device).clone().requires_grad_(True)
         for k, v in gains.items()}

    def objective():
        traj, f = pid_rollout(PIDController(g["kp"], g["ki"], g["kd"]), u0, u_target_traj,
                              dt=dt, control_mask=control_mask)
        dev = ((traj[:, -1] - u_target_traj[:, -1]) ** 2).mean()
        return dev + lamb * (f ** 2).sum(dim=(-1, -2)).mean()

    opt = torch.optim.Adam([g["kp"], g["ki"], g["kd"]], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    history = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        val = objective()
        val.backward()
        opt.step()
        history.append(float(val.detach()))
    ctrl = PIDController(*(g[k].detach() for k in ("kp", "ki", "kd")))
    with torch.no_grad():
        traj, f = pid_rollout(ctrl, u0, u_target_traj, dt=dt, control_mask=control_mask)
    return ctrl, f, traj, history
