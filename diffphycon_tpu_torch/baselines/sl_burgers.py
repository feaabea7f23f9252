"""SL (supervised / adjoint) baseline for Burgers control.

Port of ``diffphycon_tpu/baselines/sl_burgers.py``: Adam on the control f
through the differentiable solver (per-frame checkpointed), or through the
learned latent operator (the reference's formulation, for partial
observation):

  J(f) = mean (u(T; u0, f) - u_target(T))^2 + lamb * mean_b sum f^2
"""

from __future__ import annotations

import torch

from diffphycon_tpu_torch.physics.burgers import burgers_solve

NUM_T = 10


def control_mask(nx: int, partial_control, device) -> torch.Tensor:
    """(nx,) actuation mask: ones, or the front and rear quarters."""
    if partial_control == "front_rear_quarter":
        mask = torch.zeros(nx, device=device)
        mask[: nx // 4] = 1.0
        mask[3 * nx // 4 :] = 1.0
        return mask
    return torch.ones(nx, device=device)


def sl_optimize_control(u0, u_target_T, f_init=None, lamb: float = 0.0, lr: float = 1e-2,
                        steps: int = 100, solver_dt: float = 1e-4, partial_control=None,
                        surrogate=None):
    """Optimise f (B, 10, Nx) by Adam (optax.adam's defaults: b2 0.999, eps
    1e-8) on the gradient of J through the solver, on u0's device.

    surrogate: optional (SurrogateOperator, state_dict): optimise through
    the latent operator run on that state_dict (the operator's own weights
    when None) instead of the solver; the operator's weights get no
    gradient.

    Returns (f_opt * mask, J history as floats)."""
    b, nx = u0.shape
    f = (torch.zeros(b, NUM_T, nx, device=u0.device) if f_init is None
         else torch.as_tensor(f_init, device=u0.device).clone())
    f.requires_grad_(True)
    mask = control_mask(nx, partial_control, u0.device)
    if surrogate is not None:
        op, state = surrogate
        state = {k: v.detach() for k, v in (state or op.state_dict()).items()}

    def objective(f):
        fm = f * mask
        if surrogate is not None:
            traj = torch.func.functional_call(op, state, (u0, fm))
        else:
            traj = burgers_solve(u0, fm, visc=0.01, T=1.0, dt=solver_dt, num_t=NUM_T)
        dev = ((traj[:, -1] - u_target_T) ** 2).mean()
        return dev + lamb * (fm ** 2).sum(dim=(-1, -2)).mean()

    opt = torch.optim.Adam([f], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    history = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        val = objective(f)
        val.backward()
        opt.step()
        history.append(float(val.detach()))
    return (f * mask).detach(), history
