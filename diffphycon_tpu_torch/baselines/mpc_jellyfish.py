"""Gradient MPC baseline for jellyfish control.

Port of ``diffphycon_tpu/baselines/mpc_jellyfish.py`` (reference MPC
controller, inference/inference_2d_jellyfish.py:488-806): optimise the theta
schedule by Adam through the neural ``SurrogatePipeline`` (simulator, force
readout, boundary updater), maximising thrust minus the theta-smoothness
regulariser.

The JAX receding-horizon loop is one jitted program whose planning rollouts
run all num_t steps and mask the ones past the horizon; those steps add
exactly zero to the objective and to its gradient. Here each replanning
rollout runs only the live steps t .. num_t - 1, so the work shrinks with
the horizon.

``optimizer="lbfgs"`` replans with ``baselines.lbfgs``, the port of
optax's L-BFGS with its zoom line search that the JAX package runs.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from diffphycon_tpu_torch.baselines import lbfgs


def mpc_plan(ppl, state_0, bd_0, theta_0, horizon: int = 20, lr: float = 1e-2,
             iters: int = 50, reg_ratio: float = 0.0, seed: int = 0,
             noise: Optional[torch.Tensor] = None):
    """Plan a theta schedule of ``horizon`` steps by Adam (optax.adam's
    defaults) through the pipeline's rollout; theta at step 0 stays
    theta_0. The plan starts at theta_0 + 0.01 * noise ((B, horizon); drawn
    from a generator of ``seed`` when None). Returns (thetas (B, horizon),
    forces (B, horizon), J history)."""
    b = state_0.shape[0]
    if noise is None:
        noise = torch.randn(b, horizon, generator=torch.Generator().manual_seed(seed))
    thetas = (theta_0[:, None] + 0.01 * noise.to(theta_0.device)).detach()
    thetas[:, 0] = theta_0
    thetas.requires_grad_(True)
    weight = torch.arange(horizon, 0, -1, dtype=torch.float32, device=theta_0.device)[None]

    def fixed(th):
        return torch.cat([theta_0[:, None], th[:, 1:]], dim=1)

    def objective(th):
        th = fixed(th)
        _, forces = ppl.rollout(state_0, bd_0, th)
        avg_v = (forces * weight).mean(dim=1)
        reg = ((th[:, 1:] - th[:, :-1]) ** 2).sum(dim=1)
        return (-avg_v + reg_ratio * reg).sum()

    opt = torch.optim.Adam([thetas], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    history = []
    for _ in range(iters):
        opt.zero_grad(set_to_none=True)
        val = objective(thetas)
        val.backward()
        opt.step()
        history.append(float(val.detach()))
    with torch.no_grad():
        thetas = fixed(thetas)
        _, forces = ppl.rollout(state_0, bd_0, thetas)
    return thetas, forces, history


def plan_rollout(ppl, state, bd, theta_prev, plan, t: int):
    """The planned forces of steps t .. num_t - 1 (plan (B, num_t)),
    rolled from (state, bd, theta_prev); (B, num_t) with zeros before t."""
    num_t = plan.shape[1]
    forces = [torch.zeros_like(plan[:, :t])]
    th_prev = theta_prev
    for k in range(t, num_t):
        th_k = plan[:, k]
        delta = th_k - th_prev
        state, force = ppl.step(state, bd, delta)
        bd = ppl.bd_updater(bd, delta)
        forces.append(force[:, None])
        th_prev = th_k
    return torch.cat(forces, dim=1)


def mpc_objective(ppl, plan, state, bd, theta_prev, realized, t: int, theta0, lamda: float,
                  coef_endcondition: float, coef_clip: float, dtheta_clip: float):
    """-(J - lamda * sum dtheta^2 - coef_end |theta_T - theta_0| - coef_clip *
    clip) summed over the batch, J the mean over steps of the cumulative
    thrust: the realized forces before t and the planned ones after."""
    all_forces = realized + plan_rollout(ppl, state, bd, theta_prev, plan, t)
    j = torch.cumsum(all_forces, dim=1).mean(dim=1)
    dd = plan[:, 1:] - plan[:, :-1]
    reg = (dd ** 2).sum(dim=1)
    end = (plan[:, -1] - theta0).abs()
    d0 = plan[:, 0] - theta_prev
    clipv = (torch.relu(d0.abs() - dtheta_clip) ** 2
             + (torch.relu(dd.abs() - dtheta_clip) ** 2).sum(dim=1))
    return (-(j - lamda * reg - coef_endcondition * end - coef_clip * clipv)).sum()


def mpc_receding_horizon(ppl, state_0, bd_0, theta_0, frames: int = 20, num_iters: int = 30,
                         lr: float = 0.05, lamda: float = 1000.0,
                         coef_endcondition: float = 0.0, coef_clip: float = 0.0,
                         theta_clip=(0.2, 1.1), dtheta_clip: float = 0.15,
                         optimizer: str = "adam", seed: int = 0,
                         theta_plan0: Optional[torch.Tensor] = None):
    """Receding-horizon MPC through the surrogate pipeline: at every real
    step t replan the schedule (``num_iters`` iterations from a fresh
    optimizer state, the plan clipped to ``theta_clip`` after each update),
    execute its step t, and carry the plan on. ``optimizer``: "adam" (each
    update times the cosine factor 0.5 (1 + cos(pi i / num_iters))) or
    "lbfgs" (L-BFGS with learning rate ``lr`` and its zoom line search, no
    cosine factor; every line-search trial takes the objective and its
    gradient through the live steps). The first plan is ``theta_plan0``
    (B, frames - 1), drawn U[0.2, 0.9] from a generator of ``seed`` when
    None.

    Returns (thetas (B, frames), states (B, frames, H, W, ns), forces
    (B, frames))."""
    b = state_0.shape[0]
    num_t = frames - 1
    dev = theta_0.device
    if theta_plan0 is None:
        gen = torch.Generator().manual_seed(seed)
        theta_plan0 = 0.7 * torch.rand(b, num_t, generator=gen) + 0.2
    plan = theta_plan0.to(dev).clone()
    realized = torch.zeros(b, num_t, device=dev)
    state, bd, theta = state_0, bd_0, theta_0
    thetas, states, forces = [theta_0], [state_0], []
    scales = [0.5 * (1 + math.cos(math.pi * i / num_iters)) for i in range(num_iters)]
    for t in range(num_t):
        def objective(p):
            return mpc_objective(ppl, p, state, bd, theta, realized, t, theta_0, lamda,
                                 coef_endcondition, coef_clip, dtheta_clip)

        if optimizer == "lbfgs":
            plan = _replan_lbfgs(objective, plan.detach(), num_iters, lr, theta_clip)
        else:
            plan = _replan_adam(objective, plan.detach(), scales, lr, theta_clip)
        with torch.no_grad():
            th_next = plan[:, t].clone()  # the next replan updates plan in place
            delta = th_next - theta
            state, force = ppl.step(state, bd, delta)
            bd = ppl.bd_updater(bd, delta)
            realized[:, t] = force
        theta = th_next
        thetas.append(th_next)
        states.append(state)
        forces.append(force)
    with torch.no_grad():
        forces.append(ppl.step(state, bd))
    return torch.stack(thetas, 1), torch.stack(states, 1), torch.stack(forces, 1)


def _replan_adam(objective, plan, scales, lr, theta_clip):
    plan = plan.requires_grad_(True)
    opt = torch.optim.Adam([plan], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for scale in scales:
        # Adam's update is linear in its lr: lr * scale scales the update
        for group in opt.param_groups:
            group["lr"] = lr * scale
        opt.zero_grad(set_to_none=True)
        objective(plan).backward()
        opt.step()
        with torch.no_grad():
            plan.clamp_(theta_clip[0], theta_clip[1])
    return plan.detach()


def _replan_lbfgs(objective, plan, num_iters, lr, theta_clip):
    state = lbfgs.init(plan)
    for _ in range(num_iters):
        value, grad = lbfgs.value_and_grad(objective, plan)
        updates, state = lbfgs.update(grad, state, plan, value, objective, learning_rate=lr)
        plan = (plan + updates).clamp(theta_clip[0], theta_clip[1])
    return plan
