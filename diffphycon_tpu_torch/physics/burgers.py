"""1D viscous Burgers equation: explicit finite-difference integrator.

Port of ``diffphycon_tpu/physics/burgers.py``: the paired and the
cross-product solve, differentiable with respect to u0 and f.

Scheme: ``s`` interior points on (0, 1), dx = 1/(s+1), zero Dirichlet walls
(a zero pad every step); explicit Euler
``u <- u + dt * (-1/2 * D1(u^2) + visc * D2(u) + f)`` with central D1/D2.
Forcing frame k applies for steps [k*record, (k+1)*record), record =
steps // num_t, steps = ceil(T/dt); remainder steps past num_t*record reuse
the last frame. u is recorded at the end of each frame and u0 is stacked in
front: output (N, num_t + 1, s).

On a GPU the 10^4 dependent steps are a loop of small elementwise launches;
a fused kernel or a CUDA graph is later work. The gradient runs the same loop
backwards, one launch per op per step.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint


def _stencil_step(u, f_frame, dt, dx, visc):
    """One explicit Euler step on the interior points (zero Dirichlet walls)."""
    up = F.pad(u, (1, 1))
    u2 = up * up
    transport = (u2[:, 2:] - u2[:, :-2]) / (2.0 * dx)
    diffusion = (up[:, :-2] - 2.0 * up[:, 1:-1] + up[:, 2:]) * (visc / dx**2)
    return u + dt * (-0.5 * transport + diffusion + f_frame)


def burgers_solve(u0: torch.Tensor, f: torch.Tensor, visc: float = 0.01,
                  T: float = 1.0, dt: float = 1e-4, num_t: int = 10,
                  checkpoint: bool = True) -> torch.Tensor:
    """Paired trajectories: sample i uses u0[i] (N, s) and f[i] (N, num_t, s).

    Returns (N, num_t + 1, s) float32, u0 first, on u0's device.

    Differentiable in u0 and f. With ``checkpoint`` each forcing frame's
    steps run inside one non-reentrant ``torch.utils.checkpoint`` (JAX's
    ``jax.checkpoint(chunk)``), so a backward through 10^4 steps holds one
    frame's activations at a time. When autograd records nothing (no input
    requires grad, or grad mode is off) the frames run as a plain loop."""
    steps = math.ceil(T / dt)
    record = steps // num_t
    remainder = steps - record * num_t
    s = u0.shape[-1]
    dx = 1.0 / (s + 1)
    u = u0.to(torch.float32)
    f = f.to(torch.float32)
    remat = checkpoint and torch.is_grad_enabled() and (u.requires_grad or f.requires_grad)

    def frame(u, f_k):
        for _ in range(record):
            u = _stencil_step(u, f_k, dt, dx, visc)
        return u

    snaps = [u]
    for k in range(num_t):
        f_k = f[:, k, :]
        u = _checkpoint(frame, u, f_k, use_reentrant=False) if remat else frame(u, f_k)
        snaps.append(u)
    if remainder:
        for _ in range(remainder):
            u = _stencil_step(u, f[:, -1, :], dt, dx, visc)
        snaps[-1] = u
    return torch.stack(snaps, dim=1)


def burgers_solve_paired(u0: torch.Tensor, f: torch.Tensor, visc: float = 0.01,
                         T: float = 1.0, dt: float = 1e-4, num_t: int = 10) -> torch.Tensor:
    """Cross product: every u0 (Nu0, s) against every f (Nf, num_t, s), as
    one batched solve over the Nu0 * Nf pairs. Returns (Nu0, Nf, num_t + 1,
    s)."""
    nu, nf = u0.shape[0], f.shape[0]
    traj = burgers_solve(u0.repeat_interleave(nf, dim=0), f.repeat(nu, 1, 1), visc=visc,
                         T=T, dt=dt, num_t=num_t)
    return traj.reshape(nu, nf, *traj.shape[1:])


# ---------------------------------------------------------------------------
# Data generation (reference make_data_varying_f), numpy only
# ---------------------------------------------------------------------------


def _gaussian_bumps_u0(rng: np.random.Generator, n: int, x: np.ndarray):
    loc1 = rng.uniform(0.2, 0.4, (n, 1))
    amp1 = rng.uniform(0, 2, (n, 1))
    sig1 = rng.uniform(0.05, 0.15, (n, 1))
    g1 = amp1 * np.exp(-0.5 * (x[None, :] - loc1) ** 2 / sig1**2)
    loc2 = rng.uniform(0.6, 0.8, (n, 1))
    amp2 = rng.uniform(-2, 0, (n, 1))
    sig2 = rng.uniform(0.05, 0.15, (n, 1))
    g2 = amp2 * np.exp(-0.5 * (x[None, :] - loc2) ** 2 / sig2**2)
    return g1 + g2


def make_burgers_data(n: int, s: int = 128, t: int = 10, seed: int = 0,
                      partial_control: str | None = None,
                      amp_compensate: float = 2.0, alpha: float = 1.0):
    """Random two-bump u0 (n, s) and 8-bump space-time forcing f (n, t, s),
    float32 numpy; the same draws as the JAX package for the same seed."""
    rng = np.random.default_rng(seed)
    dx = 1.0 / (s + 1)
    x = np.linspace(dx, 1.0 - dx, s)
    dt_ = 1.0 / (t + 1)
    ts = np.linspace(dt_, 1.0 - dt_, t)

    u0 = _gaussian_bumps_u0(rng, n, x)

    if partial_control is None:
        space_mask = np.ones((1, 1, s))
    elif partial_control == "front_rear_quarter":
        space_mask = np.zeros((1, 1, s))
        space_mask[:, :, : s // 4] = 1.0
        space_mask[:, :, 3 * s // 4 :] = 1.0
        amp_compensate = amp_compensate * 2
    else:
        raise ValueError(f"invalid partial control mode: {partial_control!r}")

    def rand_f(rand_amp: bool):
        if rand_amp:
            amp = rng.integers(0, 2, (n, 1, 1)) * rng.uniform(-1.5, 1.5, (n, 1, 1))
        else:
            amp = rng.uniform(-1.5, 1.5, (n, 1, 1))
        loc_x = rng.uniform(0, 1, (n, 1, 1))
        sig_x = rng.uniform(0.1, 0.4, (n, 1, 1)) * 0.5
        exp_space = np.exp(-0.5 * (x[None, None, :] - loc_x) ** 2 / sig_x**2)
        exp_space = exp_space * space_mask
        loc_t = rng.uniform(0, 1, (n, 1, 1))
        sig_t = rng.uniform(0.1, 0.4, (n, 1, 1)) * 0.5
        exp_time = amp_compensate * np.exp(
            -0.5 * (ts[None, :, None] - loc_t) ** 2 / sig_t**2
        )
        return amp * exp_space * exp_time

    f = rand_f(rand_amp=False)
    for _ in range(7):
        f = f + rand_f(rand_amp=True)
    if alpha != 1.0:
        f = np.clip(f * alpha, -10.0, 10.0)
    return u0.astype(np.float32), f.astype(np.float32)
