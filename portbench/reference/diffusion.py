"""Plain reference of the DiffPhyCon diffusion steps, guidance and loss.

Schedules (cosine, linear), the guided two-model DDPM step of 1D Burgers
(u0 / uT pinned, prior reweighting ``eps - (1 - gamma) eps_w``, the
control objective's gradient at x_start, the posterior step) and the guided
two-model DDIM step of 2D smoke (frame-0 density pinned, the prior on the
control channels, ``scale g + (gamma - 1) eps_w`` added to the joint eps,
clipped x_start, eta > 0), and the smoke training loss. The guidance
gradients are written out analytically: both objectives are quadratic or
linear in the sample.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def betas(schedule: str, timesteps: int) -> np.ndarray:
    if schedule == "linear":
        scale = 1000.0 / timesteps
        return np.linspace(scale * 1e-4, scale * 0.02, timesteps, dtype=np.float64)
    if schedule == "cosine":
        s = 0.008
        x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
        acp = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
        acp = acp / acp[0]
        return np.clip(1 - acp[1:] / acp[:-1], 0, 0.999)
    raise ValueError(schedule)


class Constants:
    """Per-timestep coefficients in float64, read as Python floats."""

    def __init__(self, schedule: str, timesteps: int):
        b = betas(schedule, timesteps)
        a = 1.0 - b
        acp = np.cumprod(a)
        acp_prev = np.concatenate([[1.0], acp[:-1]])
        var = b * (1.0 - acp_prev) / (1.0 - acp)
        self.acp = acp
        self.sqrt_acp = np.sqrt(acp)
        self.sqrt_1m_acp = np.sqrt(1.0 - acp)
        self.sqrt_recip = np.sqrt(1.0 / acp)
        self.sqrt_recipm1 = np.sqrt(1.0 / acp - 1.0)
        self.coef1 = b * np.sqrt(acp_prev) / (1.0 - acp)
        self.coef2 = (1.0 - acp_prev) * np.sqrt(a) / (1.0 - acp)
        self.log_var = np.log(np.clip(var, 1e-20, None))

    def start_from_noise(self, x, t: int, eps):
        return float(self.sqrt_recip[t]) * x - float(self.sqrt_recipm1[t]) * eps


def burgers_pin(x, u0, uT, idx: int):
    x = x.clone()
    x[:, 0, :, 0] = u0
    x[:, idx, :, 0] = uT
    return x


def burgers_guidance(x_start, u_target, wu: float, nt: int):
    """d/dx of wu * sum over rows 0 and nt-1 of (u - u*)^2 / (B * Nx)."""
    b, nx = x_start.shape[0], x_start.shape[2]
    g = torch.zeros_like(x_start)
    for row in (0, nt - 1):
        g[:, row, :, 0] = 2.0 * wu * (x_start[:, row, :, 0] - u_target[:, row]) / (b * nx)
    return g


def burgers_ddpm_step(C: Constants, x, t: int, noise, cfg, cond, joint, prior):
    """One guided two-model DDPM step of Burgers. joint / prior: fn(x, t
    (B,)) -> eps. Returns (x_{t-1}, eps of the joint, eps of the prior)."""
    idx = cfg["condition_idx"]
    x = burgers_pin(x, cond["u0"], cond["uT"], idx)
    tb = torch.full((x.shape[0],), float(t), device=x.device)
    x_w = x.clone()
    x_w[:, 1:idx, :, 0] = 0.0  # the prior never sees u between the ends
    out = joint(x, tb)
    out_w = prior(x_w, tb)
    out_w_kept = out_w.clone()
    out_w_kept[..., 0] = 0.0  # the prior outputs w only
    eps = out - (1.0 - cfg["prior_beta"]) * out_w_kept
    x_start = C.start_from_noise(x, t, eps)
    g = burgers_guidance(x_start, cond["u_target_scaled"], cfg["guidance"]["wu"],
                         cfg["nt_total"])
    eps = eps + g
    x_start = C.start_from_noise(x, t, eps).clamp(-1.0, 1.0)
    mean = float(C.coef1[t]) * x_start + float(C.coef2[t]) * x
    sd = math.exp(0.5 * float(C.log_var[t]))
    return mean + sd * noise * float(t > 0), out, out_w


def smoke_ddim_step(C: Constants, x, t: int, tn: int, noise, cfg, cond, joint, prior):
    """One guided two-model DDIM step of smoke (the combined ordering).
    Returns (x_next, eps of the joint, eps of the prior)."""
    x = x.clone()
    x[:, 0, :, :, 0] = cond["init"]
    tb = torch.full((x.shape[0],), float(t), device=x.device)
    out = joint(x, tb)
    out_w = prior(x[..., 3:5].contiguous(), tb)
    eps_w = torch.zeros_like(out)
    eps_w[..., 3:5] = out_w
    x_start = C.start_from_noise(x, t, out).clamp(-1.0, 1.0)
    # d/dz of -sum_b mean_hw z[b, -1, :, :, 5] (+ w_energy * energy), at z = x * R
    g = torch.zeros_like(x)
    hw = x.shape[2] * x.shape[3]
    g[:, -1, :, :, 5] = -1.0 / hw
    if cfg["w_energy"]:
        rs = torch.as_tensor(cfg["rescaler"], device=x.device)
        z = x_start * rs
        g[..., 3:5] += cfg["w_energy"] * 2.0 * z[..., 3:5] / (z[..., 3:5][0].numel())
    eps = out + (g * cfg["standard_fixed_ratio"] + (cfg["w_prob_exp"] - 1.0) * eps_w)
    x_start = C.start_from_noise(x, t, eps).clamp(-1.0, 1.0)
    eps = (float(C.sqrt_recip[t]) * x - x_start) / float(C.sqrt_recipm1[t])
    if tn < 0:
        return x_start, out, out_w
    a, an = float(C.acp[t]), float(C.acp[tn])
    eta = cfg["ddim_eta"]
    sigma = eta * math.sqrt(max((1 - a / an) * (1 - an) / (1 - a), 0.0))
    coef = math.sqrt(max(1 - an - sigma ** 2, 0.0))
    return x_start * math.sqrt(an) + coef * eps + sigma * noise, out, out_w


def smoke_loss_per_sample(C: Constants, x0, t, noise, joint):
    """p_losses of the smoke joint model per sample (pred_noise, weight 1):
    q-sample, frame-0 density pinned to the clean batch's, the noise target
    zeroed there. x0: (b, F, H, W, 6); t: (b,) int64."""
    sa = torch.as_tensor(C.sqrt_acp, dtype=torch.float32, device=x0.device)[t]
    s1 = torch.as_tensor(C.sqrt_1m_acp, dtype=torch.float32, device=x0.device)[t]
    shape = (-1,) + (1,) * (x0.dim() - 1)
    x = sa.reshape(shape) * x0 + s1.reshape(shape) * noise
    x = x.clone()
    x[:, 0, :, :, 0] = x0[:, 0, :, :, 0]
    target = noise.clone()
    target[:, 0, :, :, 0] = 0.0
    out = joint(x, t.float())
    return ((out - target) ** 2).reshape(x0.shape[0], -1).mean(dim=1)
