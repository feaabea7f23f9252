"""Diffusion noise schedules and guidance-strength schedules.

Port of ``diffphycon_tpu/diffusion/schedules.py``: built in float64 numpy,
handed out as float32. Guidance schedules are arrays eta[t] indexed by the
diffusion time t.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from diffphycon_tpu_torch.device import resolve_device


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    scale = 1000.0 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def sigmoid_beta_schedule(timesteps: int, start: float = -3, end: float = 3,
                          tau: float = 1) -> np.ndarray:
    def _sigmoid(v):
        return 1.0 / (1.0 + np.exp(-v))

    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64) / timesteps
    v_start = _sigmoid(start / tau)
    v_end = _sigmoid(end / tau)
    alphas_cumprod = (-_sigmoid((x * (end - start) + start) / tau) + v_end) / (
        v_end - v_start)
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


BETA_SCHEDULES = {
    "linear": linear_beta_schedule,
    "cosine": cosine_beta_schedule,
    "sigmoid": sigmoid_beta_schedule,
}


def _plain_cosine_eta(timesteps: int, s: float = 0.0) -> np.ndarray:
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    eta = np.cos((x + s) / (timesteps + s))
    return eta[::-1][:timesteps].copy()


GUIDANCE_SCHEDULES = {
    "cosine": cosine_beta_schedule,
    "plain_cosine": _plain_cosine_eta,
    "sigmoid": sigmoid_beta_schedule,
    "sigmoid_flip": lambda n: sigmoid_beta_schedule(n)[::-1].copy(),
}


def make_guidance_schedule(name, timesteps: int, device=None) -> torch.Tensor:
    """eta[t] for t in [0, timesteps) as float32 on ``device`` (default
    CUDA, see resolve_device); None/'none' = ones."""
    device = resolve_device(device)
    if name is None or name == "none":
        return torch.ones(timesteps, dtype=torch.float32, device=device)
    if name not in GUIDANCE_SCHEDULES:
        raise ValueError(f"unknown guidance schedule: {name!r}")
    return torch.as_tensor(GUIDANCE_SCHEDULES[name](timesteps), dtype=torch.float32,
                           device=device)
