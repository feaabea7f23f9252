"""Smoke benchmark wiring: config, builders, guidance, on-device evaluation.

Port of ``diffphycon_tpu/benchmarks/smoke.py``. The evaluation re-simulates
the sampled controls with the batched smoke solver (255 K4 pressure solves
per call). Builders take a ``device`` (default: CUDA, see
:func:`diffphycon_tpu_torch.resolve_device`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from diffphycon_tpu_torch.control.guidance import make_nabla_j
from diffphycon_tpu_torch.device import resolve_device
from diffphycon_tpu_torch.diffusion import (
    DiffusionConstants,
    GaussianDiffusion,
    GuidanceSpec,
    smoke_cond_spec,
)
from diffphycon_tpu_torch.nets.init import seeded_init_
from diffphycon_tpu_torch.nets.unet3d import UNet3D
from diffphycon_tpu_torch.physics.fluids.smoke_env import SmokeSim, smoke_solver

# per-channel rescaler: (density, vx, vy, c1, c2, smoke portion)
RESCALER = np.array([2.0, 18.0, 20.0, 16.0, 20.0, 1.0], np.float32)


@dataclasses.dataclass
class SmokeConfig:
    dim: int = 64
    dim_mults: Sequence[int] = (1, 2, 4)
    frames: int = 32
    image_size: int = 64
    timesteps: int = 1000
    using_ddim: bool = True
    ddim_sampling_steps: int = 100
    ddim_eta: float = 1.0
    beta_schedule: str = "linear"
    is_w_model: bool = False
    w_prob_exp: float = 0.97
    standard_fixed_ratio: float = 1e5
    coeff_ratio: float = 0.0
    design_guidance: str = "standard"  # 'standard' | 'standard-alpha'
    w_energy: float = 0.0
    bf16: bool = False
    remat_all: bool = False  # recompute every UNet3D block in the backward


def channels(cfg: SmokeConfig) -> int:
    return 2 if cfg.is_w_model else 6


def _new_unet(cfg: SmokeConfig) -> UNet3D:
    """``bf16``: the UNet3D computes in bfloat16 (flax ``dtype=bf16``) on
    float32 parameters."""
    return UNet3D(dim=cfg.dim, dim_mults=tuple(cfg.dim_mults), channels=channels(cfg),
                  out_dim=channels(cfg), resnet_groups=8, remat_all=cfg.remat_all,
                  dtype=torch.bfloat16 if cfg.bf16 else torch.float32)


def build_unet(cfg: SmokeConfig, device=None) -> UNet3D:
    """The smoke UNet3D in eval mode on ``device`` (weights to be loaded)."""
    return _new_unet(cfg).to(resolve_device(device)).eval()


def init_params(cfg: SmokeConfig, seed: int = 0, device=None) -> UNet3D:
    """A UNet3D with seeded random weights (the same on every device)."""
    dev = resolve_device(device)
    net = seeded_init_(_new_unet(cfg), torch.Generator().manual_seed(seed))
    return net.to(dev).eval()


def build_diffusion(cfg: SmokeConfig, model, model_w=None, device=None) -> GaussianDiffusion:
    """Single-model or two-model (the smoke ordering
    ``combine_w_with_guidance``) smoke diffusion; model / model_w: fn(x, t)
    -> eps, e.g. a UNet3D."""
    return GaussianDiffusion(
        model, model_w=model_w,
        sample_shape=(cfg.frames, cfg.image_size, cfg.image_size,
                      channels(cfg) if model_w is None else 6),
        timesteps=cfg.timesteps,
        sampling_timesteps=cfg.ddim_sampling_steps if cfg.using_ddim else cfg.timesteps,
        ddim_sampling_eta=cfg.ddim_eta,
        beta_schedule=cfg.beta_schedule,
        cond=smoke_cond_spec(cfg.is_w_model),
        prior_beta=cfg.w_prob_exp,
        combine_w_with_guidance=model_w is not None,
        clip_denoised=True,
        device=resolve_device(device),
    )


def build_guidance(cfg: SmokeConfig, device=None) -> GuidanceSpec:
    """Maximise the final smoke-out portion, penalise control energy. The
    gradient is taken with respect to the rescaled state z and evaluated at
    z = x * RESCALER (not chain-ruled by RESCALER), as in the reference."""
    dev = resolve_device(device)
    r = torch.as_tensor(RESCALER, device=dev)

    def loss_fn(z):  # z: rescaled state (B, F, H, W, 6)
        success = z[:, -1, :, :, -1].mean((-1, -2)).sum()
        energy = (z[..., 3:5] ** 2).mean((1, 2, 3, 4)).sum()
        return -success + cfg.w_energy * energy

    grad = make_nabla_j(loss_fn)

    def nabla_j(x):
        return grad(x * r)

    if cfg.design_guidance == "standard":
        j_schedule = torch.full((cfg.timesteps,), cfg.standard_fixed_ratio,
                                dtype=torch.float32, device=dev)
    elif cfg.design_guidance == "standard-alpha":
        consts = DiffusionConstants.create(cfg.timesteps, cfg.beta_schedule, device=dev)
        j_schedule = cfg.coeff_ratio * torch.flip(consts.betas, (0,))
    else:
        raise ValueError(cfg.design_guidance)
    return GuidanceSpec(nabla_j=nabla_j, j_schedule=j_schedule)


@torch.no_grad()
def evaluate_samples(sim: SmokeSim, pred: torch.Tensor, data: torch.Tensor,
                     w_energy: float = 0.0) -> dict:
    """Re-simulate sampled controls for 256 frames and score them.

    pred: (B, 32, 64, 64, 6) samples in model scale; data: (B, T, 64, 64, 6)
    unscaled test trajectories (frame 0 gives the initial density). Returns
    per-batch (B,) tensors and the re-simulated trajectory ``sim_traj``."""
    pred = pred * torch.as_tensor(RESCALER, device=pred.device)
    b = pred.shape[0]
    # the smoke-portion channel is its spatial mean; the initial density is
    # the data's; indirect control zeroes the interior [8:56)^2
    pred[..., 5] = pred[..., 5].mean((-1, -2), keepdim=True).expand_as(pred[..., 5])
    pred[:, 0, :, :, 0] = data[:, 0, :, :, 0]
    pred[:, :, 8:56, 8:56, 3:5] = 0.0

    init_v = torch.zeros(b, 128, 128, 2, dtype=torch.float32, device=pred.device)
    init_v[..., 1] = 0.8
    out = smoke_solver(sim, init_v, data[:, 0, :, :, 0], pred[..., 3], pred[..., 4],
                       num_t=256)

    def down(a):  # (B, 256, 128, 128) -> (B, 32, 64, 64)
        return a[:, ::8, ::2, ::2]

    smoke_ch = out["smoke_out_record"][:, ::8, None, None].expand(b, 32, 64, 64)
    sim_traj = torch.stack([down(out["densitys"]), down(out["velocitys"][..., 0]),
                            down(out["velocitys"][..., 1]), pred[..., 3], pred[..., 4],
                            smoke_ch], dim=-1)

    mask = torch.ones_like(pred)
    mask[:, 0] = 0.0  # frame 0 is not scored
    p = pred * mask
    d = sim_traj * mask
    diff = p - d
    mse = (torch.cat([diff[..., :3], diff[..., 5:6]], -1) ** 2).mean((1, 2, 3, 4))

    def sq(a):
        return (a ** 2).sum((1, 2, 3))

    n_l2 = torch.sqrt((diff[..., :3] ** 2).sum((1, 2, 3, 4))) / torch.sqrt(
        (d[..., :3] ** 2).sum((1, 2, 3, 4)))
    j_target = -sim_traj[:, -1, 0, 0, 5]
    j_energy = (d[..., 3:5] ** 2).mean((1, 2, 3, 4))
    return {
        "J_total": j_target + w_energy * j_energy,
        "J_target": j_target,
        "J_energy": j_energy,
        "mse": mse,
        "n_l2": n_l2,
        "n_l2_density": torch.sqrt(sq(diff[..., 0])) / torch.sqrt(sq(d[..., 0])),
        "n_l2_v1": torch.sqrt(sq(diff[..., 1])) / torch.sqrt(sq(d[..., 1])),
        "n_l2_v2": torch.sqrt(sq(diff[..., 2])) / torch.sqrt(sq(d[..., 2])),
        "mae_smoke": (p[:, -1, :, :, 5].mean((1, 2)) - d[:, -1, :, :, 5].mean((1, 2))).abs(),
        "sim_traj": sim_traj,
    }
