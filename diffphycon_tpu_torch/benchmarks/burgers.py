"""Burgers benchmark wiring: config, model/diffusion builders, evaluation.

Port of ``diffphycon_tpu/benchmarks/burgers.py``. Builders take a ``device``
(default: CUDA, see :func:`diffphycon_tpu_torch.resolve_device`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from diffphycon_tpu_torch.control.guidance import burgers_guidance_from_x, make_nabla_j
from diffphycon_tpu_torch.control.metrics import burgers_metric, mse_deviation
from diffphycon_tpu_torch.device import resolve_device
from diffphycon_tpu_torch.diffusion import (
    GaussianDiffusion,
    GuidanceSpec,
    burgers_cond_spec,
    burgers_derive_cond,
    get_proj_ep_orthogonal,
    make_guidance_schedule,
)
from diffphycon_tpu_torch.nets import UNet2D
from diffphycon_tpu_torch.nets.init import seeded_init_
from diffphycon_tpu_torch.physics.burgers import burgers_solve

RESCALER = 10.0


@dataclasses.dataclass
class BurgersConfig:
    # unet
    dim: int = 64
    dim_mults: Sequence[int] = (1, 2, 4, 8)
    # deprecated alias: when given it overrides dim_mults, then resets to None
    # so dataclasses.replace(cfg, dim_mults=...) round-trips
    dim_muls: Optional[Sequence[int]] = None
    resnet_block_groups: int = 1
    # ddpm
    timesteps: int = 1000
    using_ddim: bool = False
    ddim_sampling_steps: int = 1000
    ddim_eta: float = 0.0
    beta_schedule: str = "cosine"
    # conditioning
    is_condition_u0: bool = False
    is_condition_uT: bool = False
    is_condition_u0_zero_pred_noise: bool = True
    is_condition_uT_zero_pred_noise: bool = True
    condition_idx: int = 10
    train_on_partially_observed: Optional[str] = None
    set_unobserved_to_zero_during_sampling: bool = False
    train_on_padded_locations: bool = True
    partially_observed: Optional[str] = None
    partial_control: Optional[str] = "full"
    # two-model
    is_model_w: bool = False
    prior_beta: float = 1.0
    normalize_beta: bool = False
    # sampling extras
    recurrence: bool = False
    recurrence_k: int = 1
    # compute: ``bf16`` with ``impl`` "xla" (JAX's build_unet: the flax
    # UNet2D under dtype=bfloat16) or "pallas" (JAX's infer_burgers --impl
    # pallas: bf16 weight packs, float32 activations); float32 whatever impl
    bf16: bool = False
    impl: str = "xla"

    nt_total: int = 11
    nx: int = 128
    pad_t: int = 16

    def __post_init__(self):
        if self.dim_muls is not None:
            self.dim_mults = tuple(self.dim_muls)
        self.dim_mults = tuple(self.dim_mults)
        self.dim_muls = None


IMPLS = ("xla", "pallas")


def _new_unet(cfg: BurgersConfig) -> UNet2D:
    """float32 parameters always. ``bf16`` with ``impl`` "xla": the JAX
    ``build_unet``'s ``UNet2D(dtype=jnp.bfloat16)``, flax's compute dtype
    (``UNet2D(dtype=torch.bfloat16)``: bf16 activations on the
    bf16-activation kernels); with ``impl`` "pallas": the Pallas forward's
    bf16 weight packs (``UNet2D(weight_dtype=torch.bfloat16)``, float32
    activations), as JAX's ``infer_burgers --impl pallas``."""
    if cfg.impl not in IMPLS:
        raise ValueError(f"BurgersConfig.impl {cfg.impl!r}; one of {IMPLS}")
    if not cfg.bf16:
        dtypes = {}
    elif cfg.impl == "pallas":
        dtypes = {"weight_dtype": torch.bfloat16}
    else:
        dtypes = {"dtype": torch.bfloat16}
    return UNet2D(dim=cfg.dim, out_dim=2, dim_mults=tuple(cfg.dim_mults), channels=2,
                  resnet_block_groups=cfg.resnet_block_groups, **dtypes)


def build_unet(cfg: BurgersConfig, device=None) -> UNet2D:
    """The Burgers UNet2D in eval mode on ``device`` (weights to be loaded)."""
    return _new_unet(cfg).to(resolve_device(device)).eval()


def init_params(cfg: BurgersConfig, seed: int = 0, device=None) -> UNet2D:
    """A UNet2D with seeded random weights (the same on every device)."""
    dev = resolve_device(device)
    net = seeded_init_(_new_unet(cfg), torch.Generator().manual_seed(seed))
    return net.to(dev).eval()


def build_diffusion(cfg: BurgersConfig, model, model_w=None,
                    device=None) -> GaussianDiffusion:
    """model / model_w: fn(x, t) -> eps, e.g. a UNet2D."""
    cond = burgers_cond_spec(
        is_condition_u0=cfg.is_condition_u0,
        is_condition_uT=cfg.is_condition_uT,
        is_condition_u0_zero_pred_noise=cfg.is_condition_u0_zero_pred_noise,
        is_condition_uT_zero_pred_noise=cfg.is_condition_uT_zero_pred_noise,
        condition_idx=cfg.condition_idx,
        is_model_w=cfg.is_model_w and model_w is None,
        train_on_partially_observed=cfg.train_on_partially_observed,
        set_unobserved_to_zero_during_sampling=cfg.set_unobserved_to_zero_during_sampling,
        train_on_padded_locations=cfg.train_on_padded_locations,
    )
    return GaussianDiffusion(
        model, model_w=model_w,
        sample_shape=(cfg.pad_t, cfg.nx, 2),
        timesteps=cfg.timesteps,
        sampling_timesteps=(cfg.ddim_sampling_steps if cfg.using_ddim
                            else cfg.timesteps),
        ddim_sampling_eta=cfg.ddim_eta,
        beta_schedule=cfg.beta_schedule,
        cond=cond,
        is_model_w=cfg.is_model_w and model_w is None,
        prior_beta=cfg.prior_beta,
        normalize_beta=cfg.normalize_beta,
        recurrence=cfg.recurrence,
        recurrence_k=cfg.recurrence_k,
        device=resolve_device(device),
    )


derive_cond = burgers_derive_cond


@dataclasses.dataclass
class EvalResult:
    """Per-batch metrics as numpy arrays."""

    ddpm_mse: np.ndarray
    j_actual: Tuple[np.ndarray, ...]  # (mse, mse_med, mae, mae_med, nmse, nmae)
    j_diffused: Tuple[np.ndarray, ...]
    control_energy: np.ndarray


@torch.no_grad()
def evaluate_samples(x, u_target, cfg: BurgersConfig) -> EvalResult:
    """Re-simulate sampled controls with the solver and score them.

    x: (B, 16, 128, 2) samples in model scale; u_target: (B, 11, 128)
    unscaled ground truth on x's device. ddpm_mse re-simulates from the
    diffused u0, J_actual from the target's u0."""
    x = x * RESCALER
    u = x[:, : cfg.nt_total, :, 0]
    f = x[:, : cfg.nt_total - 1, :, 1]
    x_gt = burgers_solve(x[:, 0, :, 0], f, visc=0.01, T=1.0, dt=1e-4,
                         num_t=cfg.nt_total - 1)
    ddpm_mse = mse_deviation(u, x_gt, partially_observed=cfg.partially_observed)
    j_diffused, _ = burgers_metric(
        u_target, f, partial_control=cfg.partial_control, report_all=True,
        diffused_u=u, evaluate_u=True, partially_observed=cfg.partially_observed)
    j_actual, energy = burgers_metric(
        u_target, f, partial_control=cfg.partial_control, report_all=True,
        partially_observed=cfg.partially_observed)

    def to_np(vals):
        return tuple(v.cpu().numpy() for v in vals)

    return EvalResult(ddpm_mse=ddpm_mse.cpu().numpy(), j_actual=to_np(j_actual),
                      j_diffused=to_np(j_diffused),
                      control_energy=energy.cpu().numpy())


def build_guidance(cfg: BurgersConfig, u_target, wu=0.0, wf=0.0, wreg=0.0,
                   j_scheduler: Optional[str] = None,
                   w_scheduler: Optional[str] = None,
                   proj_guidance: Optional[str] = None) -> GuidanceSpec:
    """Guidance over the rescaled target u_target (B, 11, 128), unscaled, on
    the sampling device. proj_guidance: None (additive) or
    'ep_orthogonal_{F,1D_x,1D_t}'."""
    loss_fn = burgers_guidance_from_x(
        u_target / RESCALER, wu=wu, wf=wf, wreg=wreg, use_dist_reg=wreg != 0,
        partially_observed=cfg.partially_observed,
        nt_u=cfg.nt_total, nt_f=cfg.nt_total - 1)
    kwargs = {}
    if proj_guidance:
        kwargs["proj"] = get_proj_ep_orthogonal(proj_guidance.removeprefix("ep_orthogonal_"))
    dev = u_target.device
    return GuidanceSpec(
        nabla_j=make_nabla_j(loss_fn) if (wu or wf or wreg) else None,
        j_schedule=(make_guidance_schedule(j_scheduler, cfg.timesteps, dev)
                    if j_scheduler else None),
        w_schedule=(make_guidance_schedule(w_scheduler, cfg.timesteps, dev)
                    if w_scheduler else None),
        **kwargs,
    )
