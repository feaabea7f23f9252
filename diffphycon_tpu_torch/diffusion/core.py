"""Gaussian diffusion core (DDPM + DDIM) for physical-system control.

Port of ``diffphycon_tpu/diffusion/core.py``: the training loss
(:meth:`GaussianDiffusion.p_losses`, :meth:`GaussianDiffusion.loss`) and the
samplers. The samplers are
Python loops over denoise steps; each step runs the denoiser(s) (two UNet2D
forwards for two-model sampling), the guidance gradient (autograd through the
control objective, not through the nets), prior reweighting, the posterior
update and condition re-pinning.

Randomness comes from an explicit ``torch.Generator``; it cannot reproduce
JAX's ``fold_in`` streams, so the DDPM step also takes an explicit ``noise``
tensor, DDIM with eta = 0 draws none, and ``p_losses`` takes t and the noise
as arguments (``loss`` draws them).

With ``combine_w_with_guidance`` (the smoke ordering) the prior
reweighting is deferred: guidance is taken at the x_start of the
unreweighted joint eps, and ``scale * g + (gamma - 1) * eps_w`` is added
after it.

Only the pred_noise objective is ported (``loss_weight`` is all ones).
Not ported yet: ``fuse_two_models``, the pred_x0/pred_v objectives,
post-hoc guidance (``guidance_u0=False``) and ``CondSpec.transform``
(jellyfish).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from diffphycon_tpu_torch.device import resolve_device
from diffphycon_tpu_torch.diffusion.schedules import BETA_SCHEDULES


@dataclasses.dataclass(frozen=True)
class DiffusionConstants:
    """Per-timestep coefficient buffers (float32 tensors, built in float64)."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_prev: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    loss_weight: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    @classmethod
    def create(cls, timesteps: int, beta_schedule: str = "cosine",
               device=None) -> "DiffusionConstants":
        """The buffers on ``device`` (default CUDA, see resolve_device);
        ``loss_weight`` is pred_noise's, all ones."""
        device = resolve_device(device)
        betas = np.asarray(BETA_SCHEDULES[beta_schedule](timesteps), np.float64)
        alphas = 1.0 - betas
        alphas_prev = np.concatenate([[1.0], alphas[:-1]])
        acp = np.cumprod(alphas)
        acp_prev = np.concatenate([[1.0], acp[:-1]])
        posterior_variance = betas * (1.0 - acp_prev) / (1.0 - acp)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float32,
                                   device=device)

        return cls(
            betas=f32(betas),
            alphas=f32(alphas),
            alphas_prev=f32(alphas_prev),
            alphas_cumprod=f32(acp),
            alphas_cumprod_prev=f32(acp_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / acp)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
            posterior_variance=f32(posterior_variance),
            posterior_log_variance_clipped=f32(
                np.log(np.clip(posterior_variance, 1e-20, None))),
            posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
            loss_weight=f32(np.ones_like(betas)),
        )


def _identity2(x, cond):
    return x


def _keep_model_out(model_out, target, cond):
    return model_out


@dataclasses.dataclass(frozen=True)
class CondSpec:
    """Conditioning as pure functions of (tensor, cond dict), as the JAX
    ``CondSpec``: pin overwrites the conditioned slices, w_zero_input /
    w_zero_output blank the state for the prior p(w) model, sampling_mask is
    an extra per-step projection. Training: zero_target zeroes the noise
    target at conditioned slices; loss_mask_pre / loss_mask_post (fn(model_out,
    target, cond)) replace model outputs by the target where no loss should
    flow, before and after the target is zeroed."""

    pin: Callable = _identity2
    zero_target: Callable = _identity2
    w_zero_input: Callable = _identity2
    w_zero_output: Callable = _identity2
    sampling_mask: Callable = _identity2
    loss_mask_pre: Callable = _keep_model_out
    loss_mask_post: Callable = _keep_model_out


@dataclasses.dataclass(frozen=True)
class GuidanceSpec:
    """nabla_j: x -> dJ/dx; j_schedule / w_schedule: (T,) eta_J(t), eta_w(t);
    proj: combine (eps, guidance) -> eps, additive by default."""

    nabla_j: Optional[Callable] = None
    j_schedule: Optional[torch.Tensor] = None
    w_schedule: Optional[torch.Tensor] = None
    proj: Callable = lambda eps, g: eps + g


class GaussianDiffusion:
    """Diffusion over trajectory tensors x of shape (B, *spatial, C).

    model: fn(x, t) -> model output, t a (B,) float32 tensor (the joint or
    only model). model_w: the prior p(w) model for two-model sampling with
    prior reweighting. Other arguments as in the JAX ``GaussianDiffusion``
    (objective pred_noise, guidance applied on x_start). ``device`` defaults
    to CUDA (see resolve_device).
    """

    def __init__(self, model: Callable, *, sample_shape: tuple,
                 timesteps: int = 1000, sampling_timesteps: Optional[int] = None,
                 beta_schedule: str = "cosine", ddim_sampling_eta: float = 0.0,
                 cond: CondSpec = CondSpec(), model_w: Optional[Callable] = None,
                 is_model_w: bool = False, prior_beta: float = 1.0,
                 normalize_beta: bool = False, combine_w_with_guidance: bool = False,
                 clip_denoised: bool = True, recurrence: bool = False,
                 recurrence_k: int = 1, device=None):
        self.model = model
        self.model_w = model_w
        self.sample_shape = tuple(sample_shape)
        self.device = resolve_device(device)
        self.consts = DiffusionConstants.create(timesteps, beta_schedule,
                                                device=self.device)
        self.num_timesteps = timesteps
        self.sampling_timesteps = sampling_timesteps or timesteps
        if self.sampling_timesteps > timesteps:
            raise ValueError("sampling_timesteps must not exceed timesteps")
        self.is_ddim_sampling = self.sampling_timesteps < timesteps
        self.ddim_sampling_eta = ddim_sampling_eta
        self.cond = cond
        self.is_model_w = is_model_w
        self.prior_beta = prior_beta
        self.normalize_beta = normalize_beta
        self.combine_w_with_guidance = combine_w_with_guidance
        self.clip_denoised = clip_denoised
        self.recurrence = recurrence
        self.recurrence_k = recurrence_k

    # -- q / prediction helpers --------------------------------------------

    @staticmethod
    def _ex(a: torch.Tensor, t, ndim: int):
        """a[t] shaped to broadcast against an ndim tensor (t int or (B,))."""
        if isinstance(t, int):
            return a[t]
        return a[t].reshape((-1,) + (1,) * (ndim - 1))

    def q_sample(self, x_start, t, noise):
        c, nd = self.consts, x_start.ndim
        return (self._ex(c.sqrt_alphas_cumprod, t, nd) * x_start
                + self._ex(c.sqrt_one_minus_alphas_cumprod, t, nd) * noise)

    def predict_start_from_noise(self, x_t, t, noise):
        c, nd = self.consts, x_t.ndim
        return (self._ex(c.sqrt_recip_alphas_cumprod, t, nd) * x_t
                - self._ex(c.sqrt_recipm1_alphas_cumprod, t, nd) * noise)

    def predict_noise_from_start(self, x_t, t, x0):
        c, nd = self.consts, x_t.ndim
        return ((self._ex(c.sqrt_recip_alphas_cumprod, t, nd) * x_t - x0)
                / self._ex(c.sqrt_recipm1_alphas_cumprod, t, nd))

    def predict_v(self, x_start, t, noise):
        c, nd = self.consts, x_start.ndim
        return (self._ex(c.sqrt_alphas_cumprod, t, nd) * noise
                - self._ex(c.sqrt_one_minus_alphas_cumprod, t, nd) * x_start)

    def predict_start_from_v(self, x_t, t, v):
        c, nd = self.consts, x_t.ndim
        return (self._ex(c.sqrt_alphas_cumprod, t, nd) * x_t
                - self._ex(c.sqrt_one_minus_alphas_cumprod, t, nd) * v)

    def q_posterior(self, x_start, x_t, t):
        c, nd = self.consts, x_t.ndim
        mean = (self._ex(c.posterior_mean_coef1, t, nd) * x_start
                + self._ex(c.posterior_mean_coef2, t, nd) * x_t)
        return mean, self._ex(c.posterior_log_variance_clipped, t, nd)

    # -- model predictions --------------------------------------------------

    @torch.no_grad()
    def _raw_eps(self, x, t: int, cond_vals: dict, guidance: GuidanceSpec):
        """(eps, eps_w): the model output, with two-model prior reweighting
        ``out - (1 - gamma) * eta_w(t) * out_w`` (or the normalize_beta
        form), and eps_w None; with combine_w_with_guidance the joint output
        unreweighted and eps_w the embedded prior output."""
        tb = torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)
        if self.model_w is not None:
            out = self.model(x, tb)
            out_w = self.model_w(self.cond.w_zero_input(x, cond_vals), tb)
            out_w = self.cond.w_zero_output(out_w, cond_vals)
            if self.combine_w_with_guidance:
                return out, out_w
            if self.normalize_beta:
                return (out - (1.0 - self.prior_beta) * out_w) / self.prior_beta, None
            eta = 1.0 if guidance.w_schedule is None else guidance.w_schedule[t]
            return out - (1.0 - self.prior_beta) * eta * out_w, None
        if self.is_model_w:
            out = self.prior_beta * self.model(self.cond.w_zero_input(x, cond_vals), tb)
            return self.cond.w_zero_output(out, cond_vals), None
        return self.model(x, tb), None

    def model_predictions(self, x, t: int, cond_vals: dict, guidance: GuidanceSpec,
                          clip_x_start: bool = False,
                          rederive_pred_noise: bool = False):
        """(pred_noise, x_start), the guidance gradient at x_start folded into
        the predicted noise."""
        pred_noise, eps_w = self._raw_eps(x, t, cond_vals, guidance)

        def maybe_clip(v):
            return v.clamp(-1.0, 1.0) if clip_x_start else v

        x_start = maybe_clip(self.predict_start_from_noise(x, t, pred_noise))
        scale = 1.0 if guidance.j_schedule is None else guidance.j_schedule[t]
        if eps_w is not None:
            # smoke ordering: grad_final = scale * g + (gamma - 1) * eps_w
            g = 0.0 if guidance.nabla_j is None else guidance.nabla_j(x_start) * scale
            pred_noise = pred_noise + (g + (self.prior_beta - 1.0) * eps_w)
            x_start = maybe_clip(self.predict_start_from_noise(x, t, pred_noise))
        elif guidance.nabla_j is not None:
            pred_noise = guidance.proj(pred_noise, guidance.nabla_j(x_start) * scale)
            x_start = maybe_clip(self.predict_start_from_noise(x, t, pred_noise))
        if clip_x_start and rederive_pred_noise:
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        return pred_noise, x_start

    # -- training loss ------------------------------------------------------

    def p_losses(self, x_start, t, cond_vals: dict, noise):
        """Denoising loss of one batch, term for term the JAX ``p_losses``.

        x_start: clean batch (B, *spatial, C); t: (B,) int64 timesteps;
        noise: like x_start; cond_vals: the conditioning arrays derived from
        x_start. Differentiable through ``self.model``."""
        x = self.q_sample(x_start, t, noise)
        x = self.cond.pin(x, cond_vals)
        if self.is_model_w:
            x = self.cond.w_zero_input(x, cond_vals)
        model_out = self.model(x, t.to(torch.float32))
        target = noise
        # the reference's masking order: the pre mask, then the target zeroed
        # at conditioned slices, then the post mask
        model_out = self.cond.loss_mask_pre(model_out, target, cond_vals)
        target = self.cond.zero_target(target, cond_vals)
        model_out = self.cond.loss_mask_post(model_out, target, cond_vals)
        loss = ((model_out - target) ** 2).reshape(x_start.shape[0], -1).mean(dim=1)
        return (loss * self.consts.loss_weight[t]).mean()

    def draw_t_noise(self, x_start, generator: torch.Generator):
        """(t (B,) uniform in [0, T), noise like x_start) from ``generator``."""
        t = torch.randint(0, self.num_timesteps, (x_start.shape[0],), generator=generator,
                          device=x_start.device)
        return t, self._randn(x_start, generator)

    def loss(self, x_start, cond_vals: dict, generator: torch.Generator):
        """p_losses at t and noise drawn from ``generator``."""
        t, noise = self.draw_t_noise(x_start, generator)
        return self.p_losses(x_start, t, cond_vals, noise)

    # -- sampling -----------------------------------------------------------

    def _randn(self, x, generator):
        if generator is None:
            raise ValueError("this step draws noise: pass a torch.Generator "
                             "(or an explicit noise tensor)")
        return torch.randn(x.shape, generator=generator, device=x.device,
                           dtype=x.dtype)

    def _p_sample_step(self, x, t: int, cond_vals, guidance, noise=None,
                       generator=None):
        """One ancestral step x_t -> x_{t-1}. The noise is ``noise`` when
        given, else drawn from ``generator``; it is masked out at t = 0."""
        _, x_start = self.model_predictions(x, t, cond_vals, guidance)
        if self.clip_denoised:
            x_start = x_start.clamp(-1.0, 1.0)
        mean, log_var = self.q_posterior(x_start, x, t)
        if noise is None:
            noise = self._randn(x, generator)
        noise = noise * float(t > 0)
        return mean + torch.exp(0.5 * log_var) * noise

    def _pin_all(self, x, cond_vals):
        return self.cond.sampling_mask(self.cond.pin(x, cond_vals), cond_vals)

    def ddpm_step(self, x, t: int, cond_vals: dict, guidance: GuidanceSpec,
                  generator=None, noise=None):
        """One full DDPM denoise step at time t (pin, predict, guide,
        posterior, recurrence)."""
        c = self.consts
        for _ in range(self.recurrence_k if self.recurrence else 1):
            x_new = self._p_sample_step(self._pin_all(x, cond_vals), t, cond_vals,
                                        guidance, noise=noise, generator=generator)
            if self.recurrence:
                # re-noise x_{t-1} -> x_t (Universal Guidance)
                a_t, a_tm1 = c.alphas[t], c.alphas_prev[t]
                rn = self._randn(x_new, generator) * float(t > 0)
                x_new = torch.sqrt(a_t / a_tm1) * x_new + torch.sqrt(1.0 - a_t / a_tm1) * rn
            x = x_new
        return x

    def ddim_step(self, x, t: int, tn: int, cond_vals: dict, guidance: GuidanceSpec,
                  generator=None, noise=None):
        """One DDIM step t -> tn (tn < 0 returns x_start). With eta > 0 the
        noise is ``noise`` when given, else drawn from ``generator``."""
        c = self.consts
        x = self._pin_all(x, cond_vals)
        pred_noise, x_start = self.model_predictions(
            x, t, cond_vals, guidance, clip_x_start=self.clip_denoised,
            rederive_pred_noise=True)
        if tn < 0:
            return x_start
        alpha, alpha_next = c.alphas_cumprod[t], c.alphas_cumprod[tn]
        x_new = x_start * torch.sqrt(alpha_next)
        eta = self.ddim_sampling_eta
        if eta == 0:
            return x_new + torch.sqrt(torch.clamp(1 - alpha_next, min=0.0)) * pred_noise
        sigma = eta * torch.sqrt(torch.clamp(
            (1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha), min=0.0))
        coef = torch.sqrt(torch.clamp(1 - alpha_next - sigma**2, min=0.0))
        if noise is None:
            noise = self._randn(x, generator)
        return x_new + coef * pred_noise + sigma * noise

    def sample_ts(self):
        """Step schedule: DDPM a list of t; DDIM a list of (t, t_next)."""
        if not self.is_ddim_sampling:
            return list(range(self.num_timesteps - 1, -1, -1))
        times = np.linspace(-1, self.num_timesteps - 1,
                            self.sampling_timesteps + 1).astype(int)
        times = list(reversed(times.tolist()))
        return list(zip(times[:-1], times[1:]))

    def sample_init(self, batch_size: int, generator: torch.Generator):
        return torch.randn((batch_size,) + self.sample_shape, generator=generator,
                           device=self.device, dtype=torch.float32)

    def sample_chunk(self, x, ts, cond_vals: dict,
                     guidance: GuidanceSpec = GuidanceSpec(), generator=None):
        """Run the steps ``ts`` (a slice of :meth:`sample_ts`) on carry x."""
        for tt in ts:
            if self.is_ddim_sampling:
                x = self.ddim_step(x, tt[0], tt[1], cond_vals, guidance, generator)
            else:
                x = self.ddpm_step(x, tt, cond_vals, guidance, generator)
        return x

    def sample(self, batch_size: int = 16, cond_vals: Optional[dict] = None,
               guidance: GuidanceSpec = GuidanceSpec(),
               generator: Optional[torch.Generator] = None):
        """Full DDPM or DDIM sampling from x_T ~ N(0, I)."""
        if generator is None:
            raise ValueError("sample needs an explicit torch.Generator")
        x = self.sample_init(batch_size, generator)
        return self.sample_chunk(x, self.sample_ts(), cond_vals or {}, guidance, generator)
