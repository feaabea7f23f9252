"""Jellyfish benchmark: the EBM joint diffusion, prior reweighting, the
boundary updater inside the sampling loop and force-surrogate guidance.

Port of ``diffphycon_tpu/benchmarks/jellyfish.py``. The state tensor is
channels-last (B, F, 64, 64, 7): 3 state channels (vx, vy, pressure), 3
boundary channels (mask, offset_x, offset_y) and a theta plane. Only
[state, theta] (4 channels) are denoised; each step the boundary channels
are recomputed from theta by the neural boundary updater (a UNet2Dv2).

The sampler is a Python loop over denoise steps. Each step runs the joint
and the prior UNet3D (concurrently on CUDA, ``core.two_forwards``), the guidance gradient through the ForceUNet and the
boundary updater (``torch.autograd.grad`` on detached leaves), the
posterior update, the boundary updater, and the condition re-pinning (or,
with ``cond_steps == 0``, repaint-style noisy conditioning).

Randomness comes from a ``torch.Generator``, which cannot reproduce JAX's
``fold_in(key, t)`` streams: ``step`` also takes its draws as arguments
(the parity tests feed JAX's in), DDIM at eta 0 draws none, and the losses
take t and the noise as arguments (``draw`` makes them).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from diffphycon_tpu_torch.device import resolve_device
from diffphycon_tpu_torch.diffusion import core
from diffphycon_tpu_torch.diffusion.core import DiffusionConstants
from diffphycon_tpu_torch.nets.init import seeded_init_
from diffphycon_tpu_torch.nets.unet2dv2 import ForceUNet, UNet2Dv2
from diffphycon_tpu_torch.nets.unet3d import UNet3D


@dataclasses.dataclass
class JellyfishConfig:
    dim: int = 64
    dim_mults: Sequence[int] = (1, 2, 4)
    frames: int = 20
    image_size: int = 64
    cond_steps: int = 1
    timesteps: int = 1000
    sampling_timesteps: int = 1000
    ddim_eta: float = 0.0
    beta_schedule: str = "linear"
    only_vis_pressure: bool = False
    w_prob_exp: float = 1.0
    standard_fixed_ratio: float = 0.01
    coeff_ratio_J: float = 0.3
    coeff_ratio_w: float = 0.3
    design_guidance: str = "standard"  # 'standard' | 'standard-alpha'
    use_guidance_in_model_predictions: bool = False
    reg_ratio: float = 0.0
    bf16: bool = False
    remat_all: bool = False  # recompute every UNet3D block in the backward

    @property
    def n_state(self) -> int:
        return 1 if self.only_vis_pressure else 3

    @property
    def joint_channels(self) -> int:  # state + bd (3) + theta (1)
        return self.n_state + 4

    @property
    def joint_out(self) -> int:  # the denoised subset: state + theta
        return self.n_state + 1


def _place(net: torch.nn.Module, seed: Optional[int], device) -> torch.nn.Module:
    """``net`` with seeded random weights when ``seed`` is given, in eval
    mode on ``device`` (default CUDA, see resolve_device)."""
    dev = resolve_device(device)
    if seed is not None:
        seeded_init_(net, torch.Generator().manual_seed(seed))
    return net.to(dev).eval()


def _unet3d(cfg: JellyfishConfig, out_dim: int) -> UNet3D:
    """``bf16``: the UNet3D computes in bfloat16 (flax ``dtype=bf16``) on
    float32 parameters; the surrogates stay float32, as in JAX."""
    return UNet3D(dim=cfg.dim, dim_mults=tuple(cfg.dim_mults), channels=cfg.joint_channels,
                  out_dim=out_dim, remat_all=cfg.remat_all,
                  dtype=torch.bfloat16 if cfg.bf16 else torch.float32)


def build_joint_unet(cfg: JellyfishConfig, seed=None, device=None) -> UNet3D:
    """The EBM joint model, 7 -> 4 channels."""
    return _place(_unet3d(cfg, cfg.joint_out), seed, device)


def build_thetas_unet(cfg: JellyfishConfig, seed=None, device=None) -> UNet3D:
    """The prior (thetas) model, 7 -> 1 channel."""
    return _place(_unet3d(cfg, 1), seed, device)


# the surrogates' widths, as the JAX builders fix them: dim = image_size
SURROGATE_DIM_MULTS = (1, 2, 4, 8)


def build_bd_updater(cfg: JellyfishConfig, seed=None, device=None) -> UNet2Dv2:
    """Boundary updater, 3 -> 3 channels, theta-delta through the time MLP."""
    return _place(UNet2Dv2(dim=cfg.image_size, out_dim=3, dim_mults=SURROGATE_DIM_MULTS,
                           channels=3), seed, device)


def build_force_unet(cfg: JellyfishConfig, seed=None, device=None) -> ForceUNet:
    """Force readout, (pressure, bd) 4 channels -> 1."""
    return _place(ForceUNet(dim=cfg.image_size, out_dim=1, dim_mults=SURROGATE_DIM_MULTS,
                            channels=4), seed, device)


def build_simulator_unet(cfg: JellyfishConfig, seed=None, device=None) -> UNet2Dv2:
    """Neural simulator, (state, bd) -> next state, theta-delta through the
    time MLP."""
    return _place(UNet2Dv2(dim=cfg.image_size, out_dim=cfg.n_state,
                           dim_mults=SURROGATE_DIM_MULTS, channels=cfg.n_state + 3),
                  seed, device)


def _frame_mask(x, f0: int, f1: int):
    """(1, F, 1, ..., 1) mask of frames [f0, f1) of x (B, F, ...)."""
    ff = torch.arange(x.shape[1], device=x.device)
    m = ((ff >= f0) & (ff < f1)).to(x.dtype)
    return m.reshape((1, -1) + (1,) * (x.dim() - 2))


def _pin_frames(x, value, f0: int, f1: int):
    """x with frames [f0, f1) replaced by (broadcastable) value."""
    m = _frame_mask(x, f0, f1)
    return x * (1 - m) + value * m


def _ex(a: torch.Tensor, t, ndim: int = 5):
    """a[t] shaped for an ndim tensor, (B, F, H, W, C) by default (t (B,) or
    an int). An int t gives a (1,) * ndim tensor, which, like JAX's float32
    coefficients, promotes a bfloat16 model output to float32."""
    if isinstance(t, int):
        return a[t].reshape((1,) * ndim)
    return a[t].reshape((-1,) + (1,) * (ndim - 1))


@dataclasses.dataclass
class _Cond:
    """The per-batch conditioning of one sampling run."""

    state_0: torch.Tensor      # (B, H, W, ns)
    bd_0: torch.Tensor         # (B, H, W, 3)
    thetas_0: torch.Tensor     # (B,)
    thetas_0_expand: torch.Tensor  # (B, 1, H, W, 1)
    bd_0_expand: torch.Tensor      # (B, F, H, W, 3)
    state_cond: torch.Tensor       # (B, F, H, W, ns)


class JellyfishDiffusion:
    """Two-model jellyfish diffusion with the boundary updater in the loop.

    Args:
      cfg: JellyfishConfig.
      joint_model: fn(x7 (B, F, H, W, 7), t (B,)) -> eps over [state, theta].
      thetas_model: fn(x7, t) -> eps over theta (1 channel).
      bd_updater: fn(bd (N, H, W, 3), theta_delta (N,)) -> bd'.
      device: where the schedule buffers live (default CUDA).
    """

    def __init__(self, cfg: JellyfishConfig, joint_model: Callable,
                 thetas_model: Optional[Callable] = None,
                 bd_updater: Optional[Callable] = None, device=None):
        self.cfg = cfg
        self.joint_model = joint_model
        self.thetas_model = thetas_model
        self.bd_updater = bd_updater
        self.consts = DiffusionConstants.create(cfg.timesteps, cfg.beta_schedule, device=device)

    # -- training losses ----------------------------------------------------

    def q_sample(self, x0, t, noise):
        c = self.consts
        nd = x0.ndim
        return (_ex(c.sqrt_alphas_cumprod, t, nd) * x0
                + _ex(c.sqrt_one_minus_alphas_cumprod, t, nd) * noise)

    def p_losses_states(self, state0, bd0, thetas0, t, noise):
        """EBM loss of the joint (states) model: the energy -sum(model(x)^2)
        has a gradient with respect to the noisy state that must match the
        noise (double backward: differentiable in the model's parameters).

        state0: (B, F, H, W, ns); bd0: (B, F, H, W, 3); thetas0: (B, F);
        t: (B,) int; noise: like state0."""
        cs = self.cfg.cond_steps
        h = state0.shape[2]
        theta_plane = thetas0[:, :, None, None, None].expand(*state0.shape[:2], h, h, 1)
        state = self.q_sample(state0, t, noise)
        if cs > 0:
            state = _pin_frames(state, state0, 0, cs)
            noise = noise * (1 - _frame_mask(noise, 0, cs))
        with torch.enable_grad():
            state = state.detach().requires_grad_(True)
            out = self.joint_model(torch.cat([state, bd0, theta_plane], dim=-1),
                                   t.to(torch.float32))
            (state_grad,) = torch.autograd.grad(-(out ** 2).sum(), state, create_graph=True)
        return ((state_grad - noise) ** 2).mean()

    def p_losses_thetas(self, state0, bd0, thetas0, t, noise_bd, noise_th):
        """eps-matching of the prior (thetas) model conditioned on state0.
        noise_bd: like bd0; noise_th: (B, F, H, W, 1)."""
        cs = self.cfg.cond_steps
        b, f = thetas0.shape
        h = state0.shape[2]
        theta_plane = thetas0[:, :, None, None, None].expand(b, f, h, h, 1)
        bd = self.q_sample(bd0, t, noise_bd)
        theta = self.q_sample(theta_plane, t, noise_th)
        if cs > 0:
            state_cond = state0[:, :1].expand(state0.shape)
            bd = _pin_frames(bd, bd0, 0, cs)
            noise_th = noise_th * (1 - _frame_mask(noise_th, 0, cs))
            noise_th = noise_th * (1 - _frame_mask(noise_th, f - cs, f))
        else:
            state_cond = state0
        out = self.thetas_model(torch.cat([state_cond, bd, theta], dim=-1), t.to(torch.float32))
        return ((out - noise_th) ** 2).mean()

    def draw(self, batch, generator: torch.Generator, model_type: str):
        """(t (B,), noise tuple) of one loss call: the state noise for
        "states", the bd and theta-plane noises for "thetas"."""
        state0, bd0, thetas0 = batch
        b, f = thetas0.shape
        t = torch.randint(0, self.cfg.timesteps, (b,), generator=generator,
                          device=state0.device)

        def randn(*shape):
            return torch.randn(*shape, generator=generator, device=state0.device)

        if model_type == "states":
            return t, (randn(*state0.shape),)
        if model_type == "thetas":
            h = state0.shape[2]
            return t, (randn(*bd0.shape), randn(b, f, h, h, 1))
        raise ValueError(model_type)

    def loss(self, batch, t, noise: tuple, model_type: str):
        """p_losses_states or p_losses_thetas of batch (state0, bd0, thetas0)
        at the draws of :meth:`draw`."""
        if model_type == "states":
            return self.p_losses_states(*batch, t, *noise)
        if model_type == "thetas":
            return self.p_losses_thetas(*batch, t, *noise)
        raise ValueError(model_type)

    # -- sampling -----------------------------------------------------------

    def _update_bd(self, theta_expand, bd_0_expand, thetas_0):
        """The boundary at each frame from its theta: bd-updater(bd_0,
        theta - theta_0). theta_expand (B, F, H, W, 1); bd_0_expand (B, F, H,
        W, 3); thetas_0 (B,)."""
        b, f, h, w, _ = bd_0_expand.shape
        delta = (theta_expand.mean(dim=(2, 3))[..., 0] - thetas_0[:, None]).reshape(b * f)
        out = self.bd_updater(bd_0_expand.reshape(b * f, h, w, 3), delta)
        return out.reshape(b, f, h, w, 3)

    def _cond(self, state_0, bd_0, thetas_0) -> _Cond:
        cfg = self.cfg
        b, f, h = state_0.shape[0], cfg.frames, cfg.image_size
        return _Cond(state_0, bd_0, thetas_0,
                     thetas_0[:, None, None, None, None].expand(b, 1, h, h, 1),
                     bd_0[:, None].expand(b, f, h, h, 3),
                     state_0[:, None].expand(b, f, h, h, cfg.n_state))

    def sample_init(self, state_0, bd_0, thetas_0, generator=None, noise=None):
        """x_T (B, F, H, W, 7) with the conditioned frames pinned. noise:
        (state, bd, theta-plane) draws, else drawn from ``generator``."""
        cfg = self.cfg
        b, f, h, ns, cs = state_0.shape[0], cfg.frames, cfg.image_size, cfg.n_state, cfg.cond_steps
        if noise is None:
            noise = tuple(torch.randn(b, f, h, h, c, generator=generator, device=state_0.device)
                          for c in (ns, 3, 1))
        noise_state, noise_bd, noise_th = noise
        th0 = thetas_0[:, None, None, None, None].expand(b, 1, h, h, 1)
        if cs > 0:
            noise_state = _pin_frames(noise_state, state_0[:, None], 0, cs)
            noise_bd = _pin_frames(noise_bd, bd_0[:, None], 0, cs)
            noise_th = _pin_frames(noise_th, th0, 0, cs)
            noise_th = _pin_frames(noise_th, th0, f - cs, f)
        return torch.cat([noise_state, noise_bd, noise_th], dim=-1)

    def sample_ts(self) -> list:
        """The denoise steps: DDPM t = T-1 .. 0, or DDIM (t, t_next) pairs
        (t_next -1 at the last)."""
        cfg = self.cfg
        if cfg.sampling_timesteps >= cfg.timesteps:
            return list(range(cfg.timesteps - 1, -1, -1))
        times = np.linspace(-1, cfg.timesteps - 1, cfg.sampling_timesteps + 1).astype(int)
        times = list(reversed(times.tolist()))
        return list(zip(times[:-1], times[1:]))

    def _guidance(self, g, eps_w, t: int, inside: bool):
        """The guidance term: "standard" sfr * g + (w - 1) * eps_w inside the
        model prediction, sfr * (g - eps_w) after the DDPM update;
        "standard-alpha" the schedules eta_J(t) g - eta_w(t) eps_w."""
        cfg, sfr = self.cfg, self.cfg.standard_fixed_ratio
        if cfg.design_guidance == "standard":
            return sfr * g + (cfg.w_prob_exp - 1.0) * eps_w if inside else sfr * g - sfr * eps_w
        flipped = torch.flip(self.consts.betas, (0,))[t]
        return cfg.coeff_ratio_J * flipped * g - cfg.coeff_ratio_w * flipped * eps_w

    def _model_predictions(self, x, t: int, cond: _Cond, design_fn, inside: bool):
        """(eps, eps_w, x_start, x4): the joint eps (with the guidance term
        when ``inside``), the prior eps zero-embedded on the state channels,
        x_start from the unguided eps, and x's [state, theta] channels."""
        ns = self.cfg.n_state
        tb = torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)
        x_w = torch.cat([cond.state_cond, x[..., ns:]], dim=-1)
        eps, eps_w1 = core.two_forwards(self.joint_model, x, self.thetas_model, x_w, tb)
        x4 = torch.cat([x[..., :ns], x[..., -1:]], dim=-1)
        x_start = self.predict_start_from_noise(x4, t, eps)
        eps_w = torch.cat([torch.zeros_like(x4[..., :ns]), eps_w1], dim=-1)
        if inside:
            g = design_fn(x_start, cond.bd_0_expand) if design_fn is not None else 0.0
            eps = eps + self._guidance(g, eps_w, t, inside=True)
        return eps, eps_w, x_start, x4

    def _postprocess(self, pred4, t: int, cond: _Cond, repaint_noise=None, generator=None):
        """Split [state, theta], recompute the boundary, re-pin the
        conditions (or, with cond_steps 0, pin frame 0 and the last theta to
        the conditions noised to t: repaint)."""
        cfg = self.cfg
        ns, cs, f = cfg.n_state, cfg.cond_steps, cfg.frames
        pred_states, pred_theta = pred4[..., :ns], pred4[..., ns:]
        pred_bd = self._update_bd(pred_theta, cond.bd_0_expand, cond.thetas_0)
        th0 = cond.thetas_0_expand
        if cs > 0:
            pred_states = _pin_frames(pred_states, cond.state_0[:, None], 0, cs)
            pred_bd = _pin_frames(pred_bd, cond.bd_0[:, None], 0, cs)
            pred_bd = _pin_frames(pred_bd, cond.bd_0[:, None], f - cs, f)
            pred_theta = _pin_frames(pred_theta, th0, 0, cs)
            pred_theta = _pin_frames(pred_theta, th0, f - cs, f)
        else:
            if repaint_noise is None:
                repaint_noise = tuple(torch.randn(a.shape, generator=generator, device=a.device)
                                      for a in (cond.state_0, cond.bd_0, th0))
            ns_, nb_, nt_ = repaint_noise
            s0t = self.q_sample(cond.state_0, t, ns_)[:, None]
            b0t = self.q_sample(cond.bd_0, t, nb_)[:, None]
            th0t = self.q_sample(th0, t, nt_)
            pred_states = _pin_frames(pred_states, s0t, 0, 1)
            pred_bd = _pin_frames(pred_bd, b0t, 0, 1)
            pred_theta = _pin_frames(pred_theta, th0t, 0, 1)
            pred_theta = _pin_frames(pred_theta, th0t, f - 1, f)
        return torch.cat([pred_states, pred_bd, pred_theta], dim=-1)

    @torch.no_grad()
    def step(self, x, ts, cond: _Cond, design_fn: Optional[Callable] = None,
             generator: Optional[torch.Generator] = None, noise=None, repaint_noise=None):
        """One denoise step on x (B, F, H, W, 7): ts is t (DDPM) or (t,
        t_next) (DDIM). noise: the posterior (DDPM) or eta (DDIM) draw,
        (B, F, H, W, ns + 1); repaint_noise: (state, bd, theta) draws of the
        repaint conditions; either drawn from ``generator`` when None."""
        cfg = self.cfg
        c = self.consts
        if isinstance(ts, tuple):  # DDIM: in-model guidance always
            t, tn = ts
            eps, _, x_start, x4 = self._model_predictions(x, t, cond, design_fn, True)
            alpha = c.alphas_cumprod[t]
            alpha_next = c.alphas_cumprod[tn] if tn >= 0 else torch.ones_like(alpha)
            sigma = cfg.ddim_eta * torch.sqrt(torch.clamp(
                (1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha), min=0.0))
            coef = torch.sqrt(torch.clamp(1 - alpha_next - sigma ** 2, min=0.0))
            if tn < 0:
                pred = x_start
            else:
                pred = x_start * torch.sqrt(alpha_next) + coef * eps
                if cfg.ddim_eta > 0:
                    if noise is None:
                        noise = torch.randn(x4.shape, generator=generator, device=x.device)
                    pred = pred + sigma * noise
        else:
            t = ts
            inside = cfg.use_guidance_in_model_predictions
            eps, eps_w, x_start, x4 = self._model_predictions(x, t, cond, design_fn, inside)
            x_start = x_start.clamp(-1.0, 1.0)
            mean, log_var = self.q_posterior(x_start, x4, t)
            pred = mean
            if t > 0:
                if noise is None:
                    noise = torch.randn(x4.shape, generator=generator, device=x.device)
                pred = mean + torch.exp(0.5 * log_var) * noise
            if not inside and design_fn is not None:
                pred = pred - self._guidance(design_fn(x_start, cond.bd_0_expand), eps_w, t,
                                             inside=False)
        return self._postprocess(pred, t, cond, repaint_noise, generator)

    def sample_chunk(self, x, ts: list, state_0, bd_0, thetas_0,
                     design_fn: Optional[Callable] = None,
                     generator: Optional[torch.Generator] = None):
        """Run the denoise steps ``ts`` (a slice of :meth:`sample_ts`) on x.
        Chunks run in turn with one generator give :meth:`sample`'s
        result."""
        cond = self._cond(state_0, bd_0, thetas_0)
        for ts_i in ts:
            x = self.step(x, ts_i, cond, design_fn, generator)
        return x

    def sample(self, state_0, bd_0, thetas_0, design_fn: Optional[Callable] = None,
               generator: Optional[torch.Generator] = None):
        """Guided sampling. state_0 (B, H, W, ns); bd_0 (B, H, W, 3);
        thetas_0 (B,); design_fn(x_start4, bd_0_expand) -> the guidance
        gradient (B, F, H, W, ns + 1). Returns (pred_states (B, F, H, W,
        ns), pred_theta (B, F))."""
        x = self.sample_init(state_0, bd_0, thetas_0, generator)
        x = self.sample_chunk(x, self.sample_ts(), state_0, bd_0, thetas_0, design_fn,
                              generator)
        return self.sample_finalize(x)

    def sample_finalize(self, x):
        ns = self.cfg.n_state
        return x[..., :ns], x[..., -1:].mean(dim=(2, 3))[..., 0]

    def predict_start_from_noise(self, x_t, t, noise):
        c = self.consts
        return _ex(c.sqrt_recip_alphas_cumprod, t) * x_t - _ex(c.sqrt_recipm1_alphas_cumprod, t) * noise

    def q_posterior(self, x_start, x_t, t):
        c = self.consts
        mean = _ex(c.posterior_mean_coef1, t) * x_start + _ex(c.posterior_mean_coef2, t) * x_t
        return mean, _ex(c.posterior_log_variance_clipped, t)


# ---------------------------------------------------------------------------
# guidance (reference force_fn, inference_2d_jellyfish.py:85-114)
# ---------------------------------------------------------------------------


def reg_theta(theta):
    """sum_t (theta_{t+1} - theta_t)^2 per sample."""
    return ((theta[:, 1:] - theta[:, :-1]) ** 2).sum(dim=1)


def _denorm_pressure(p, p_min: float, p_max: float):
    return (0.5 * p + 0.5) * (p_max - p_min) + p_min


def make_force_design_fn(cfg: JellyfishConfig, force_model: Callable, bd_updater: Callable,
                         p_min: float, p_max: float):
    """design_fn(x_start4, bd_0_expand) -> (B, F, H, W, ns + 1): the
    gradient of J = sum(-(time-weighted mean thrust) + reg_ratio * sum
    dtheta^2) with respect to the state and the theta plane. The thrust is
    the ForceUNet on (denormalised pressure, bd-updater(bd_0, theta)). It
    runs under ``torch.enable_grad()`` on detached leaves (the sampler is
    no-grad) and returns a detached tensor."""
    ns = cfg.n_state

    def guidance_scalar(state, theta_expand, bd_0_expand):
        b, f, h, w = state.shape[:4]
        theta = theta_expand.mean(dim=(2, 3))  # (B, F)
        pressure = _denorm_pressure(state[..., ns - 1], p_min, p_max)
        pred_bd = bd_updater(bd_0_expand.reshape(b * f, h, w, 3), theta.reshape(b * f))
        inp = torch.cat([pressure.reshape(b * f, h, w, 1), pred_bd], dim=-1)
        force = force_model(inp).reshape(b, f)
        weight = torch.arange(f, 0, -1, dtype=torch.float32, device=state.device)[None]
        avg_v = (force * weight).mean(dim=1)
        return (-avg_v + cfg.reg_ratio * reg_theta(theta)).sum()

    def design_fn(x_start4, bd_0_expand):
        with torch.enable_grad():
            state = x_start4[..., :ns].detach().requires_grad_(True)
            theta_expand = x_start4[..., ns].detach().requires_grad_(True)
            g_state, g_theta = torch.autograd.grad(
                guidance_scalar(state, theta_expand, bd_0_expand.detach()),
                (state, theta_expand))
        return torch.cat([g_state, g_theta[..., None]], dim=-1).detach()

    return design_fn


# ---------------------------------------------------------------------------
# closed-loop surrogate pipeline (reference inference/sim_ppl_2d.py:20-107)
# ---------------------------------------------------------------------------


class SurrogatePipeline:
    """Neural "simulator": force readout, next-state prediction and boundary
    update, for closed-loop scoring. The ForceUNet is trained on RAW
    pressure while the states are normalised to [-1, 1], so ``p_min`` /
    ``p_max`` denormalise the pressure channel before the readout (None:
    pass it through)."""

    def __init__(self, cfg: JellyfishConfig, simulator: Callable, force_model: Callable,
                 bd_updater: Callable, p_min=None, p_max=None):
        self.cfg = cfg
        self.simulator = simulator
        self.force_model = force_model
        self.bd_updater = bd_updater
        self.p_min, self.p_max = p_min, p_max

    def step(self, state, mask_offsets, theta_delta=None):
        """state (B, H, W, ns); mask_offsets (B, H, W, 3); theta_delta (B,)
        or None. Returns (states_next, force_x), or force_x without a
        delta. Differentiable (MPC plans through it); scoring callers run
        it under ``torch.no_grad()``."""
        pressure = state[..., -1:]
        if self.p_min is not None:
            pressure = _denorm_pressure(pressure, self.p_min, self.p_max)
        force = self.force_model(torch.cat([pressure, mask_offsets], dim=-1))[:, 0]
        if theta_delta is None:
            return force
        states_next = self.simulator(torch.cat([state, mask_offsets], dim=-1), theta_delta)
        return states_next, force

    def rollout(self, state_0, bd_0, thetas):
        """Closed loop over a theta schedule. state_0 (B, H, W, ns); bd_0 (B,
        H, W, 3); thetas (B, F). Returns (states (B, F, H, W, ns), forces
        (B, F))."""
        deltas = thetas[:, 1:] - thetas[:, :-1]
        state, bd = state_0, bd_0
        states, forces = [], []
        for i in range(deltas.shape[1]):
            d = deltas[:, i]
            states_next, force = self.step(state, bd, d)
            states.append(state)
            forces.append(force)
            state, bd = states_next, self.bd_updater(bd, d)
        states.append(state)
        forces.append(self.step(state, bd))
        return torch.stack(states, dim=1), torch.stack(forces, dim=1)
