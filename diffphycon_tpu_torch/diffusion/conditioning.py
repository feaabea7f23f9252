"""Burgers and smoke conditioning specs (port of
``diffphycon_tpu/diffusion/conditioning.py``): the Burgers spec carries the
sampling side and the training masks; the smoke spec the sampling side.

Burgers x is (B, 16, 128, 2) channels-last: channel 0 = u (11 valid rows +
padding), channel 1 = f (10 valid rows). Smoke x is (B, 32, 64, 64, 6):
density, vx, vy, c1, c2, smoke portion. Masks are built as in the JAX
package, so the arithmetic (``x * (1 - m) + v * m``) is the same.
"""

from __future__ import annotations

import torch

from diffphycon_tpu_torch.diffusion.core import CondSpec


def _time_chan_mask(x, t_idx: int, chan: int):
    """(1, T, 1, C) mask: 1 where (time == t_idx and channel == chan)."""
    m_t = (torch.arange(x.shape[1], device=x.device) == t_idx).to(x.dtype)
    m_c = (torch.arange(x.shape[-1], device=x.device) == chan).to(x.dtype)
    return m_t[None, :, None, None] * m_c[None, None, None, :]


def _timerange_chan_mask(x, t0: int, t1: int, chan: int):
    tt = torch.arange(x.shape[1], device=x.device)
    m_t = ((tt >= t0) & (tt < t1)).to(x.dtype)
    m_c = (torch.arange(x.shape[-1], device=x.device) == chan).to(x.dtype)
    return m_t[None, :, None, None] * m_c[None, None, None, :]


def _quarter_mask_x(x):
    """(X,) mask of the unobserved middle half nx/4 <= x < 3nx/4."""
    nx = x.shape[2]
    xx = torch.arange(nx, device=x.device)
    return ((xx >= nx // 4) & (xx < (3 * nx) // 4)).to(x.dtype)


def _chan_mask(x, chan: int):
    return (torch.arange(x.shape[-1], device=x.device) == chan).to(x.dtype)


def burgers_cond_spec(*, is_condition_u0: bool = False, is_condition_uT: bool = False,
                      is_condition_u0_zero_pred_noise: bool = True,
                      is_condition_uT_zero_pred_noise: bool = True,
                      condition_idx: int = 10, is_model_w: bool = False,
                      train_on_partially_observed=None,
                      set_unobserved_to_zero_during_sampling: bool = False,
                      train_on_padded_locations: bool = True) -> CondSpec:
    """Conditioning of the Burgers joint/prior DDPMs, sampling and training.
    ``train_on_padded_locations=True`` keeps the reference's "faulty"
    default of also training on the zero-padded rows."""
    ci = condition_idx

    def pin(x, cond):
        if is_condition_u0:
            m = _time_chan_mask(x, 0, 0)
            x = x * (1 - m) + cond["u0"][:, None, :, None] * m
        if is_condition_uT:
            m = _time_chan_mask(x, ci, 0)
            x = x * (1 - m) + cond["uT"][:, None, :, None] * m
        return x

    def w_zero_input(x, cond):
        # p(w) never sees u_[1..T-1]
        return x * (1 - _timerange_chan_mask(x, 1, ci, 0))

    def w_zero_output(out, cond):
        # p(w) only outputs w, never u
        keep = (torch.arange(out.shape[-1], device=out.device) != 0).to(out.dtype)
        return out * keep[None, None, None, :]

    def sampling_mask(x, cond):
        if set_unobserved_to_zero_during_sampling:
            m = _quarter_mask_x(x)[None, None, :, None] * _chan_mask(x, 0)[None, None, None, :]
            x = x * (1 - m)
        return x

    def zero_target(target, cond):
        if is_condition_u0 and is_condition_u0_zero_pred_noise:
            target = target * (1 - _time_chan_mask(target, 0, 0))
        if is_condition_uT and is_condition_uT_zero_pred_noise:
            target = target * (1 - _time_chan_mask(target, ci, 0))
        return target

    def loss_mask_pre(model_out, target, cond):
        if train_on_partially_observed is None:
            return model_out
        m_x = _quarter_mask_x(model_out)[None, None, :, None]
        if train_on_partially_observed == "front_rear_quarter":
            m = m_x * _chan_mask(model_out, 0)[None, None, None, :]
        elif train_on_partially_observed == "front_rear_quarter_u_and_f":
            m = m_x  # the reference's faulty variant masks both channels
        else:
            raise NotImplementedError(train_on_partially_observed)
        return model_out * (1 - m) + target * m

    def loss_mask_post(model_out, target, cond):
        if is_model_w:  # no loss on the u channel
            m = _chan_mask(model_out, 0)[None, None, None, :]
            model_out = model_out * (1 - m) + target * m
        if not train_on_padded_locations:  # no loss on the padded rows
            t_len = model_out.shape[1]
            m = torch.clamp(_timerange_chan_mask(model_out, ci + 1, t_len, 0)
                            + _timerange_chan_mask(model_out, ci, t_len, 1), 0, 1)
            model_out = model_out * (1 - m) + target * m
        return model_out

    return CondSpec(pin=pin, zero_target=zero_target, w_zero_input=w_zero_input,
                    w_zero_output=w_zero_output, sampling_mask=sampling_mask,
                    loss_mask_pre=loss_mask_pre, loss_mask_post=loss_mask_post)


def burgers_derive_cond(x_start):
    """{u0, uT}: rows 0 and 10 of u in a clean batch (B, 16, 128, 2)."""
    return {"u0": x_start[:, 0, :, 0], "uT": x_start[:, 10, :, 0]}


def _frame_chan_mask5(x, f_idx: int, chan: int):
    """(1, F, 1, 1, C) mask of a video tensor: 1 at (frame f_idx, chan)."""
    m_f = (torch.arange(x.shape[1], device=x.device) == f_idx).to(x.dtype)
    m_c = (torch.arange(x.shape[-1], device=x.device) == chan).to(x.dtype)
    return m_f[None, :, None, None, None] * m_c[None, None, None, None, :]


def smoke_cond_spec() -> CondSpec:
    """Sampling-side conditioning of the smoke video DDPMs: the frame-0
    density is pinned every step; the prior (w) model sees channels 3:5
    (c1, c2) of the joint tensor and its output is zero-embedded back."""

    def pin(x, cond):
        if "init" in cond:
            m = _frame_chan_mask5(x, 0, 0)
            x = x * (1 - m) + cond["init"][:, None, :, :, None] * m
        return x

    def w_slice_input(x, cond):
        return x[..., 3:5]

    def w_embed_output(out_w, cond):
        z3 = out_w.new_zeros(out_w.shape[:-1] + (3,))
        z1 = out_w.new_zeros(out_w.shape[:-1] + (1,))
        return torch.cat([z3, out_w, z1], dim=-1)

    return CondSpec(pin=pin, w_zero_input=w_slice_input, w_zero_output=w_embed_output)


def smoke_derive_cond(x_start):
    """{init}: the frame-0 density of a clean batch (B, 32, 64, 64, C)."""
    return {"init": x_start[:, 0, :, :, 0]}


def get_proj_ep_orthogonal(norm: str = "F"):
    """Orthogonal-projection guidance combiner eps + g - <g, eps> eps/||eps||
    (reference get_proj_ep_orthogonal_func), channels-last axes: F over
    (T, X) with a global numerator, 1D_x over X, 1D_t over T."""
    if norm == "F":
        def proj(ep, g):
            num = (g * ep).sum()
            den = torch.sqrt(ep.square().sum(dim=(1, 2), keepdim=True))
            return ep + g - num * ep / den
    elif norm in ("1D_x", "1D_t"):
        axis = 2 if norm == "1D_x" else 1

        def proj(ep, g):
            num = (g * ep).sum(dim=axis, keepdim=True)
            den = torch.sqrt(ep.square().sum(dim=axis, keepdim=True))
            return ep + g - num * ep / den
    else:
        raise NotImplementedError(f"unknown proj norm {norm!r}")
    return proj
