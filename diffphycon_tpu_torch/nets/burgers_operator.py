"""1D Burgers latent surrogate operator.

Port of ``diffphycon_tpu/nets/burgers_operator.py``: encoder/decoder pairs
for the force (``NetF``) and the state (``NetU``), a latent transition
(``NetTrans``), and ``SurrogateOperator``, which steps u forward one control
frame: u_{t+1} = decode_u(trans(cat(enc_u(u_t), enc_f(f_t)))).

Channels-first ``nn.Conv1d`` stacks on (B, 1, Nx). The latent is the
(B, 8, h/4) feature map flattened channel-major, as the reference torch
nets flatten it (the JAX package transposes its channels-last map to get
the same order). Fields are scaled by RESCALER = 6.4519. Used by the SL
baseline and trained by ``apps/train_burgers_operator.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from diffphycon_tpu_torch.device import fp32_convs, resolve_device
from diffphycon_tpu_torch.nets.init import seeded_init_

RESCALER = 6.4519


def _upsample_linear_1d(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2, mode='linear', align_corners=True) on
    (B, C, N)."""
    return F.interpolate(x, scale_factor=2, mode="linear", align_corners=True)


class _Coder(nn.Module):
    """Encoder/decoder stack (reference Net_f_ELU / Net_u_ELU) at full
    resolution ``h``; ELU (or tanh) activations."""

    def __init__(self, h: int, act: str = "elu"):
        super().__init__()
        self.h = h
        self.act = F.elu if act == "elu" else torch.tanh
        h4 = h // 4
        self.down0 = nn.Conv1d(1, 8, 5, padding=2)
        self.down1 = nn.Conv1d(8, 16, 5, stride=2, padding=2)
        self.down2 = nn.Conv1d(16, 32, 5, stride=2, padding=2)
        self.down3 = nn.Conv1d(32, 8, 5, padding=2)
        self.down_fc = nn.Linear(8 * h4, 8 * h4)
        self.up0 = nn.Conv1d(8, 64, 5, padding=2)
        self.up1 = nn.Conv1d(64, 32, 5, padding=2)
        self.up2 = nn.Conv1d(32, 16, 5, padding=2)
        self.up3 = nn.Conv1d(16, 1, 5, padding=2)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, h) -> latent (B, 8 * h/4), channel-major."""
        fp32_convs()
        a = self.act
        x = a(self.down0(x))
        x = a(self.down1(x))
        x = a(self.down2(x))
        x = a(self.down3(x))
        return self.down_fc(x.flatten(1))

    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        """latent (B, 8 * h/4) -> (B, 1, h)."""
        fp32_convs()
        a = self.act
        x = latent.reshape(latent.shape[0], 8, self.h // 4)
        x = a(self.up0(x))
        x = a(self.up1(x))
        x = a(self.up2(_upsample_linear_1d(x)))
        return self.up3(_upsample_linear_1d(x))

    def forward(self, x: torch.Tensor):
        """(reconstruction (B, 1, h), latent (B, 8 * h/4))."""
        latent = self.encode(x)
        return self.decode(latent), latent


class NetF(_Coder):
    pass


class NetU(_Coder):
    pass


class NetTrans(nn.Module):
    """Latent transition: Conv1d(16 -> 8, k3) over the u latent stacked on
    the f latent, (B, 16, h/4) -> (B, 8, h/4) (reference Net_trans)."""

    def __init__(self):
        super().__init__()
        self.transition1 = nn.Conv1d(16, 8, 3, padding=1)

    def forward(self, latent_cat: torch.Tensor) -> torch.Tensor:
        fp32_convs()
        return self.transition1(latent_cat)


def transition(net_f: NetF, net_u: NetU, net_trans: NetTrans, u: torch.Tensor,
               f: torch.Tensor):
    """The latent step on scaled fields u (B, 1, s_ob), f (B, 1, s):
    returns (f_rec, u_rec, next latent (B, 8 * s_ob/4)). A force latent
    longer than the state's (partial observation) is folded onto it by
    adding its two halves."""
    f_rec, f_lat = net_f(f)
    u_rec, u_lat = net_u(u)
    n = u_lat.shape[-1]
    if n < f_lat.shape[-1]:
        f_lat = f_lat[:, :n] + f_lat[:, n:]
    h4 = n // 8
    cat = torch.cat([u_lat.reshape(-1, 8, h4), f_lat.reshape(-1, 8, h4)], dim=1)
    return f_rec, u_rec, net_trans(cat).flatten(1)


class SurrogateOperator(nn.Module):
    """u_{t+1} = decode_u(trans(cat(enc_u(u_t), enc_f(f_t)))) (reference
    Simu_surrogate_model.simulation). ``s`` is the force resolution,
    ``s_ob`` the observed state resolution (64: the front/rear quarters).
    ``forward`` is :meth:`rollout`. Built in eval mode on ``device``
    (default CUDA, see resolve_device), with seeded random weights when
    ``seed`` is given."""

    def __init__(self, s: int = 128, s_ob: int = 128, seed: Optional[int] = None,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.s, self.s_ob = s, s_ob
        self.net_f = NetF(s)
        self.net_u = NetU(s_ob)
        self.net_trans = NetTrans()
        if seed is not None:
            seeded_init_(self, torch.Generator().manual_seed(seed))
        self.to(dev).eval()

    def simulate(self, ut: torch.Tensor, ft: torch.Tensor) -> torch.Tensor:
        """ut (B, s_ob), ft (B, s), unscaled -> u_{t+1} (B, s_ob)."""
        _, _, nxt = transition(self.net_f, self.net_u, self.net_trans,
                               (ut / RESCALER)[:, None], (ft / RESCALER)[:, None])
        return self.net_u.decode(nxt)[:, 0] * RESCALER

    def rollout(self, u0: torch.Tensor, f_seq: torch.Tensor) -> torch.Tensor:
        """u0 (B, s_ob); f_seq (B, Nt, s) -> (B, Nt + 1, s_ob)."""
        us = [u0]
        for t in range(f_seq.shape[1]):
            us.append(self.simulate(us[-1], f_seq[:, t]))
        return torch.stack(us, dim=1)

    def forward(self, u0: torch.Tensor, f_seq: torch.Tensor) -> torch.Tensor:
        return self.rollout(u0, f_seq)
