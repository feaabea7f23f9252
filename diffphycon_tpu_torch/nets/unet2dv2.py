"""Image U-Net of the jellyfish auxiliary models, (B, H, W, C) at the
boundary.

Port of ``diffphycon_tpu/nets/unet2dv2.py``: ``UNet2Dv2`` (the boundary
updater and the neural simulator; its "time" input is the float theta-delta
there) and ``ForceUNet`` (the encoder-only thrust readout: down path, mid
blocks, a spatial mean and a linear head). They differ from the Burgers
UNet2D in three places, each a numerical trap:

- ``WSConv2d`` standardises each output channel's 3x3 kernel over
  (in, kh, kw) with the population variance and eps 1e-5, in float32;
- ``LinearAttentionV2`` divides v by the token count and ends in a channel
  LayerNorm;
- GroupNorm has 8 groups by default.

Module and parameter names follow the reference 2D ``Unet`` / ``ForceUnet``
state_dicts (the keys ``diffphycon_tpu/utils/torch_convert.py:
convert_unet2dv2`` reads). Inside, activations are torch's (B, C, H, W).
These nets ran through XLA in the JAX package (no Pallas kernel), so here
they are plain PyTorch on cuDNN in full float32 (TF32 off, forward and
backward: ``device.fp32_convs``); the UNet2D
kernels K1-K6 compute another block (groups 1, no weight standardisation,
no v/n) and are not used.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from diffphycon_tpu_torch.device import fp32_convs
from diffphycon_tpu_torch.nets.blocks import time_mlp

GN_EPS = 1e-5


class WSConv2d(nn.Conv2d):
    """Weight-standardised conv: each output channel's kernel minus its mean
    over (in, kh, kw), divided by sqrt(population variance + eps)."""

    def forward(self, x):
        w = self.weight
        eps = 1e-5 if x.dtype == torch.float32 else 1e-3
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = ((w - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True)
        w = (w - mean) * torch.rsqrt(var + eps)
        return F.conv2d(x, w, self.bias, self.stride, self.padding)


class LayerNorm(nn.Module):
    """Channel LayerNorm over dim 1, gain ``g`` stored (1, C, 1, 1), biased
    variance, eps 1e-5 in float32."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))

    def forward(self, x):
        eps = 1e-5 if x.dtype == torch.float32 else 1e-3
        mean = x.mean(dim=1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps) * self.g


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.norm = LayerNorm(dim)

    def forward(self, x):
        return self.fn(self.norm(x))


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return x + self.fn(x)


class Block(nn.Module):
    """WSConv2d 3x3 -> GroupNorm -> FiLM -> SiLU."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.proj = WSConv2d(dim, dim_out, 3, padding=1)
        self.norm = nn.GroupNorm(groups, dim_out, eps=GN_EPS)

    def forward(self, x, scale_shift=None):
        x = self.norm(self.proj(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        return F.silu(x)


class ResnetBlock(nn.Module):
    """Two Blocks, FiLM from the time embedding when ``time_emb_dim`` is
    given, and a 1x1 residual conv when the width changes."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: Optional[int] = None,
                 groups: int = 8):
        super().__init__()
        self.mlp = (nn.Sequential(nn.SiLU(), nn.Linear(time_emb_dim, dim_out * 2))
                    if time_emb_dim is not None else None)
        self.block1 = Block(dim, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups)
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x, time_emb=None):
        scale_shift = None
        if self.mlp is not None and time_emb is not None:
            scale_shift = self.mlp(time_emb)[:, :, None, None].chunk(2, dim=1)
        h = self.block2(self.block1(x, scale_shift))
        return h + self.res_conv(x)


class LinearAttentionV2(nn.Module):
    """Linear attention: q softmaxed over the head dim and scaled, k over
    tokens, v divided by the token count; out-projection then LayerNorm."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(nn.Conv2d(hidden, dim, 1), LayerNorm(dim))

    def forward(self, x):
        b, _, hs, ws = x.shape
        h, d, n = self.heads, self.dim_head, hs * ws
        q, k, v = self.to_qkv(x).reshape(b, 3, h, d, n).unbind(1)
        q = torch.softmax(q, dim=-2) * d ** -0.5
        k = torch.softmax(k, dim=-1)
        v = v / n
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q).reshape(b, h * d, hs, ws)
        return self.to_out(out)


class Attention(nn.Module):
    """Full softmax attention over all H*W tokens (softmax in float32)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        b, _, hs, ws = x.shape
        h, d, n = self.heads, self.dim_head, hs * ws
        q, k, v = self.to_qkv(x).reshape(b, 3, h, d, n).unbind(1)
        q = q * d ** -0.5
        sim = torch.einsum("bhdi,bhdj->bhij", q, k)
        attn = torch.softmax(sim.float(), dim=-1).to(sim.dtype)
        out = torch.einsum("bhij,bhdj->bhdi", attn, v).reshape(b, h * d, hs, ws)
        return self.to_out(out)


class SpaceToDepth(nn.Module):
    """(b, c, 2h, 2w) -> (b, 4c, h, w) in the (c p1 p2) channel order."""

    def forward(self, x):
        b, c, h2, w2 = x.shape
        x = x.reshape(b, c, h2 // 2, 2, w2 // 2, 2).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(b, c * 4, h2 // 2, w2 // 2)


def _downsample(dim: int, dim_out: int, last: bool) -> nn.Module:
    if last:
        return nn.Conv2d(dim, dim_out, 3, padding=1)
    return nn.Sequential(SpaceToDepth(), nn.Conv2d(dim * 4, dim_out, 1))


def _upsample(dim: int, dim_out: int, last: bool) -> nn.Module:
    if last:
        return nn.Conv2d(dim, dim_out, 3, padding=1)
    return nn.Sequential(nn.Upsample(scale_factor=2, mode="nearest"),
                         nn.Conv2d(dim, dim_out, 3, padding=1))


def _linear_attn(dim: int) -> nn.Module:
    return Residual(PreNorm(dim, LinearAttentionV2(dim)))


def _levels(dim: int, dim_mults: Sequence[int]):
    dims = [dim] + [dim * m for m in dim_mults]
    return list(zip(dims[:-1], dims[1:]))


def _nhwc_to_nchw(x):
    if x.dim() != 4:
        raise ValueError(f"expected (B, H, W, C), got {tuple(x.shape)}")
    return x.permute(0, 3, 1, 2)


class UNet2Dv2(nn.Module):
    """forward(x (B, H, W, C), time (B,)) -> (B, H, W, out_dim); ``time`` is
    a diffusion time or a float theta-delta."""

    def __init__(self, dim: int = 64, out_dim: Optional[int] = None,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), channels: int = 3,
                 resnet_block_groups: int = 8):
        super().__init__()
        self.channels = channels
        groups, time_dim = resnet_block_groups, dim * 4
        in_out = _levels(dim, dim_mults)
        self.init_conv = nn.Conv2d(channels, dim, 7, padding=3)
        self.time_mlp = time_mlp(dim, time_dim)
        self.downs = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(in_out):
            last = i == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ResnetBlock(d_in, d_in, time_dim, groups),
                ResnetBlock(d_in, d_in, time_dim, groups),
                _linear_attn(d_in),
                _downsample(d_in, d_out, last),
            ]))
        mid = in_out[-1][1]
        self.mid_block1 = ResnetBlock(mid, mid, time_dim, groups)
        self.mid_attn = Residual(PreNorm(mid, Attention(mid)))
        self.mid_block2 = ResnetBlock(mid, mid, time_dim, groups)
        self.ups = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(reversed(in_out)):
            last = i == len(in_out) - 1
            self.ups.append(nn.ModuleList([
                ResnetBlock(d_out + d_in, d_out, time_dim, groups),
                ResnetBlock(d_out + d_in, d_out, time_dim, groups),
                _linear_attn(d_out),
                _upsample(d_out, d_in, last),
            ]))
        self.final_res_block = ResnetBlock(dim * 2, dim, time_dim, groups)
        self.final_conv = nn.Conv2d(dim, out_dim or channels, 1)

    def forward(self, x, time):
        fp32_convs()
        return self._forward(_nhwc_to_nchw(x), time).permute(0, 2, 3, 1)

    def _forward(self, x, time):
        t = self.time_mlp(time)
        x = self.init_conv(x)
        r = x
        skips = []
        for block1, block2, attn, down in self.downs:
            x = block1(x, t)
            skips.append(x)
            x = attn(block2(x, t))
            skips.append(x)
            x = down(x)
        x = self.mid_block2(self.mid_attn(self.mid_block1(x, t)), t)
        for block1, block2, attn, up in self.ups:
            x = block1(torch.cat([x, skips.pop()], dim=1), t)
            x = block2(torch.cat([x, skips.pop()], dim=1), t)
            x = up(attn(x))
        x = self.final_res_block(torch.cat([x, r], dim=1), t)
        return self.final_conv(x)


class ForceUNet(nn.Module):
    """forward(x (B, H, W, C)) -> (B, out_dim): down path, mid blocks with
    full attention, the spatial mean, a linear head."""

    def __init__(self, dim: int = 64, out_dim: int = 1,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), channels: int = 4,
                 resnet_block_groups: int = 8):
        super().__init__()
        self.channels = channels
        groups = resnet_block_groups
        in_out = _levels(dim, dim_mults)
        self.init_conv = nn.Conv2d(channels, dim, 7, padding=3)
        self.downs = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(in_out):
            last = i == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ResnetBlock(d_in, d_in, None, groups),
                ResnetBlock(d_in, d_in, None, groups),
                _linear_attn(d_in),
                _downsample(d_in, d_out, last),
            ]))
        mid = in_out[-1][1]
        self.mid_block1 = ResnetBlock(mid, mid, None, groups)
        self.mid_attn = Residual(PreNorm(mid, Attention(mid)))
        self.mid_block2 = ResnetBlock(mid, mid, None, groups)
        self.final = nn.Linear(mid, out_dim)

    def forward(self, x):
        fp32_convs()
        x = self.init_conv(_nhwc_to_nchw(x))
        for block1, block2, attn, down in self.downs:
            x = down(attn(block2(block1(x))))
        x = self.mid_block2(self.mid_attn(self.mid_block1(x)))
        return self.final(x.mean(dim=(2, 3)))
