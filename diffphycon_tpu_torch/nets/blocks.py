"""UNet2D building blocks, channels-last (NHWC) at every forward.

Port of ``diffphycon_tpu/nets/blocks.py``. Module and parameter names follow
the reference torch ``Unet2D`` state_dict (the keys read by
``diffphycon_tpu/utils/torch_convert.py``), so a port state_dict converts to
the JAX package's tree with no new mapping code. Parameters keep torch
layouts (conv ``(out, in, kh, kw)``, linear ``(out, in)``, LayerNorm gain
``(1, C, 1, 1)``); each block's ``pack()`` gives its weights in the
kernels' layout.

Numerical traps carried over: the sinusoidal frequency divides by
``half - 1``; GELU is the exact erf form; ChanLayerNorm eps is 1e-5 in fp32
and 1e-3 otherwise; GroupNorm eps is 1e-5; linear attention softmaxes q over
the head dim and k over tokens; full attention softmaxes in fp32;
space-to-depth uses the torch (c p1 p2) channel order.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from diffphycon_tpu_torch.kernels import unet2d_blocks as kb


def sinusoidal_pos_emb(t: torch.Tensor, dim: int, theta: float = 10000.0):
    """(B,) times -> (B, dim) [sin | cos] embedding."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(theta) / (half - 1)))
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int, theta: float = 10000.0):
        super().__init__()
        self.dim = dim
        self.theta = theta

    def forward(self, t):
        return sinusoidal_pos_emb(t, self.dim, self.theta)


def time_mlp(dim: int, time_dim: int, theta: float = 10000.0) -> nn.Sequential:
    """sinusoidal -> Linear -> GELU (exact) -> Linear; keys time_mlp.1 / .3."""
    return nn.Sequential(SinusoidalPosEmb(dim, theta), nn.Linear(dim, time_dim),
                         nn.GELU(approximate="none"), nn.Linear(time_dim, time_dim))


def chan_layer_norm(x, g):
    """LayerNorm over the last (channel) axis, biased variance, gain only."""
    eps = 1e-5 if x.dtype == torch.float32 else 1e-3
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g.reshape(-1)


class LayerNorm(nn.Module):
    """ChanLayerNorm; gain stored (1, C, 1, 1) as in the reference."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))

    def forward(self, x):
        return chan_layer_norm(x, self.g)


def conv_pack(conv: nn.Conv2d):
    """Conv2d -> kernel layout (kh*kw*Ci, Co) with row (dy*kw + dx)*Ci + c."""
    co, ci, kh, kw = conv.weight.shape
    w = conv.weight.permute(2, 3, 1, 0).reshape(kh * kw * ci, co).contiguous()
    return {"w": w, "b": conv.bias}


class Block(nn.Module):
    """Conv3x3 + GroupNorm (the SiLU and FiLM live in the fused K3 stage)."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.proj = nn.Conv2d(dim, dim_out, 3, padding=1)
        self.norm = nn.GroupNorm(groups, dim_out, eps=kb.GN_EPS)


class ResnetBlock(nn.Module):
    """Two Blocks with FiLM time conditioning and a 1x1 residual conv when
    the width changes. Runs as :func:`kernels.unet2d_blocks.resblock`."""

    def __init__(self, dim: int, dim_out: int, time_emb_dim: int, groups: int = 8):
        super().__init__()
        self.groups = groups
        self.mlp = nn.Sequential(nn.SiLU(), nn.Linear(time_emb_dim, dim_out * 2))
        self.block1 = Block(dim, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups)
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def pack(self) -> dict:
        """Kernel-layout weights of this block (see kernels.unet2d_blocks)."""
        c1, c2 = conv_pack(self.block1.proj), conv_pack(self.block2.proj)
        p = {"w1": c1["w"], "b1": c1["b"],
             "gs1": self.block1.norm.weight, "gb1": self.block1.norm.bias,
             "w2": c2["w"], "b2": c2["b"],
             "gs2": self.block2.norm.weight, "gb2": self.block2.norm.bias}
        if isinstance(self.res_conv, nn.Conv2d):
            r = conv_pack(self.res_conv)
            p["wr"], p["br"] = r["w"], r["b"]
        return p

    def forward(self, x, time_emb, x_b=None):
        """x: (B, H, W, Ci) [+ skip x_b concatenated on channels]."""
        return kb.resblock(x, self.mlp(time_emb), self.pack(), x_b=x_b,
                           groups=self.groups)


class LinearAttention(nn.Module):
    """Parameters of the linear attention (reference names); it runs inside
    :class:`LinearAttentionBlock`."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(nn.Conv2d(hidden, dim, 1), LayerNorm(dim))


class Attention(nn.Module):
    """Parameters of the full attention; it runs inside :class:`AttentionBlock`."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.norm = LayerNorm(dim)


def _w1x1(conv: nn.Conv2d):
    """(out, in, 1, 1) conv weight -> (in, out) matmul weight."""
    return conv.weight[:, :, 0, 0].t().contiguous()


class Residual(nn.Module):
    """x + fn(x) for fn = PreNorm(attention); the attention blocks below."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def pack(self) -> dict:
        """The Pallas ``_attn_p`` layout: norm_g, wqkv (C, 3*hidden) with
        columns [q | k | v], wo (hidden, C), bo [, out_g]."""
        attn = self.fn.fn
        linear = isinstance(attn.to_out, nn.Sequential)
        out = attn.to_out[0] if linear else attn.to_out
        p = {"norm_g": self.fn.norm.g.reshape(-1), "wqkv": _w1x1(attn.to_qkv),
             "wo": _w1x1(out), "bo": out.bias}
        if linear:
            p["out_g"] = attn.to_out[1].g.reshape(-1)
        return p


class LinearAttentionBlock(Residual):
    """x + LinearAttention(LayerNorm(x)); keys fn.norm.g, fn.fn.to_qkv,
    fn.fn.to_out.{0,1}. Holds parameters only: ``UNet2D`` runs it as K5
    (:func:`kernels.attention.linear_attention_block`) on its ``pack()``."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__(PreNorm(dim, LinearAttention(dim, heads, dim_head)))


class AttentionBlock(Residual):
    """x + Attention(LayerNorm(x)); keys fn.norm.g, fn.fn.to_qkv,
    fn.fn.to_out. Holds parameters only: ``UNet2D`` runs it as K6
    (:func:`kernels.attention.attention_block`) on its ``pack()``."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__(PreNorm(dim, Attention(dim, heads, dim_head)))


def space_to_depth(x):
    """(b, 2h, 2w, c) -> (b, h, w, 4c) in torch (c p1 p2) channel order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // 2, w // 2, 4 * c)


class SpaceToDepth(nn.Module):
    def forward(self, x):
        return space_to_depth(x)


class Downsample(nn.Sequential):
    """Space-to-depth + 1x1 conv (keys <prefix>.1.weight); runs as K2."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__(SpaceToDepth(), nn.Conv2d(dim * 4, dim_out, 1))

    def pack(self) -> dict:
        """(Co, 4C, 1, 1) with (c p1 p2) inputs -> (4C, Co) rows (p1 p2 c)."""
        conv = self[1]
        co, c4 = conv.weight.shape[:2]
        w = conv.weight.reshape(co, c4 // 4, 2, 2).permute(2, 3, 1, 0)
        return {"w": w.reshape(c4, co).contiguous(), "b": conv.bias}

    def forward(self, x):
        p = self.pack()
        return kb.downsample_nhwc(x, p["w"], p["b"])


class Upsample(nn.Sequential):
    """Nearest 2x + 3x3 conv (keys <prefix>.1.weight); runs as K1 with
    ``upsample=True``."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__(nn.Upsample(scale_factor=2, mode="nearest"),
                         nn.Conv2d(dim, dim_out, 3, padding=1))

    def pack(self) -> dict:
        return conv_pack(self[1])

    def forward(self, x):
        p = self.pack()
        return kb.conv2d_nhwc(x, p["w"], p["b"], k=3, upsample=True)
