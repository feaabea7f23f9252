"""UNet3D video denoiser for the smoke benchmark, (B, F, H, W, C) at the
boundary.

Port of ``diffphycon_tpu/nets/unet3d.py``: init 7^3 conv + temporal
attention; per level two FiLM ResnetBlock3Ds, per-frame spatial linear
attention and temporal attention over frames (rotary embedding + T5
relative position bias); spatial-only (1,4,4)/(1,2,2) down- and upsampling;
a bottleneck with per-frame full spatial attention; one skip per level; a
final ResnetBlock3D over the concatenated init features.

Module and parameter names follow the reference ``Unet3D_with_Conv3D``
state_dict (the keys read by ``diffphycon_tpu/utils/torch_convert.py:
convert_unet3d``), so a port state_dict converts to the JAX package's tree.
Inside, activations are torch's (B, C, F, H, W). The convolutions and
einsums were XLA ops in the JAX package (no Pallas kernel), so here they
are cuDNN convolutions and torch matmuls, in full float32 (TF32 off,
forward and backward: ``device.fp32_convs``).

``dtype`` is the JAX net's ``UNet3D(dtype=...)``, flax's compute dtype, and
bfloat16 follows flax's rules layer by layer (explicit casts, not
``torch.autocast``, whose per-op policy differs). Parameters stay float32.
Every conv and linear casts its input, weight and bias to ``dtype`` and
returns ``dtype`` (:class:`Conv3d`, :class:`Conv2d`, :class:`Linear`);
GroupNorm reduces and applies its float32 affine in float32 and rounds once
(flax ``GroupNorm(dtype=...)``); the channel LayerNorm takes its mean and
variance in float32 from the input, rounds them to the input's dtype, and
its float32 gain promotes the output to float32 (``ChanLayerNorm3D``); the
upsample's float32 bias promotes its output to float32
(``SpatialUpsample``); the temporal attention's rotary angles are float32,
so q and k, the logits, the softmax and ``attn @ v`` run in float32 there,
while the spatial attentions run in ``dtype`` throughout. The net's output
is in ``dtype``.

``remat`` and ``remat_all`` are the JAX net's memory switches (its
``nn.remat``): when a gradient is being recorded, ``remat`` recomputes the
attentions in the backward instead of storing their activations, and
``remat_all`` the ResnetBlocks too (``torch.utils.checkpoint``, non-reentrant,
which also carries double backward). Neither changes a number.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from diffphycon_tpu_torch.device import fp32_convs
from diffphycon_tpu_torch.nets.blocks import SinusoidalPosEmb
from diffphycon_tpu_torch.utils.profiling import in_span, span

GN_EPS = 1e-5
DTYPES = (torch.float32, torch.bfloat16)


def t5_relative_position_buckets(n: int, num_buckets: int = 32,
                                 max_distance: int = 32) -> np.ndarray:
    """T5-style relative position buckets, (n, n) int."""
    q = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    n_neg = -(k - q)
    nb = num_buckets // 2
    ret = (n_neg < 0).astype(np.int64) * nb
    n_abs = np.abs(n_neg)
    max_exact = nb // 2
    is_small = n_abs < max_exact
    with np.errstate(divide="ignore"):
        val_large = max_exact + (
            np.log(np.maximum(n_abs, 1) / max_exact)
            / math.log(max_distance / max_exact) * (nb - max_exact)
        ).astype(np.int64)
    val_large = np.minimum(val_large, nb - 1)
    return ret + np.where(is_small, n_abs, val_large)


def rotary_angles(n: int, dim: int) -> np.ndarray:
    """Rotary frequencies x positions, duplicated-interleaved to ``dim``."""
    freqs = 1.0 / (10000 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    ang = np.arange(n)[:, None] * freqs[None, :]
    return np.repeat(ang, 2, axis=-1)


def apply_rotary(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (..., n, d); angles: (n, d); rotates interleaved pairs."""
    x2 = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    rot = torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(x.shape)
    return x * torch.cos(angles) + rot * torch.sin(angles)


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class Conv3d(nn.Conv3d):
    """nn.Conv3d computing in ``dtype`` (flax ``nn.Conv(dtype=...)``): input,
    weight and bias cast to it, the output in it."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in ``dtype``, as :class:`Conv3d`."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Linear(nn.Linear):
    """nn.Linear computing in ``dtype`` (flax ``nn.Dense(dtype=...)``)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class GroupNorm(nn.GroupNorm):
    """flax ``GroupNorm(dtype=...)``: statistics, normalisation and the
    float32 affine in float32, the result rounded once to ``dtype``."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class Upsample(nn.ConvTranspose3d):
    """ConvTranspose3d (1, 4, 4) stride (1, 2, 2) pad (0, 1, 1), the
    transposed conv in ``dtype``, then ``+ bias`` in float32: the JAX
    ``SpatialUpsample`` adds its float32 bias parameter after the conv, which
    promotes a bfloat16 result to float32."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(dim, dim, (1, 4, 4), (1, 2, 2), (0, 1, 1))
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        y = F.conv_transpose3d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding)
        return y + self.bias.reshape(1, -1, 1, 1, 1)


class LayerNorm(nn.Module):
    """Channel LayerNorm (dim 1 of (B, C, F, H, W)), gain ``gamma`` stored
    (1, C, 1, 1, 1), biased variance, eps 1e-5 in every dtype (the JAX
    ``ChanLayerNorm3D``). The mean and variance are float32 reductions of
    the input rounded to its dtype (``jnp.mean`` / ``jnp.var`` of a
    bfloat16 array); the float32 gain makes the output float32."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(1, dim, 1, 1, 1))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=1, keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=1, keepdim=True)
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.gamma


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.norm = LayerNorm(dim)

    def forward(self, x, **kw):
        return self.fn(self.norm(x), **kw)


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x, **kw):
        return x + self.fn(x, **kw)


def _rotary(x, ang):
    """Rotary embedding on the first ang.shape[-1] features of x; float32
    angles make a bfloat16 x float32, as ``apply_rotary`` in JAX."""
    rot = ang.shape[-1]
    head = apply_rotary(x[..., :rot], ang)
    return head if rot == x.shape[-1] else torch.cat([head, x[..., rot:].to(head.dtype)], -1)


class Attention(nn.Module):
    """Softmax attention over the token axis of (N, n, C) tokens, with
    optional rotary embedding and an additive (heads, n, n) bias; the
    projections compute in ``dtype``."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, rotary: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dim_head, self.rotary = heads, dim_head, rotary
        hidden = heads * dim_head
        self.to_qkv = Linear(dim, hidden * 3, bias=False, dtype=dtype)
        self.to_out = Linear(hidden, dim, bias=False, dtype=dtype)

    def forward(self, tok, pos_bias=None):
        n_seq, n, _ = tok.shape
        h, d = self.heads, self.dim_head
        q, k, v = self.to_qkv(tok).reshape(n_seq, n, 3, h, d).permute(2, 0, 3, 1, 4)
        q = q * d ** -0.5
        if self.rotary:
            with span("nets.unet3d.host_tables"):
                ang = torch.as_tensor(rotary_angles(n, min(32, d)), dtype=torch.float32,
                                      device=tok.device)
            q, k = _rotary(q, ang), _rotary(k, ang)
        sim = q @ k.transpose(-1, -2)
        if pos_bias is not None:
            sim = sim + pos_bias
        attn = torch.softmax(sim, dim=-1)
        out = attn @ v.to(attn.dtype)  # (N, h, n, d)
        return self.to_out(out.transpose(1, 2).reshape(n_seq, n, h * d))


class TemporalTokens(nn.Module):
    """(B, C, F, H, W) -> (B*H*W, F, C) tokens through ``fn`` and back (the
    reference's EinopsToAndFrom around its temporal Attention)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x, pos_bias=None):
        b, c, f, hs, ws = x.shape
        tok = x.permute(0, 3, 4, 2, 1).reshape(b * hs * ws, f, c)
        out = self.fn(tok, pos_bias=pos_bias)
        return out.reshape(b, hs, ws, f, c).permute(0, 4, 3, 1, 2)


class SpatialTokens(nn.Module):
    """(B, C, F, H, W) -> (B*F, H*W, C) tokens through ``fn`` and back."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        b, c, f, hs, ws = x.shape
        tok = x.permute(0, 2, 3, 4, 1).reshape(b * f, hs * ws, c)
        return self.fn(tok).reshape(b, f, hs, ws, c).permute(0, 4, 1, 2, 3)


class SpatialLinearAttention(nn.Module):
    """Per-frame linear attention: q softmaxed over the head dim, k over
    tokens; 1x1 Conv2d projections."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = Conv2d(dim, hidden * 3, 1, bias=False, dtype=dtype)
        self.to_out = Conv2d(hidden, dim, 1, dtype=dtype)

    def forward(self, x):
        b, c, f, hs, ws = x.shape
        h, d = self.heads, self.dim_head
        frames = x.transpose(1, 2).reshape(b * f, c, hs, ws)
        q, k, v = self.to_qkv(frames).reshape(b * f, 3, h, d, hs * ws).unbind(1)
        q = torch.softmax(q, dim=-2) * d ** -0.5
        k = torch.softmax(k, dim=-1)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q).reshape(b * f, h * d, hs, ws)
        return self.to_out(out).reshape(b, f, c, hs, ws).transpose(1, 2)


class Block(nn.Module):
    """Conv3x3x3 -> GroupNorm -> FiLM -> SiLU."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Conv3d(dim, dim_out, 3, padding=1, dtype=dtype)
        self.norm = GroupNorm(groups, dim_out, eps=GN_EPS, dtype=dtype)

    def forward(self, x, scale_shift=None):
        x = self.norm(self.proj(x))
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        return F.silu(x)


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, time_emb_dim: Optional[int] = None,
                 groups: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = (nn.Sequential(nn.SiLU(), Linear(time_emb_dim, dim_out * 2, dtype=dtype))
                    if time_emb_dim is not None else None)
        self.block1 = Block(dim, dim_out, groups, dtype)
        self.block2 = Block(dim_out, dim_out, groups, dtype)
        self.res_conv = (Conv3d(dim, dim_out, 1, dtype=dtype) if dim != dim_out
                         else nn.Identity())

    def forward(self, x, time_emb=None):
        scale_shift = None
        if self.mlp is not None and time_emb is not None:
            ss = self.mlp(time_emb)[:, :, None, None, None]
            scale_shift = ss.chunk(2, dim=1)
        h = self.block2(self.block1(x, scale_shift))
        return h + self.res_conv(x)


class RelativePositionBias(nn.Module):
    def __init__(self, heads: int = 4, num_buckets: int = 32, max_distance: int = 32):
        super().__init__()
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, heads)

    def forward(self, n: int, device):
        with span("nets.unet3d.host_tables"):
            buckets = torch.as_tensor(
                t5_relative_position_buckets(n, self.num_buckets, self.max_distance),
                device=device)
        return self.relative_attention_bias(buckets).permute(2, 0, 1)  # (heads, n, n)


def _temporal_attn(dim, heads, dim_head, dtype):
    return Residual(PreNorm(dim, TemporalTokens(
        Attention(dim, heads, dim_head, rotary=True, dtype=dtype))))


def time_mlp(dim: int, time_dim: int, dtype: torch.dtype = torch.float32) -> nn.Sequential:
    """sinusoidal (float32) -> Linear -> GELU (exact) -> Linear, the linears
    in ``dtype`` (the JAX ``TimeMLP(dtype=...)``); keys time_mlp.1 / .3."""
    return nn.Sequential(SinusoidalPosEmb(dim), Linear(dim, time_dim, dtype=dtype),
                         nn.GELU(approximate="none"), Linear(time_dim, time_dim, dtype=dtype))


class UNet3D(nn.Module):
    """Video U-Net; forward(x (B, F, H, W, C), time (B,)) -> (B, F, H, W, out)
    in ``dtype`` (float32 or bfloat16, the compute dtype; parameters are
    float32 either way)."""

    def __init__(self, dim: int = 64, out_dim: Optional[int] = None,
                 dim_mults: Sequence[int] = (1, 2, 4), channels: int = 6,
                 attn_heads: int = 4, attn_dim_head: int = 32,
                 init_kernel_size: int = 7, use_sparse_linear_attn: bool = True,
                 resnet_groups: int = 8, remat: bool = True, remat_all: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in DTYPES:
            raise ValueError(f"UNet3D: dtype {dtype}; float32 or bfloat16")
        self.dtype = dt = dtype
        self.channels = channels
        self.remat, self.remat_all = remat, remat_all
        heads, dh, groups = attn_heads, attn_dim_head, resnet_groups
        time_dim = dim * 4
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))

        self.time_rel_pos_bias = RelativePositionBias(heads, 32, 32)
        self.init_conv = Conv3d(channels, dim, init_kernel_size,
                                padding=init_kernel_size // 2, dtype=dt)
        self.init_temporal_attn = _temporal_attn(dim, heads, dh, dt)
        self.time_mlp = time_mlp(dim, time_dim, dt)

        def spatial_linear(d):
            return (Residual(PreNorm(d, SpatialLinearAttention(d, heads, dh, dt)))
                    if use_sparse_linear_attn else nn.Identity())

        self.downs = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(in_out):
            last = i == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ResnetBlock(d_in, d_out, time_dim, groups, dt),
                ResnetBlock(d_out, d_out, time_dim, groups, dt),
                spatial_linear(d_out),
                _temporal_attn(d_out, heads, dh, dt),
                nn.Identity() if last else Conv3d(d_out, d_out, (1, 4, 4), (1, 2, 2),
                                                  (0, 1, 1), dtype=dt),
            ]))
        mid = dims[-1]
        self.mid_block1 = ResnetBlock(mid, mid, time_dim, groups, dt)
        self.mid_spatial_attn = Residual(PreNorm(mid, SpatialTokens(
            Attention(mid, heads, dh, dtype=dt))))
        self.mid_temporal_attn = _temporal_attn(mid, heads, dh, dt)
        self.mid_block2 = ResnetBlock(mid, mid, time_dim, groups, dt)
        self.ups = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(reversed(in_out)):
            last = i == len(in_out) - 1
            self.ups.append(nn.ModuleList([
                ResnetBlock(d_out * 2, d_in, time_dim, groups, dt),
                ResnetBlock(d_in, d_in, time_dim, groups, dt),
                spatial_linear(d_in),
                _temporal_attn(d_in, heads, dh, dt),
                nn.Identity() if last else Upsample(d_in, dt),
            ]))
        self.final_conv = nn.Sequential(ResnetBlock(dim * 2, dim, None, groups, dt),
                                        Conv3d(dim, out_dim or channels, 1, dtype=dt))

    def forward(self, x, time):
        if x.dim() != 5:
            raise ValueError(f"UNet3D expects (B, F, H, W, C), got {tuple(x.shape)}")
        fp32_convs()
        with span("nets.unet3d.forward"):
            return self._forward(x.permute(0, 4, 1, 2, 3), time).permute(0, 2, 3, 4, 1)

    def _run(self, kind: str, fn, *args, **kw):
        """fn(*args, **kw) in the span ``nets.block.<kind>``, recomputed (span
        and all) in the backward when ``remat`` covers it (attentions;
        ResnetBlocks with ``remat_all``) and autograd is recording."""
        on = self.remat_all or (self.remat and kind != "resnet")
        name = f"nets.block.{kind}"
        if on and torch.is_grad_enabled():
            return checkpoint(in_span, name, fn, *args, use_reentrant=False, **kw)
        return in_span(name, fn, *args, **kw)

    def _forward(self, x, time):
        run = self._run
        pos_bias = self.time_rel_pos_bias(x.shape[2], x.device)
        x = self.init_conv(x)
        x = run("temporal_attention", self.init_temporal_attn, x, pos_bias=pos_bias)
        r = x
        t = self.time_mlp(time)
        skips = []
        for block1, block2, sattn, tattn, down in self.downs:
            x = run("resnet", block1, x, t)
            x = run("resnet", block2, x, t)
            x = run("temporal_attention", tattn, run("linear_attention", sattn, x),
                    pos_bias=pos_bias)
            skips.append(x)
            x = down(x)
        x = run("resnet", self.mid_block1, x, t)
        x = run("attention", self.mid_spatial_attn, x)
        x = run("temporal_attention", self.mid_temporal_attn, x, pos_bias=pos_bias)
        x = run("resnet", self.mid_block2, x, t)
        for block1, block2, sattn, tattn, up in self.ups:
            x = run("resnet", block1, torch.cat([x, skips.pop()], dim=1), t)
            x = run("resnet", block2, x, t)
            x = up(run("temporal_attention", tattn, run("linear_attention", sattn, x),
                       pos_bias=pos_bias))
        x = run("resnet", self.final_conv[0], torch.cat([x, r], dim=1))
        return self.final_conv[1](x)
