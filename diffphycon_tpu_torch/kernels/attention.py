"""K5 and K6: the UNet2D attention blocks, and their plain versions.

The port of two kernels of ``diffphycon_tpu/research/pallas_unet2d.py``:

==================================  =========================================
Pallas kernel (pallas_unet2d.py)    Port
==================================  =========================================
``_linear_attention_kernel`` :194   K5 :func:`linear_attention_block`
                                    (``csrc/linear_attention.cu``: K5a, the
                                    per-head context; K5b, the output)
``_attention_kernel`` :229          K6 :func:`attention_block`
                                    (``csrc/attention.cu``)
==================================  =========================================

``p`` is the Pallas packing (``_attn_p``, pallas_unet2d.py:650-659):
``norm_g (C,)``, ``wqkv (C, 3*hidden)`` with columns ``[q | k | v]``, each
``(head, d)``; ``wo (hidden, C)``, ``bo (C,)``; ``out_g (C,)`` for the
linear block only. Activations NHWC fp32, tokens = H*W.

Numerics kept from the reference: ChanLayerNorm with biased variance and eps
1e-5; the linear block softmaxes q over each head's channels and THEN scales
it by dim_head^-0.5, softmaxes k over tokens, and ends in an out-ChanLN; the
full block has no out-ChanLN and softmaxes in fp32. The plain versions keep
the token axis last where they softmax over tokens (a softmax over a strided
inner axis takes a slow CUDA path).

Dispatch, launch counts and gradients as in ``kernels/unet2d_blocks.py``: a
CPU tensor takes the plain version; a CUDA tensor launches the kernel or the
wrapper raises; the backward is the VJP of the plain version (no backward
kernels yet). ``linear_attention_block.launches`` counts K5 launches (each
one K5a and one K5b), ``attention_block.launches`` K6 launches.
"""

from __future__ import annotations

import torch

from diffphycon_tpu_torch.kernels import _build, register_launch_counters
from diffphycon_tpu_torch.kernels import unet2d_blocks as kb

LN_EPS = 1e-5
KERNEL_HEADS, KERNEL_DIM_HEAD = 4, 32  # the geometry K5 and K6 are built for
MAX_CHANNELS = 512
MAX_FULL_TOKENS = 32  # K6 holds one sample's tokens in one block


def _chan_ln(x, g):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * g


def _qkv(x, norm_g, wqkv, heads, dim_head):
    """ChanLN(x) @ wqkv as (b, n, 3, heads, dim_head)."""
    b, hs, ws, c = x.shape
    hn = _chan_ln(x, norm_g).reshape(b * hs * ws, c)
    return (hn @ wqkv).reshape(b, hs * ws, 3, heads, dim_head)


def _linear_plain(x, norm_g, wqkv, wo, bo, out_g, heads=KERNEL_HEADS,
                  dim_head=KERNEL_DIM_HEAD):
    b, hs, ws, c = x.shape
    q, k, v = _qkv(x, norm_g, wqkv, heads, dim_head).unbind(2)  # (b, n, h, d)
    q = torch.softmax(q, dim=-1) * dim_head ** -0.5
    k = torch.softmax(k.permute(0, 2, 3, 1).contiguous(), dim=-1)  # (b, h, d, n)
    context = torch.einsum("bhdn,bnhe->bhde", k, v)
    out = torch.einsum("bhde,bnhd->bnhe", context, q).reshape(b * hs * ws, heads * dim_head)
    out = (out @ wo + bo).reshape(b, hs, ws, c)
    return x + _chan_ln(out, out_g)


def _full_plain(x, norm_g, wqkv, wo, bo, heads=KERNEL_HEADS, dim_head=KERNEL_DIM_HEAD):
    b, hs, ws, c = x.shape
    q, k, v = _qkv(x, norm_g, wqkv, heads, dim_head).unbind(2)
    sim = torch.einsum("bihd,bjhd->bhij", q * dim_head ** -0.5, k)
    attn = torch.softmax(sim.float(), dim=-1).to(sim.dtype)
    out = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(b * hs * ws, heads * dim_head)
    return x + (out @ wo + bo).reshape(b, hs, ws, c)


def linear_attention_block_plain(x, p, heads: int = KERNEL_HEADS,
                                 dim_head: int = KERNEL_DIM_HEAD):
    """x + ChanLN(out-proj(linear attention(ChanLN(x)))), plain torch."""
    return _linear_plain(x, p["norm_g"], p["wqkv"], p["wo"], p["bo"], p["out_g"],
                         heads, dim_head)


def attention_block_plain(x, p, heads: int = KERNEL_HEADS, dim_head: int = KERNEL_DIM_HEAD):
    """x + out-proj(softmax(q k^T / sqrt(d)) v) over all tokens, plain torch."""
    return _full_plain(x, p["norm_g"], p["wqkv"], p["wo"], p["bo"], heads, dim_head)


def _check_heads(name, heads, dim_head):
    if (heads, dim_head) != (KERNEL_HEADS, KERNEL_DIM_HEAD):
        raise ValueError(f"{name}: the kernel takes {KERNEL_HEADS} heads of "
                         f"{KERNEL_DIM_HEAD}, got {heads} x {dim_head}")


def _check_block(name, x, max_tokens=None, **weights):
    kb._check_cuda(name, x=x, **weights)
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC, got {tuple(x.shape)}")
    B, H, W, C = x.shape
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"{name}: C={C}; the kernel takes 1 to {MAX_CHANNELS} channels")
    if max_tokens is not None and H * W > max_tokens:
        raise ValueError(f"{name}: {H * W} tokens; the kernel takes at most {max_tokens}")
    hidden = KERNEL_HEADS * KERNEL_DIM_HEAD
    want = {"norm_g": (C,), "wqkv": (C, 3 * hidden), "wo": (hidden, C), "bo": (C,),
            "out_g": (C,)}
    for key, t in weights.items():
        if tuple(t.shape) != want[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {want[key]}")
    return B, H * W, C


def _linear_launch(x, norm_g, wqkv, wo, bo, out_g):
    B, n, C = _check_block("linear_attention_block", x, norm_g=norm_g, wqkv=wqkv, wo=wo,
                           bo=bo, out_g=out_g)
    out = torch.empty_like(x)
    ctx = torch.empty((B, KERNEL_HEADS, KERNEL_DIM_HEAD, KERNEL_DIM_HEAD),
                      device=x.device, dtype=torch.float32)
    err = _build.load_library().linear_attention_f32(
        x.data_ptr(), norm_g.data_ptr(), wqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
        out_g.data_ptr(), ctx.data_ptr(), out.data_ptr(), B, n, C, kb._stream(x))
    _build.check(err, "linear_attention_block")
    linear_attention_block.launches += 1
    return out


def _full_launch(x, norm_g, wqkv, wo, bo):
    B, n, C = _check_block("attention_block", x, max_tokens=MAX_FULL_TOKENS, norm_g=norm_g,
                           wqkv=wqkv, wo=wo, bo=bo)
    out = torch.empty_like(x)
    err = _build.load_library().attention_f32(
        x.data_ptr(), norm_g.data_ptr(), wqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
        out.data_ptr(), B, n, C, kb._stream(x))
    _build.check(err, "attention_block")
    attention_block.launches += 1
    return out


def linear_attention_block(x, p, heads: int = KERNEL_HEADS, dim_head: int = KERNEL_DIM_HEAD):
    """K5. x: (B, H, W, C) with C <= 512; 4 heads of 32 on CUDA."""
    if not kb._dispatch("linear_attention_block", x):
        return linear_attention_block_plain(x, p, heads, dim_head)
    _check_heads("linear_attention_block", heads, dim_head)
    return kb.with_plain_vjp(_linear_launch, _linear_plain, x, p["norm_g"], p["wqkv"],
                             p["wo"], p["bo"], p["out_g"])


def attention_block(x, p, heads: int = KERNEL_HEADS, dim_head: int = KERNEL_DIM_HEAD):
    """K6. x: (B, H, W, C) with H*W <= 32 and C <= 512; 4 heads of 32 on
    CUDA."""
    if not kb._dispatch("attention_block", x):
        return attention_block_plain(x, p, heads, dim_head)
    _check_heads("attention_block", heads, dim_head)
    return kb.with_plain_vjp(_full_launch, _full_plain, x, p["norm_g"], p["wqkv"], p["wo"],
                             p["bo"])


register_launch_counters(linear_attention_block, "launches")
register_launch_counters(attention_block, "launches")
