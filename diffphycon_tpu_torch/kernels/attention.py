"""K5 and K6: the UNet2D attention blocks, and their plain versions.

The port of two kernels of ``diffphycon_tpu/research/pallas_unet2d.py``:

==================================  =========================================
Pallas kernel (pallas_unet2d.py)    Port
==================================  =========================================
``_linear_attention_kernel`` :194   K5 :func:`linear_attention_block`
                                    (``csrc/linear_attention_tc.cu``: K5a,
                                    the per-chunk context partials; their
                                    merge; K5b, the output)
``_attention_kernel`` :229          K6 :func:`attention_block`
                                    (``csrc/attention.cu``: K6a, the qkv
                                    projection; K6b, the online softmax;
                                    K6c, the out-projection)
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

K5 cuts each sample's tokens into S chunks (:func:`la_chunk_plan`), and
the heads over one or two CTAs (:func:`la_head_groups`); K5a writes each
chunk's (context, max, sum), a merge launch joins them in chunk order with
the online-softmax rescale, and K5b applies the context.
:func:`linear_attention_chunked_emulated` is that arithmetic in plain
PyTorch, for the tests.

K6 takes any token count: K6a projects tiles of 32 or 64 tokens
(:func:`attn_tile_rows`) onto q, k and v; K6b runs the softmax online over
64-key tiles per (64 queries, head, sample); K6c applies the
out-projection, whose 32-deep slices are the heads, summed in head order.
:func:`attention_tiled_emulated` is that arithmetic in plain PyTorch.

bf16 weights: bfloat16 ``wqkv`` and ``wo`` select K5's and K6's bf16
variants (``linear_attention_tc_bf16``, ``attention_bf16``;
``csrc/attention_bf16.cuh``): the projections (K5a's k | v, K5b's q and
out-projection, K6a and K6c) run ``wgmma`` bf16 on the float32 operand
rounded to bfloat16 once into shared memory, with the weights by TMA, as the
Pallas ``_matmul`` does under ``weight_dtype=bfloat16``; the context and
attention-core products stay 3xTF32 on float32 values, as Pallas computes
them in float32. K5b, K6a and K6c tile the flattened (B n) tokens 64 (K5b: or 32) at a
time (:func:`attn_tile_rows` with ``bf16``; K5b's tiles and CTAs
:func:`la_output_plan`); K5a takes two heads a CTA wherever C > 256
(:func:`la_head_groups` with ``bf16``). The plain versions
round the same operands (``unet2d_blocks.matmul_w``); ``bf16_launches``
counts the bf16 calls.

bf16 activations (flax ``dtype=bfloat16``): a bfloat16 x (with bfloat16
weights) selects K5's and K6's bf16-activation variants
(``linear_attention_bf16act``, ``attention_bf16act``; ``csrc/
attention_bf16act.cu``) and the plain versions of flax's blocks
(:func:`chan_ln_bf16`, :func:`softmax_bf16`; ``tests/
test_torch_port_bf16_flax_unet2d.py`` holds them against flax): ChanLN
with eps 1e-3, its mean and variance float32 reductions rounded to
bfloat16 and each later op rounded, the float32 gain making it float32;
q, k and v, the softmaxes' outputs, the context, the attention product and
the out-projection rounded to bfloat16; the full block's softmax in float32
then rounded. Both blocks return bf16(x + h): the linear block's h is
float32 (its out-ChanLN's gain), and flax's float32 sum feeds only convs
that round it to bfloat16, so storing it rounded is exact. K5 runs three
launches (the k | v projection per 64-token tile of a sample with its
tiles' k maxima; k's token softmax and the context in one cluster per
(sample, head) of :func:`bf16act_plan`, the ranks' sums and partials
added in rank order; q re-projected, the context applied, the
out-projection); :func:`linear_attention_bf16act_emulated` is that order
in plain PyTorch. ``bf16act_launches`` counts these calls.

Dispatch, launch counts and gradients as in ``kernels/unet2d_blocks.py``: a
CPU tensor takes the plain version; a CUDA tensor launches the kernel or the
wrapper raises; the backward is the VJP of the plain version (no backward
kernels yet). ``linear_attention_block.launches`` counts K5 calls (each
one K5a, one merge and one K5b launch), ``attention_block.launches`` K6
calls (each one K6a, one K6b and one K6c launch).
"""

from __future__ import annotations

import functools
import math

import torch

from diffphycon_tpu_torch.kernels import _build, register_launch_counters
from diffphycon_tpu_torch.kernels import unet2d_blocks as kb

LN_EPS = 1e-5
KERNEL_HEADS, KERNEL_DIM_HEAD = 4, 32  # the geometry K5 and K6 are built for
MAX_CHANNELS = 512
ATTN_KEY_TILE = 64  # keys per online-softmax step of K6b (attention.cu: kKTile)
LA_TILE = 64  # tokens per tile of K5's two stages (linear_attention_tc.cuh: kRows)
LA_CHUNKS = (256, 128, 64)  # K5a chunk sizes, a multiple of LA_TILE, largest first
LA_PART = KERNEL_DIM_HEAD + 2  # a partial context row, its max and its sum


def _chan_ln(x, g):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * g


def _qkv(x, norm_g, wqkv, heads, dim_head):
    """ChanLN(x) @ wqkv as (b, n, 3, heads, dim_head)."""
    b, hs, ws, c = x.shape
    hn = _chan_ln(x, norm_g).reshape(b * hs * ws, c)
    return kb.matmul_w(hn, wqkv).reshape(b, hs * ws, 3, heads, dim_head)


def _linear_plain(x, norm_g, wqkv, wo, bo, out_g, heads=KERNEL_HEADS,
                  dim_head=KERNEL_DIM_HEAD):
    b, hs, ws, c = x.shape
    q, k, v = _qkv(x, norm_g, wqkv, heads, dim_head).unbind(2)  # (b, n, h, d)
    q = torch.softmax(q, dim=-1) * dim_head ** -0.5
    k = torch.softmax(k.permute(0, 2, 3, 1).contiguous(), dim=-1)  # (b, h, d, n)
    context = torch.einsum("bhdn,bnhe->bhde", k, v)
    out = torch.einsum("bhde,bnhd->bnhe", context, q).reshape(b * hs * ws, heads * dim_head)
    out = (kb.matmul_w(out, wo) + bo).reshape(b, hs, ws, c)
    return x + _chan_ln(out, out_g)


def _full_plain(x, norm_g, wqkv, wo, bo, heads=KERNEL_HEADS, dim_head=KERNEL_DIM_HEAD):
    b, hs, ws, c = x.shape
    q, k, v = _qkv(x, norm_g, wqkv, heads, dim_head).unbind(2)
    sim = torch.einsum("bihd,bjhd->bhij", q * dim_head ** -0.5, k)
    attn = torch.softmax(sim.float(), dim=-1).to(sim.dtype)
    out = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(b * hs * ws, heads * dim_head)
    return x + (kb.matmul_w(out, wo) + bo).reshape(b, hs, ws, c)


LN_EPS_BF16 = 1e-3  # flax ChanLayerNorm's eps on a non-float32 input (nets/blocks.py:60)
BF16 = torch.bfloat16


def chan_ln_bf16(x, g):
    """flax ``ChanLayerNorm`` of a bfloat16 x (diffphycon_tpu/nets/blocks.py:
    56-64): eps 1e-3 (rounded to bfloat16, as a weak-typed constant); the
    mean and the variance are float32 reductions (the variance around the
    float32 mean, ``jnp.var``) rounded to bfloat16; ``x - mean``,
    ``var + eps``, the rsqrt and their product each rounded to bfloat16;
    the float32 gain makes the result float32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var.to(BF16) + kb.bf16_const(LN_EPS_BF16, x))
    return ((x - mean.to(BF16)) * r) * g


def softmax_bf16(t, dim: int):
    """``jax.nn.softmax`` of a bfloat16 t as XLA computes it inside flax's
    bf16 linear attention on the CPU: the difference to the max, its exp,
    each rounded to bfloat16; their sum a float32 reduction rounded to
    bfloat16; the quotient rounded. (A softmax jitted alone can keep the
    exps float32 for the sum: held against the block, not assumed.)"""
    e = torch.exp(t - t.amax(dim=dim, keepdim=True))
    return e / e.float().sum(dim=dim, keepdim=True).to(BF16)


def _bmm_bf16(eq, a, b):
    """A bfloat16 einsum as XLA computes it: float32 sums, rounded once."""
    return torch.einsum(eq, a.float(), b.float()).to(BF16)


def _qkv_bf16(x, norm_g, wqkv, heads, dim_head):
    """q, k, v (b, n, heads, dim_head) bfloat16 of the flax bf16 block:
    ChanLN (float32), rounded to bfloat16 by the bias-free 1x1 conv."""
    b, hs, ws, c = x.shape
    h = chan_ln_bf16(x, norm_g).reshape(b * hs * ws, c).to(BF16)
    qkv = _bmm_bf16("nc,cj->nj", h, wqkv).reshape(b, hs * ws, 3, heads, dim_head)
    return qkv.unbind(2)


def _out_proj_bf16(out, wo, bo, shape):
    """The bfloat16 1x1 out-conv: float32 sum, rounded, plus the bias
    rounded to bfloat16, rounded again."""
    return kb.conv_bias_bf16(out.reshape(-1, out.shape[-2] * out.shape[-1]).float()
                             @ wo.float(), bo).reshape(shape)


def _linear_bf16_plain(x, norm_g, wqkv, wo, bo, out_g, heads=KERNEL_HEADS,
                       dim_head=KERNEL_DIM_HEAD):
    q, k, v = _qkv_bf16(x, norm_g, wqkv, heads, dim_head)  # (b, n, h, d)
    q = softmax_bf16(q, -1) * kb.bf16_const(dim_head ** -0.5, x)
    k = softmax_bf16(k.permute(0, 2, 3, 1), -1)  # (b, h, d, n): over the tokens
    context = _bmm_bf16("bhdn,bnhe->bhde", k, v)
    out = _bmm_bf16("bhde,bnhd->bnhe", context, q)
    o = _out_proj_bf16(out, wo, bo, x.shape)
    return (x + chan_ln_bf16(o, out_g)).to(BF16)


def _full_bf16_plain(x, norm_g, wqkv, wo, bo, heads=KERNEL_HEADS, dim_head=KERNEL_DIM_HEAD):
    q, k, v = _qkv_bf16(x, norm_g, wqkv, heads, dim_head)
    sim = _bmm_bf16("bihd,bjhd->bhij", q * kb.bf16_const(dim_head ** -0.5, x), k)
    attn = torch.softmax(sim.float(), dim=-1).to(BF16)
    out = _bmm_bf16("bhij,bjhd->bihd", attn, v)
    return x + _out_proj_bf16(out, wo, bo, x.shape)


def linear_attention_block_plain(x, p, heads: int = KERNEL_HEADS,
                                 dim_head: int = KERNEL_DIM_HEAD):
    """x + ChanLN(out-proj(linear attention(ChanLN(x)))), plain torch (a
    bfloat16 x: flax's bf16 block, stored as bfloat16)."""
    if kb.act_is_bf16("linear_attention_block", x, p["wqkv"], p["wo"]):
        return _linear_bf16_plain(x, p["norm_g"], p["wqkv"], p["wo"], p["bo"], p["out_g"],
                                  heads, dim_head)
    return _linear_plain(x, p["norm_g"], p["wqkv"], p["wo"], p["bo"], p["out_g"],
                         heads, dim_head)


def attention_block_plain(x, p, heads: int = KERNEL_HEADS, dim_head: int = KERNEL_DIM_HEAD):
    """x + out-proj(softmax(q k^T / sqrt(d)) v) over all tokens, plain torch
    (a bfloat16 x: flax's bf16 block)."""
    if kb.act_is_bf16("attention_block", x, p["wqkv"], p["wo"]):
        return _full_bf16_plain(x, p["norm_g"], p["wqkv"], p["wo"], p["bo"], heads, dim_head)
    return _full_plain(x, p["norm_g"], p["wqkv"], p["wo"], p["bo"], heads, dim_head)


def _check_heads(name, heads, dim_head):
    if (heads, dim_head) != (KERNEL_HEADS, KERNEL_DIM_HEAD):
        raise ValueError(f"{name}: the kernel takes {KERNEL_HEADS} heads of "
                         f"{KERNEL_DIM_HEAD}, got {heads} x {dim_head}")


@functools.lru_cache(maxsize=None)
def la_chunk_plan(B: int, n: int, sms: int = kb.SM_COUNT):
    """(chunk, S) of K5a: each sample's n tokens in S = ceil(n / chunk)
    chunks, the largest chunk of LA_CHUNKS that still gives B * S >= sms
    CTAs (one wave; the persistent kernel passes its grid); the smallest
    when none does. A larger chunk reads the k/v weights fewer times per
    token and leaves fewer partials to merge."""
    for chunk in LA_CHUNKS:
        if B * math.ceil(n / chunk) >= sms:
            return chunk, math.ceil(n / chunk)
    return LA_CHUNKS[-1], math.ceil(n / LA_CHUNKS[-1])


def la_head_groups(B: int, S: int, sms: int = kb.SM_COUNT, *, C: int = 0,
                   bf16: bool = False) -> int:
    """CTAs per (sample, chunk) of K5a: 2 (two heads each, one 128-column
    k|v pass per tile) where even twice B * S CTAs leave some of `sms` SMs
    idle, else 1 (all four heads, a k pass and a v pass per tile). Where the
    CTAs already share SMs, the split mostly repeats the x tile's copy and
    ChanLN (``tools/sweep_la_head_groups.py`` times both choices at every
    site). The bf16 variant (``bf16``) keeps its k and v columns resident in
    shared memory, C x 64 per head in bf16, so it takes 2 also wherever
    C > 256."""
    return 2 if 2 * B * S <= sms or (bf16 and C > 256) else 1


@functools.lru_cache(maxsize=None)
def la_output_plan(B: int, n: int, C: int, sms: int = kb.SM_COUNT):
    """(tokens per tile, CTAs) of the bf16 K5b over the B n flattened
    tokens. Tiles of 64 tokens, or of 32 where twice as many 32-token tiles
    still fit one wave (more SMs share the x tile's loads and stores; the
    wgmma rows past 32 are zero). Where the tiles outnumber the SMs and C <=
    128, one CTA an SM, each over a contiguous share of the tiles (fewer CTAs
    than tiles select the kernel's several-tiles variant: a sample's context
    tiles built once for several tiles, the next x tile copied while one
    finishes); else one CTA a tile."""
    tr = 32 if 2 * -(-B * n // LA_TILE) <= sms else LA_TILE
    tiles = -(-B * n // tr)
    return tr, (sms if C <= 128 and tiles > sms else tiles)


def linear_attention_chunked_emulated(x, p, chunk: int):
    """The linear block as K5 computes it, in plain PyTorch: per chunk of
    `chunk` tokens the (context, max, sum) partial of exp(k - max)^T v,
    merged in chunk order with the online-softmax rescale, then divided by
    the sum (fp32 products, not K5's 3xTF32). For the tests."""
    norm_g, wqkv, wo, bo, out_g = p["norm_g"], p["wqkv"], p["wo"], p["bo"], p["out_g"]
    b, hs, ws, c = x.shape
    n = hs * ws
    q, k, v = _qkv(x, norm_g, wqkv, KERNEL_HEADS, KERNEL_DIM_HEAD).unbind(2)  # (b, n, h, d)
    parts = []
    for t0 in range(0, n, chunk):
        kc, vc = k[:, t0:t0 + chunk], v[:, t0:t0 + chunk]
        m = kc.amax(dim=1)  # (b, h, d)
        e = torch.exp(kc - m[:, None])
        parts.append((torch.einsum("bnhd,bnhe->bhde", e, vc), m, e.sum(dim=1)))
    m_all = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    ctx = torch.zeros_like(parts[0][0])
    total = torch.zeros_like(m_all)
    for ctx_s, m_s, l_s in parts:
        w = torch.exp(m_s - m_all)
        ctx = ctx + w[..., None] * ctx_s
        total = total + w * l_s
    ctx = ctx / total[..., None]
    q = torch.softmax(q, dim=-1) * KERNEL_DIM_HEAD ** -0.5
    out = torch.einsum("bhde,bnhd->bnhe", ctx, q).reshape(b * n, KERNEL_HEADS * KERNEL_DIM_HEAD)
    out = (kb.matmul_w(out, wo) + bo).reshape(b, hs, ws, c)
    return x + _chan_ln(out, out_g)


@functools.lru_cache(maxsize=None)
def _linear_shapes(x_shape, bf16=False):
    """The checks of one K5 call that depend on x's shape (and the weights'
    dtype) alone, once per shape: (the kernel's ints (B, n, C, S, chunk,
    head groups), the weights' shapes, floats of its scratch: the chunks'
    partials, then the merged contexts)."""
    if len(x_shape) != 4:
        raise ValueError(f"linear_attention_block: x must be NHWC, got {tuple(x_shape)}")
    B, H, W, C = x_shape
    if not 4 <= C <= MAX_CHANNELS or C % 4:
        raise ValueError(f"linear_attention_block: C={C}; the kernel takes 4 to "
                         f"{MAX_CHANNELS} channels, a multiple of 4")
    n = H * W
    if B > 65535 or B * n * C > kb._INT32_MAX:
        raise ValueError(f"linear_attention_block: x {tuple(x_shape)} is too large")
    hidden = KERNEL_HEADS * KERNEL_DIM_HEAD
    chunk, S = la_chunk_plan(B, n)
    weights = ((C,), (C, 3 * hidden), (hidden, C), (C,), (C,))
    scratch = B * S * hidden * LA_PART + B * hidden * KERNEL_DIM_HEAD
    return (B, n, C, S, chunk, la_head_groups(B, S, C=C, bf16=bf16)), weights, scratch


_WEIGHT_NAMES = ("norm_g", "wqkv", "wo", "bo", "out_g")


def _check_weights(name, tensors, shapes):
    for key, t, shape in zip(_WEIGHT_NAMES, tensors, shapes):
        if t.shape != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {shape}")


def _linear_launch(x, norm_g, wqkv, wo, bo, out_g, stages=3, part=None):
    kb._check_cuda("linear_attention_block", bf16=("wqkv", "wo"), x=x, norm_g=norm_g,
                   wqkv=wqkv, wo=wo, bo=bo, out_g=out_g)
    bf16 = kb.weight_is_bf16("linear_attention_block", wqkv, wo)
    ints, weights, part_floats = _linear_shapes(x.shape, bf16)
    _check_weights("linear_attention_block", (norm_g, wqkv, wo, bo, out_g), weights)
    kb._check_vec4("linear_attention_block", (), (x, norm_g, wqkv, wo, bo, out_g))
    out = torch.empty_like(x)
    if part is None:
        part = x.new_empty(part_floats)
    lib = _build.load_library()
    out_plan = la_output_plan(ints[0], ints[1], ints[2]) if bf16 else (0, 0)
    err = (lib.linear_attention_tc_bf16 if bf16 else lib.linear_attention_tc_f32)(
        x.data_ptr(), norm_g.data_ptr(), wqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
        out_g.data_ptr(), part.data_ptr(), out.data_ptr(),
        kb.int_array(ints + (stages, out_plan[1], out_plan[0])), kb._stream(x))
    _build.check(err, "linear_attention_block")
    return out


def _linear_block_launch(x, norm_g, wqkv, wo, bo, out_g):
    out = _linear_launch(x, norm_g, wqkv, wo, bo, out_g)
    linear_attention_block.launches += 1
    linear_attention_block.bf16_launches += int(wqkv.dtype == torch.bfloat16)
    return out


def linear_attention_stages(x, p):
    """(K5a alone, the merge and K5b) on CUDA tensors: two functions that
    launch one stage of K5 each, sharing one scratch (the second merges what
    the first last wrote there; call the first before the second), so that
    the stages can be timed apart. They count no launch: the main path's
    launches are those of :func:`linear_attention_block`."""
    args = (x, p["norm_g"], p["wqkv"], p["wo"], p["bo"], p["out_g"])
    part = x.new_empty(_linear_shapes(x.shape)[2])
    return (functools.partial(_linear_launch, *args, stages=1, part=part),
            functools.partial(_linear_launch, *args, stages=2, part=part))


def attn_tile_rows(B: int, n: int, sms: int = kb.SM_COUNT, bf16: bool = False) -> int:
    """Tokens per K6a/K6c tile: 64, or 32 where 64-token tiles would give
    K6a's three passes fewer than one CTA per SM of `sms` (a 32-token CTA
    fits twice on an SM at C = 512, a 64-token one once). The bf16 variant
    (``bf16``) always takes 64: its wgmma products are 64 rows, so a
    32-token tile would leave half of each idle."""
    if bf16:
        return 64
    return 64 if 3 * math.ceil(B * n / 64) >= sms else 32


def attention_tiled_emulated(x, p, key_tile: int = ATTN_KEY_TILE):
    """The full block as K6 computes it, in plain PyTorch: per (sample,
    head) the softmax taken online over tiles of `key_tile` keys (running
    max, rescaled running sum and output), then the out-projection as the
    four heads' partials o_h wo[32 h : 32 h + 32] summed in head order (a
    bfloat16 ``wo``: one product over all 128 channels, as the bf16 K6c's one
    wgmma chain), the bias and the residual (fp32 products, not K6's
    3xTF32). For the tests."""
    norm_g, wqkv, wo, bo = p["norm_g"], p["wqkv"], p["wo"], p["bo"]
    b, hs, ws, c = x.shape
    n = hs * ws
    q, k, v = _qkv(x, norm_g, wqkv, KERNEL_HEADS, KERNEL_DIM_HEAD).unbind(2)  # (b, n, h, d)
    q = q * KERNEL_DIM_HEAD ** -0.5
    m = x.new_full((b, KERNEL_HEADS, n), -math.inf)
    total = x.new_zeros(b, KERNEL_HEADS, n)
    o = x.new_zeros(b, KERNEL_HEADS, n, KERNEL_DIM_HEAD)
    for k0 in range(0, n, key_tile):
        s = torch.einsum("bihd,bjhd->bhij", q, k[:, k0:k0 + key_tile])
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        e = torch.exp(s - m_new[..., None])
        total = total * alpha + e.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhij,bjhd->bhid", e, v[:, k0:k0 + key_tile])
        m = m_new
    o = o / total[..., None]  # (b, h, n, d)
    if wo.dtype == torch.bfloat16:  # the bf16 K6c: one chain over all 128 channels
        acc = kb.matmul_w(o.permute(0, 2, 1, 3).reshape(b, n, KERNEL_HEADS * KERNEL_DIM_HEAD), wo)
        return x + (acc + bo).reshape(b, hs, ws, c)
    acc = kb.matmul_w(o[:, 0], wo[:KERNEL_DIM_HEAD])
    for h in range(1, KERNEL_HEADS):
        acc = acc + kb.matmul_w(o[:, h], wo[h * KERNEL_DIM_HEAD:(h + 1) * KERNEL_DIM_HEAD])
    return x + (acc + bo).reshape(b, hs, ws, c)


@functools.lru_cache(maxsize=None)
def _full_shapes(x_shape, bf16=False):
    """The checks of one K6 call that depend on x's shape (and the weights'
    dtype) alone, once per shape: (the kernel's ints (B, n, C, tile rows), the weights' shapes,
    floats of its scratch: qkv, then the attention output)."""
    if len(x_shape) != 4:
        raise ValueError(f"attention_block: x must be NHWC, got {tuple(x_shape)}")
    B, H, W, C = x_shape
    if not 4 <= C <= MAX_CHANNELS or C % 4:
        raise ValueError(f"attention_block: C={C}; the kernel takes 4 to {MAX_CHANNELS} "
                         f"channels, a multiple of 4")
    n = H * W
    hidden = KERNEL_HEADS * KERNEL_DIM_HEAD
    if not 1 <= B <= 65535 or n < 1 or B * n * 4 * hidden > kb._INT32_MAX:
        raise ValueError(f"attention_block: x {tuple(x_shape)} is too large")
    weights = ((C,), (C, 3 * hidden), (hidden, C), (C,))
    return (B, n, C, attn_tile_rows(B, n, bf16=bf16)), weights, B * n * 4 * hidden


def _full_launch(x, norm_g, wqkv, wo, bo):
    kb._check_cuda("attention_block", bf16=("wqkv", "wo"), x=x, norm_g=norm_g, wqkv=wqkv,
                   wo=wo, bo=bo)
    bf16 = kb.weight_is_bf16("attention_block", wqkv, wo)
    ints, weights, scratch_floats = _full_shapes(x.shape, bf16)
    _check_weights("attention_block", (norm_g, wqkv, wo, bo), weights)
    kb._check_vec4("attention_block", (), (x, norm_g, wqkv, wo, bo))
    out = torch.empty_like(x)
    scratch = x.new_empty(scratch_floats)
    lib = _build.load_library()
    err = (lib.attention_bf16 if bf16 else lib.attention_f32)(
        x.data_ptr(), norm_g.data_ptr(), wqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), kb.int_array(ints), kb._stream(x))
    _build.check(err, "attention_block")
    attention_block.launches += 1
    attention_block.bf16_launches += int(bf16)
    return out


HIDDEN = KERNEL_HEADS * KERNEL_DIM_HEAD
BF16ACT_TILE = 64  # tokens a tile of one sample in K5a, K5c, K6a, K6c (attention_bf16act.cu: kTile)
BF16ACT_CLUSTER_TOKENS = 256  # K5b: about this many tokens a rank, where 8 ranks allow
BF16ACT_MAX_CLUSTER = 8  # the portable cluster size


@functools.lru_cache(maxsize=None)
def bf16act_plan(B: int, n: int, C: int, sms: int = kb.SM_COUNT):
    """(head groups, cs, share) of the bf16-activation K5. K5a's CTAs take 2
    heads (head groups 2) where C > 256 (its resident k | v columns, C x 64
    bf16 a head, at most 128 KB) or where twice the B ceil(n / 64) tiles
    still fit one wave, else all 4. K5b runs one cluster of cs CTAs per
    (sample, head): about BF16ACT_CLUSTER_TOKENS tokens a rank, at most
    BF16ACT_MAX_CLUSTER ranks; rank r takes tokens [r share, (r + 1)
    share), share a multiple of 64 (K5a's tiles), no rank empty."""
    tiles = B * -(-n // BF16ACT_TILE)
    groups = 2 if C > 256 or 2 * tiles <= sms else 1
    cs = min(BF16ACT_MAX_CLUSTER, -(-n // BF16ACT_CLUSTER_TOKENS))
    per_rank = -(-n // cs)
    share = -(-per_rank // BF16ACT_TILE) * BF16ACT_TILE
    return groups, -(-n // share), share


def linear_attention_bf16act_emulated(x, p, cs: int, share: int):
    """The bf16-activation linear block in the order K5's kernels sum, in
    plain PyTorch: k's max from the maxima of the 64-token tiles; the exps'
    fp32 sums per rank (tokens [r share, (r + 1) share)) added in rank
    order, then rounded; p = bf16(e / sum); the fp32 context partials p^T v
    per rank added in rank order, then rounded; the rest as
    ``_linear_bf16_plain`` (every rounding point the same; only the order of
    the fp32 sums differs). For the tests."""
    norm_g, wqkv, wo, bo, out_g = p["norm_g"], p["wqkv"], p["wo"], p["bo"], p["out_g"]
    n = x.shape[1] * x.shape[2]
    q, k, v = _qkv_bf16(x, norm_g, wqkv, KERNEL_HEADS, KERNEL_DIM_HEAD)  # (b, n, h, d)
    q = softmax_bf16(q, -1) * kb.bf16_const(KERNEL_DIM_HEAD ** -0.5, x)
    kt = k.permute(0, 2, 3, 1)  # (b, h, d, n)
    tile_max = [kt[..., t0:t0 + BF16ACT_TILE].amax(dim=-1) for t0 in range(0, n, BF16ACT_TILE)]
    e = torch.exp(kt - torch.stack(tile_max).amax(dim=0)[..., None])  # bf16 ops, each rounded
    ranks = [(r * share, min(n, (r + 1) * share)) for r in range(cs)]
    total = torch.zeros(kt.shape[:3], device=x.device)
    for r0, r1 in ranks:
        total = total + e[..., r0:r1].float().sum(dim=-1)
    pk = e / total.to(BF16)[..., None]
    context = torch.zeros(*kt.shape[:3], KERNEL_DIM_HEAD, device=x.device)
    for r0, r1 in ranks:
        context = context + torch.einsum("bhdn,bnhe->bhde", pk[..., r0:r1].float(),
                                         v[:, r0:r1].float())
    out = _bmm_bf16("bhde,bnhd->bnhe", context.to(BF16), q)
    o = _out_proj_bf16(out, wo, bo, x.shape)
    return (x + chan_ln_bf16(o, out_g)).to(BF16)


@functools.lru_cache(maxsize=None)
def _bf16act_shapes(name, x_shape, linear):
    """The checks of one bf16-activation K5 or K6 call that depend on x's
    shape alone, once per shape: (the kernel's ints (B, n, C; K5: and
    :func:`bf16act_plan`), the weights' shapes, bf16 values of its scratch:
    K5's k | v rows head-major (B, 4, n, 64), its contexts (B, 4, 32, 32)
    and its float32 k maxima per 64-token tile (B, ceil(n / 64), 128); or
    K6's q | k | v rows (B, n, 384) and attention output (B, n, 128))."""
    if len(x_shape) != 4:
        raise ValueError(f"{name}: x must be NHWC, got {tuple(x_shape)}")
    B, H, W, C = x_shape
    n = H * W
    if not 8 <= C <= MAX_CHANNELS or C % 8:
        raise ValueError(f"{name}: C={C}; the bf16-activation kernel takes 8 to "
                         f"{MAX_CHANNELS} channels, a multiple of 8")
    if not 1 <= B <= 65535 or n < 1 or B * n * 3 * HIDDEN > kb._INT32_MAX:
        raise ValueError(f"{name}: x {tuple(x_shape)} is too large")
    weights = ((C,), (C, 3 * HIDDEN), (HIDDEN, C), (C,)) + (((C,),) if linear else ())
    if linear:
        tiles = -(-n // BF16ACT_TILE)
        scratch = B * n * 2 * HIDDEN + B * HIDDEN * KERNEL_DIM_HEAD + 2 * B * tiles * HIDDEN
        return (B, n, C) + bf16act_plan(B, n, C), weights, scratch
    return (B, n, C), weights, B * n * 4 * HIDDEN


def _linear_bf16act_launch(x, norm_g, wqkv, wo, bo, out_g):
    name = "linear_attention_block"
    kb._check_cuda(name, bf16=("x", "wqkv", "wo"), x=x, norm_g=norm_g, wqkv=wqkv, wo=wo,
                   bo=bo, out_g=out_g)
    ints, weights, scratch = _bf16act_shapes(name, x.shape, True)
    _check_weights(name, (norm_g, wqkv, wo, bo, out_g), weights)
    kb._check_vec4(name, (), (x, norm_g, wqkv, wo, bo, out_g))
    out = torch.empty_like(x)
    part = x.new_empty(scratch)
    err = _build.load_library().linear_attention_bf16act(
        x.data_ptr(), norm_g.data_ptr(), wqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
        out_g.data_ptr(), part.data_ptr(), out.data_ptr(), kb.int_array(ints + (7,)),
        kb._stream(x))
    _build.check(err, name)
    linear_attention_block.launches += 1
    linear_attention_block.bf16act_launches += 1
    return out


def _full_bf16act_launch(x, norm_g, wqkv, wo, bo):
    name = "attention_block"
    kb._check_cuda(name, bf16=("x", "wqkv", "wo"), x=x, norm_g=norm_g, wqkv=wqkv, wo=wo, bo=bo)
    ints, weights, scratch = _bf16act_shapes(name, x.shape, False)
    _check_weights(name, (norm_g, wqkv, wo, bo), weights)
    kb._check_vec4(name, (), (x, norm_g, wqkv, wo, bo))
    out = torch.empty_like(x)
    part = x.new_empty(scratch)
    err = _build.load_library().attention_bf16act(
        x.data_ptr(), norm_g.data_ptr(), wqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(),
        out.data_ptr(), part.data_ptr(), kb.int_array(ints), kb._stream(x))
    _build.check(err, name)
    attention_block.launches += 1
    attention_block.bf16act_launches += 1
    return out


def linear_attention_block(x, p, heads: int = KERNEL_HEADS, dim_head: int = KERNEL_DIM_HEAD):
    """K5. x: (B, H, W, C); on CUDA 4 heads of 32 and C a multiple of 4 up
    to 512. A bfloat16 x (with bfloat16 wqkv and wo) selects the
    bf16-activation variant (C a multiple of 8) and gives bfloat16."""
    if not kb._dispatch("linear_attention_block", x):
        return linear_attention_block_plain(x, p, heads, dim_head)
    _check_heads("linear_attention_block", heads, dim_head)
    args = (x, p["norm_g"], p["wqkv"], p["wo"], p["bo"], p["out_g"])
    if kb.act_is_bf16("linear_attention_block", x, p["wqkv"], p["wo"]):
        return kb.with_plain_vjp(_linear_bf16act_launch, _linear_bf16_plain, *args)
    return kb.with_plain_vjp(_linear_block_launch, _linear_plain, *args)


def attention_block(x, p, heads: int = KERNEL_HEADS, dim_head: int = KERNEL_DIM_HEAD):
    """K6. x: (B, H, W, C), any H*W; on CUDA 4 heads of 32 and C a multiple
    of 4 up to 512. A bfloat16 x (with bfloat16 wqkv and wo) selects the
    bf16-activation variant (C a multiple of 8) and gives bfloat16."""
    if not kb._dispatch("attention_block", x):
        return attention_block_plain(x, p, heads, dim_head)
    _check_heads("attention_block", heads, dim_head)
    args = (x, p["norm_g"], p["wqkv"], p["wo"], p["bo"])
    if kb.act_is_bf16("attention_block", x, p["wqkv"], p["wo"]):
        return kb.with_plain_vjp(_full_bf16act_launch, _full_bf16_plain, *args)
    return kb.with_plain_vjp(_full_launch, _full_plain, *args)


register_launch_counters(linear_attention_block, "launches", "bf16_launches",
                         "bf16act_launches")
register_launch_counters(attention_block, "launches", "bf16_launches", "bf16act_launches")
