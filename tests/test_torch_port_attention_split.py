"""What the host code of K5 (linear attention) and K3 (GroupNorm + FiLM +
SiLU) decides, and the arithmetic of their split reductions, on the CPU:

- K5's chunk plan (``attention.la_chunk_plan``) and K3's cluster plans
  (``unet2d_blocks.gn_cluster_plan``; the bf16-activation K3's
  ``gn_bf16_plan``, its cluster size) at every main-path shape of
  the Burgers UNet2D at batch 50, 16 and 1;
- K5's chunked context (per-chunk partials merged in chunk order with the
  online-softmax rescale, ``linear_attention_chunked_emulated``) against
  ``linear_attention_block_plain`` and the Pallas kernel in interpret mode,
  with token counts that are not a multiple of the chunk;
- K3's statistics (per-CTA partials merged with Chan's formula in rank
  order, ``group_norm_cluster_emulated``) against ``group_norm_act_plain``
  and the Pallas ``_group_norm``, and the bf16-activation K3's cut (slices
  of 8-value vectors, up to 8 CTAs) against ``group_norm_act_bf16_plain``;
- the bf16-activation K5's order (``linear_attention_bf16act_emulated``:
  per-tile k maxima, the cluster ranks' sums and context partials added in
  rank order) against flax's bf16 block and ``_linear_bf16_plain``, and its
  host plan (``bf16act_plan``) at the main-path shapes.

Tolerances (max |port - ref| <= rtol * max(1, max |ref|)): 1e-5 for the
emulations against the plain versions and JAX, float32 on every side, sums
in another order only. The kernels themselves run on the card
(test_torch_port_cuda.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from diffphycon_tpu.research import pallas_unet2d as pu
from diffphycon_tpu_torch.kernels import attention as ka
from diffphycon_tpu_torch.kernels import unet2d_blocks as kb
from torch_port_helpers import assert_close, rand

RTOL = 1e-5
BF16_BLOCK_RTOL = 1e-2  # one flax bf16 block (tests/test_torch_port_bf16_flax_unet2d.py)


@pytest.fixture(autouse=True)
def _interpret():
    pu.set_interpret(True)
    yield
    pu.set_interpret(False)


def _sites(batch, kind):
    return sorted({a for k, a, _ in chip_smoke.main_path_calls(64, (1, 2, 4, 8), batch)
                   if k == kind})


@pytest.mark.parametrize("batch,bf16", [pytest.param(b, bf, id=f"{b}-bf16" if bf else str(b))
                                        for bf in (False, True) for b in (50, 16, 1)])
def test_port_la_chunk_plan_at_main_path_shapes(batch, bf16):
    """Chunks of whole 64-token tiles, at most 256 tokens, that cover the
    sample with none empty; one wave of CTAs unless the smallest chunk
    cannot give one; the heads split over two CTAs while that leaves SMs
    idle, and under the bf16 variant also wherever C > 256 (its resident
    k | v columns: at most 128 KB)."""
    for b, h, w, c in _sites(batch, "linear_attention_block"):
        n = h * w
        chunk, S = ka.la_chunk_plan(b, n)
        assert chunk % ka.LA_TILE == 0 and chunk in ka.LA_CHUNKS
        assert (S - 1) * chunk < n <= S * chunk
        assert b * S >= kb.SM_COUNT or chunk == ka.LA_CHUNKS[-1], (b, n, chunk, S)
        if chunk < ka.LA_CHUNKS[0]:  # a larger chunk would not fill the wave
            assert b * math.ceil(n / (2 * chunk)) < kb.SM_COUNT
        groups = ka.la_head_groups(b, S, C=c, bf16=bf16)
        assert groups in (1, 2)
        assert (groups == 2) == (2 * b * S <= kb.SM_COUNT or (bf16 and c > 256))
        assert ka._linear_shapes((b, h, w, c), bf16)[0] == (b, n, c, S, chunk, groups)
        if bf16:  # the resident k | v stages of a CTA, 64 k x 64 columns each
            assert -(-c // 64) * (4 // groups) * 64 * 64 * 2 <= 128 * 1024
            # K5b over the flattened tokens: 32-token tiles where twice as many
            # still fit one wave, else 64; one CTA an SM where the tiles
            # outnumber them and C <= 128, else one a tile
            tr, ctas = ka.la_output_plan(b, n, c)
            assert tr == (32 if 2 * -(-b * n // 64) <= kb.SM_COUNT else 64)
            tiles = -(-b * n // tr)
            assert ctas == (kb.SM_COUNT if c <= 128 and tiles > kb.SM_COUNT else tiles)
            if batch == 50 and n == 32:  # the 32-token sites: 50 tiles of 32
                assert (tr, ctas) == (32, 50)
            # the bf16-activation K5: K5a's head groups, K5b's clusters of
            # shares of whole 64-token tiles, no rank empty, at most 8
            groups, cs, share = ka.bf16act_plan(b, n, c)
            tiles = b * -(-n // 64)
            assert groups == (2 if c > 256 or 2 * tiles <= kb.SM_COUNT else 1)
            assert 1 <= cs <= 8 and share % 64 == 0 and (cs - 1) * share < n <= cs * share
            assert cs <= min(8, -(-n // 256))  # ~256 tokens a rank
    if batch == 50:
        plans = {h * w: ka.la_chunk_plan(50, h * w)
                 for _, h, w, _ in _sites(50, "linear_attention_block")}
        assert plans == {2048: (256, 8), 512: (128, 4), 128: (64, 2), 32: (64, 1)}
        groups = {n: ka.la_head_groups(50, S, C=256, bf16=bf16) for n, (_, S) in plans.items()}
        assert groups == {2048: 1, 512: 1, 128: 1, 32: 2}  # 50 CTAs doubled
        if bf16:  # wider than 256 channels: two heads a CTA whatever the wave
            assert ka.la_head_groups(50, 8, C=512, bf16=True) == 2
            plans = {(h * w, c): ka.bf16act_plan(50, h * w, c)
                     for _, h, w, c in _sites(50, "linear_attention_block")}
            assert plans == {(2048, 64): (1, 8, 256), (512, 64): (1, 2, 256),
                             (512, 128): (1, 2, 256), (128, 128): (1, 1, 128),
                             (128, 256): (1, 1, 128), (32, 256): (2, 1, 64),
                             (32, 512): (2, 1, 64)}


@pytest.mark.parametrize("batch", [50, 16, 1])
def test_port_gn_cluster_plan_at_main_path_shapes(batch):
    """Clusters of 1-8 CTAs; one CTA per SM unless the largest cluster
    cannot reach it; each CTA's slice held in shared memory at every
    main-path shape but the widest level (512 KB rows: 64 KB slices, of
    which a CTA holds 52 KB, so that four fit on an SM)."""
    for b, h, w, c, _ in _sites(batch, "group_norm_act"):
        length = h * w * c
        cs = kb.gn_cluster_plan(b, length)
        assert cs in (1, 2, 4, kb.GN_MAX_CLUSTER)
        assert math.ceil(length / cs) <= kb.GN_HELD_FLOATS or length == 16 * 128 * 64
        assert b * cs >= kb.GN_MIN_CTAS or cs == kb.GN_MAX_CLUSTER
    assert kb.gn_cluster_plan(50, 16 * 128 * 64) == 8  # 512 KB rows: 64 KB slices
    assert kb.gn_cluster_plan(50, 8 * 64 * 128) == 8  # 32 KB slices: six CTAs per SM
    assert kb.gn_cluster_plan(50, 2 * 16 * 512) == 4  # 16 KB slices, 200 CTAs
    assert kb.gn_cluster_plan(400, 4096) == 1
    assert kb.gn_cluster_plan(1, 10 ** 6) == 8  # mostly read from device memory


@pytest.mark.parametrize("batch", [50, 16, 1])
def test_port_gn_bf16_plan_at_main_path_shapes(batch):
    """The bf16-activation K3's plan: the fewest of 1, 2, 4, 8 CTAs a
    cluster that give one CTA per SM, else 8, whether or not a CTA then
    holds its whole slice; one wave at two CTAs an SM. At batch 50 every
    site takes 4-CTA clusters (200 CTAs), the widest level too (64 KB
    slices, 52 KB held: 8-CTA clusters would take 400 CTAs). The launch's
    plan (``_gn_plan``) carries it, the fp32 K3's its own."""
    for b, h, w, c, _ in _sites(batch, "group_norm_act"):
        cs = kb.gn_bf16_plan(b, h * w * c)
        assert cs in (1, 2, 4, kb.GN_MAX_CLUSTER)
        assert b * cs >= kb.GN_MIN_CTAS or cs == kb.GN_MAX_CLUSTER
        assert cs == 1 or b * (cs // 2) < kb.GN_MIN_CTAS
        assert b * cs <= 2 * kb.SM_COUNT
        if batch == 50:
            assert cs == 4
    assert kb._gn_plan((50, 16, 128, 64), 1, True) == (50, 2048, 64, 4)
    assert kb._gn_plan((3, 16, 128, 64), 2, True) == (3, 2048, 64, 8)
    assert kb._gn_plan((50, 16, 128, 64), 1) == (50, 2048, 64, 8)


def _la_params(c, seed=0):
    p = {"norm_g": 1 + 0.1 * rand(c, seed=seed),
         "wqkv": rand(c, 384, seed=seed + 1) / np.sqrt(c),
         "wo": rand(128, c, seed=seed + 2) / np.sqrt(128), "bo": 0.1 * rand(c, seed=seed + 3),
         "out_g": 1 + 0.1 * rand(c, seed=seed + 4)}
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("shape,chunk", [((2, 5, 20, 16), 64), ((3, 4, 33, 32), 64),
                                         ((2, 8, 40, 8), 128), ((1, 4, 16, 24), 256)])
def test_port_chunked_linear_attention_matches_plain_and_pallas(shape, chunk):
    """n = 100, 132, 320, 64 tokens: a ragged last chunk (36, 4, 64) and one
    chunk that holds the whole sample. x is shifted so that k's max moves
    between chunks."""
    x = 2 * rand(*shape, seed=7) + 0.3
    x[:, -1] += 3.0  # the last rows' k dominate: the merge must rescale
    p = _la_params(shape[-1])
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    out = ka.linear_attention_chunked_emulated(torch.from_numpy(x), tp, chunk)
    assert_close(out, ka.linear_attention_block_plain(torch.from_numpy(x), tp), RTOL)
    ref = pu.linear_attention_block(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    assert_close(out, ref, RTOL)


@pytest.mark.parametrize("shape,plan", [((2, 5, 20, 8), (2, 64)), ((2, 8, 40, 16), (2, 192)),
                                        ((1, 4, 33, 512), (3, 64)), ((3, 16, 48, 8), None)])
def test_port_bf16act_cluster_order_matches_flax_and_plain(shape, plan):
    """The bf16-activation K5's order (``linear_attention_bf16act_emulated``:
    k's max from the 64-token tiles' maxima, the exps' sums and the context
    partials per cluster rank added in rank order) on n = 100, 320, 132
    and 768 tokens: ranks of 64 tokens (the last 36), a ragged last rank
    (128 of 192), a 4-token last rank at C = 512, and the host's plan
    (``bf16act_plan``: 3 ranks of 256). Against flax's bf16
    LinearAttentionBlock (``dtype=bfloat16``, the result stored bf16) within
    BF16_BLOCK_RTOL, the flax file's block bound, and against
    ``_linear_bf16_plain`` within chip_smoke.BF16ACT_KERNEL_RTOL: the
    same rounding points, the fp32 sums in another order. x's last row is
    shifted so that k's max lies in one tile and one rank."""
    from diffphycon_tpu.nets import blocks as JB

    b, h, w, c = shape
    x = jnp.asarray(2 * rand(*shape, seed=5) + 0.3).astype(jnp.bfloat16)
    x = x.at[:, -1].add(3.0)
    p = {"norm_g": 1 + 0.1 * rand(c, seed=1), "wqkv": rand(c, 384, seed=2) / np.sqrt(c),
         "wo": rand(128, c, seed=3) / np.sqrt(128), "bo": 0.1 * rand(c, seed=4),
         "out_g": 1 + 0.1 * rand(c, seed=6)}
    tree = {"params": {"norm": {"g": p["norm_g"]}, "attn": {
        "to_qkv": {"kernel": p["wqkv"][None, None]},
        "to_out": {"kernel": p["wo"][None, None], "bias": p["bo"]},
        "out_norm": {"g": p["out_g"]}}}}
    ref = JB.LinearAttentionBlock(c, 4, 32, dtype=jnp.bfloat16).apply(tree, x)
    ref = np.asarray(ref.astype(jnp.bfloat16).astype(jnp.float32))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tp["wqkv"], tp["wo"] = tp["wqkv"].to(torch.bfloat16), tp["wo"].to(torch.bfloat16)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    cs, share = plan or ka.bf16act_plan(b, h * w, c)[1:]
    assert (cs - 1) * share < h * w <= cs * share
    out = ka.linear_attention_bf16act_emulated(xt, tp, cs, share)
    assert out.dtype == torch.bfloat16
    assert_close(out.float(), ref, BF16_BLOCK_RTOL)
    assert_close(out.float(), ka.linear_attention_block_plain(xt, tp).float(),
                 chip_smoke.BF16ACT_KERNEL_RTOL)


@pytest.mark.parametrize("shape,groups,cluster", [((2, 4, 8, 16), 1, 8), ((2, 4, 8, 16), 2, 3),
                                                  ((3, 2, 6, 32), 4, 4), ((1, 1, 1, 8), 1, 8)])
def test_port_cluster_group_norm_matches_plain_and_pallas(shape, groups, cluster):
    """The statistics of K3's cluster merge: slices of whole float4 vectors
    per CTA (the last case has 2 vectors for 8 CTAs, so 6 slices are empty
    and skipped), merged in rank order, then the plain affine, FiLM and
    SiLU."""
    x = 2 * rand(*shape, seed=3) + 0.5
    c = shape[-1]
    gamma, beta = 1 + 0.1 * rand(c, seed=4), 0.1 * rand(c, seed=5)
    ss = 0.5 * rand(shape[0], 2 * c, seed=6)
    xt = torch.from_numpy(x)
    mean, rstd = kb.group_norm_cluster_emulated(xt, groups, cluster)
    b, h, w, _ = shape
    g = xt.reshape(b, h * w, groups, c // groups)
    gn = ((g - mean[:, None, :, None]) * rstd[:, None, :, None]).reshape(shape)
    gn = gn * torch.from_numpy(gamma) + torch.from_numpy(beta)
    ref_gn = pu._group_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups)
    assert_close(gn, ref_gn, RTOL)
    sst = torch.from_numpy(ss)
    y = gn * (sst[:, None, None, :c] + 1.0) + sst[:, None, None, c:]
    y = y * torch.sigmoid(y)
    plain = kb.group_norm_act_plain(xt, torch.from_numpy(gamma), torch.from_numpy(beta), groups,
                                    ss=sst)
    assert_close(y, plain, RTOL)


@pytest.mark.parametrize("shape,groups,cluster", [((2, 4, 8, 16), 1, 8), ((2, 4, 8, 16), 2, 3),
                                                  ((3, 2, 6, 32), 4, 6), ((1, 1, 3, 8), 1, 8),
                                                  ((4, 2, 16, 64), 1, 4)])
def test_port_cluster_group_norm_bf16_cut_matches_plain(shape, groups, cluster):
    """The bf16-activation K3's cut: slices of whole 8-value vectors per
    CTA, up to 8 CTAs (the fourth case has 3 vectors for 8 CTAs, so 5
    slices are empty and skipped), merged with
    Chan's formula in rank order. Its statistics against the plain
    version's float32 ones (1e-5), and flax's bf16 affine, FiLM and SiLU on
    them against group_norm_act_bf16_plain (BF16ACT_KERNEL_RTOL: the kernel's
    own bound, a rounding flip or two)."""
    b, h, w, c = shape
    x = torch.from_numpy(2 * rand(*shape, seed=7) + 0.5).to(torch.bfloat16)
    gamma = torch.from_numpy(1 + 0.1 * rand(c, seed=8))
    beta = torch.from_numpy(0.1 * rand(c, seed=9))
    ss = torch.from_numpy(0.5 * rand(b, 2 * c, seed=10)).to(torch.bfloat16)
    mean, rstd = kb.group_norm_cluster_emulated(x.float(), groups, cluster, vec=8)
    g = x.float().reshape(b, h * w, groups, c // groups)
    ref_mean = g.mean(dim=(1, 3))
    ref_var = ((g - ref_mean[:, None, :, None]) ** 2).mean(dim=(1, 3))
    assert_close(mean, ref_mean, RTOL)
    assert_close(rstd, torch.rsqrt(ref_var + kb.GN_EPS), RTOL)
    mul = (rstd[:, :, None] * gamma.reshape(groups, c // groups)).reshape(b, 1, c)
    y = ((g - mean[:, None, :, None]).reshape(b, h * w, c) * mul).reshape(shape) + beta
    y = y.to(torch.bfloat16) * (ss[:, None, None, :c] + 1.0) + ss[:, None, None, c:]
    plain = kb.group_norm_act_bf16_plain(x, gamma, beta, groups, ss=ss)
    assert_close(kb.silu_bf16(y).float(), plain.float(), chip_smoke.BF16ACT_KERNEL_RTOL)
