"""The arithmetic and the host-side plan of K1 and K2's tensor-core core
(``csrc/igemm_tc.cuh``), on the CPU.

- ``tf32_split`` is the kernels' rounding (``cvt.rna.tf32.f32``): hi keeps 10
  explicit mantissa bits, ties go away from zero, hi + lo is x to 2^-22.
- The kernels' 3xTF32 products (lo*hi' + hi*lo' + hi*hi', fp32 sums),
  emulated with ``tf32_split`` and float32 matmuls over the K1/K2 gather,
  agree with the Pallas conv, upsample, concat, 1x1 and downsample kernels
  (interpret mode) within the kernels' tolerance at K up to 6912: the
  design's error budget fits ``chip_smoke.py``'s KERNEL_RTOL (1e-4).
- ``tile_plan`` covers K exactly and fills one wave of the card at every
  K1/K2 shape of the Burgers UNet2D at batch 50 (sampling) and 16
  (training), for the 3xTF32 core and for the bf16 core
  (``csrc/igemm_bf16.cuh``, ``tile_plan(..., bf16=True)``); the 3xTF32
  plans and the persistent kernel's tiles are those of before the bf16 plan.

- The bf16 core's sums (one float32 chain of exact bf16 products per split,
  the splits added in order), emulated on bf16-rounded operands over the
  same gathers, agree with the Pallas convs under bf16 weights within 1e-5
  at K up to 6912.
- K1c and K2c's persistent tile (``csrc/igemm_bf16act.cuh``): its plans
  cover K, its bf16 core plans stay pinned, its halo rule holds at every
  main-path signature, and its halo A tile, emulated (``halo_im2col``),
  reads the per-tap gather's values in the same k order.

The kernels themselves run only on an NVIDIA GPU: ``test_torch_port_cuda.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from diffphycon_tpu.research import pallas_unet2d as pu
from diffphycon_tpu_torch.kernels import unet2d_blocks as kb
from torch_port_helpers import assert_close, rand

RTOL = chip_smoke.KERNEL_RTOL  # 1e-4, as on the card


@pytest.fixture(autouse=True)
def _interpret():
    pu.set_interpret(True)
    yield
    pu.set_interpret(False)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _from_bits(*words):
    return torch.tensor(np.array(words, dtype=np.uint32).view(np.int32)).view(torch.float32)


def test_port_tf32_split_keeps_10_bits_and_sums_back_to_x():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(20000)
                          * 10.0 ** rng.uniform(-30, 30, 20000)).astype(np.float32))
    hi, lo = kb.tf32_split(x)
    assert (_bits(hi) & 0x1FFF).eq(0).all() and (_bits(lo) & 0x1FFF).eq(0).all()
    x64 = x.double()
    assert ((hi.double() - x64).abs() <= 2.0 ** -11 * x64.abs()).all()
    assert ((hi.double() + lo.double() - x64).abs() <= 2.0 ** -22 * x64.abs()).all()
    assert torch.equal(torch.sign(hi), torch.sign(x))


@pytest.mark.parametrize("sign", [0, 0x80000000])
def test_port_tf32_split_rounds_ties_away_from_zero(sign):
    # 1 + 2^-11 is halfway between two TF32 values; so are the others with
    # low bits 0x1000. cvt.rna takes the larger magnitude.
    x = _from_bits(*(sign | w for w in (0x3F801000, 0x3F803000, 0x3F800FFF, 0x3F801001,
                                        0x3FFFF000, 0x00001000)))
    want = _from_bits(*(sign | w for w in (0x3F802000, 0x3F804000, 0x3F800000, 0x3F802000,
                                           0x40000000, 0x00002000)))
    hi, _ = kb.tf32_split(x)
    assert torch.equal(_bits(hi), _bits(want))


def _tc3(a, w):
    """a @ w as the kernels compute it: 3xTF32 products, fp32 sums."""
    ah, al = kb.tf32_split(a)
    wh, wl = kb.tf32_split(w)
    return al @ wh + ah @ wl + ah @ wh


def _conv_gather(x_a, x_b, k, upsample):
    """The (M, K) im2col matrix K1 gathers, K ordered (dy*k + dx)*Ci + c."""
    x = kb._conv_input(x_a, x_b, upsample)
    B, H, W, ci = x.shape
    p = (k - 1) // 2
    xp = F.pad(x, (0, 0, p, k - 1 - p, p, k - 1 - p))
    taps = [xp[:, dy:dy + H, dx:dx + W, :].reshape(B * H * W, ci)
            for dy in range(k) for dx in range(k)]
    return torch.cat(taps, dim=1), (B, H, W)


@pytest.mark.parametrize("ca,cb,k,up", [(768, 0, 3, False),   # K = 6912
                                        (512, 256, 3, False),  # the skip concat, K = 6912
                                        (512, 256, 1, False),  # _matmul_bias_kernel
                                        (512, 0, 3, True)])    # _upsample_kernel, K = 4608
def test_port_3xtf32_conv_emulation_matches_pallas(ca, cb, k, up):
    co = 16
    xa, xb = rand(2, 2, 8, ca, seed=1), rand(2, 2, 8, cb, seed=2) if cb else None
    w = rand(k * k, ca + cb, co, seed=3) / np.float32(np.sqrt(k * k * (ca + cb)))
    b = 0.1 * rand(co, seed=4)
    p = {"w": jnp.asarray(w if k == 3 else w[0]), "b": jnp.asarray(b)}
    xin = jnp.asarray(xa) if xb is None else pu.concat_channels(jnp.asarray(xa), jnp.asarray(xb))
    ref = pu.upsample(xin, p) if up else pu.conv(xin, p, k, k)
    a, (B, H, W) = _conv_gather(torch.from_numpy(xa), None if xb is None else torch.from_numpy(xb),
                                k, up)
    out = _tc3(a, torch.from_numpy(w).reshape(-1, co)) + torch.from_numpy(b)
    assert_close(out.reshape(B, H, W, co), ref, RTOL)


def test_port_3xtf32_downsample_emulation_matches_pallas():
    x = rand(2, 4, 16, 128)
    w, b = rand(4, 128, 64, seed=1) / np.float32(np.sqrt(512)), 0.1 * rand(64, seed=2)
    ref = pu.downsample(jnp.asarray(x), {"w": jnp.asarray(w), "b": jnp.asarray(b)})
    x6 = torch.from_numpy(x).reshape(2, 2, 2, 8, 2, 128).permute(0, 1, 3, 2, 4, 5)
    out = _tc3(x6.reshape(32, 512), torch.from_numpy(w).reshape(512, 64)) + torch.from_numpy(b)
    assert_close(out.reshape(2, 2, 8, 64), ref, RTOL)


BF16_CHAIN_RTOL = 1e-5  # the bf16 core's aim at K = 6912 (csrc/igemm_bf16.cuh, point 4)


def _bf16_chains(a, w, splits):
    """a @ w as the bf16 core (csrc/igemm_bf16.cuh) sums it: a rounded to
    bf16 (nearest even) against the bf16 weight, exact products, each
    split's 64-deep stages summed in float32 as one chain, the splits'
    partials added in split order."""
    a, w = kb.bf16_operands(a, w)
    stages = math.ceil(a.shape[1] / kb.TC_BK_BF16)
    per = math.ceil(stages / splits)
    out = None
    for z in range(math.ceil(stages / per)):
        lo, hi = z * per * kb.TC_BK_BF16, (z + 1) * per * kb.TC_BK_BF16
        part = a[:, lo:hi] @ w[lo:hi]
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("splits", [1, 5])
@pytest.mark.parametrize("ca,cb,k,up", [(768, 0, 3, False),   # K = 6912
                                        (512, 256, 3, False),  # the skip concat, K = 6912
                                        (512, 256, 1, False),  # _matmul_bias_kernel
                                        (512, 0, 3, True)])    # _upsample_kernel, K = 4608
def test_port_bf16_conv_emulation_matches_pallas(ca, cb, k, up, splits):
    """The bf16 core's chains (one per split of 64-deep stages, no rounded
    add between stages) against the Pallas conv kernels under bf16 weights
    (interpret mode) at K up to 6912, within BF16_CHAIN_RTOL: the two differ
    in the order of float32 sums alone."""
    co = 16
    xa, xb = rand(2, 2, 8, ca, seed=1), rand(2, 2, 8, cb, seed=2) if cb else None
    w = rand(k * k, ca + cb, co, seed=3) / np.float32(np.sqrt(k * k * (ca + cb)))
    b = 0.1 * rand(co, seed=4)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    wj = wb if k == 3 else wb[0]
    p = {"w": jnp.asarray(wj.float().numpy(), dtype=jnp.bfloat16), "b": jnp.asarray(b)}
    xin = jnp.asarray(xa) if xb is None else pu.concat_channels(jnp.asarray(xa), jnp.asarray(xb))
    ref = pu.upsample(xin, p) if up else pu.conv(xin, p, k, k)
    a, (B, H, W) = _conv_gather(torch.from_numpy(xa), None if xb is None else torch.from_numpy(xb),
                                k, up)
    out = _bf16_chains(a, wb.reshape(-1, co), splits) + torch.from_numpy(b)
    assert_close(out.reshape(B, H, W, co), ref, BF16_CHAIN_RTOL)


def test_port_bf16_downsample_emulation_matches_pallas():
    x = rand(2, 4, 16, 128)
    w, b = rand(4, 128, 64, seed=1) / np.float32(np.sqrt(512)), 0.1 * rand(64, seed=2)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    p = {"w": jnp.asarray(wb.float().numpy(), dtype=jnp.bfloat16), "b": jnp.asarray(b)}
    ref = pu.downsample(jnp.asarray(x), p)
    x6 = torch.from_numpy(x).reshape(2, 2, 2, 8, 2, 128).permute(0, 1, 3, 2, 4, 5)
    out = _bf16_chains(x6.reshape(32, 512), wb.reshape(512, 64), 1) + torch.from_numpy(b)
    assert_close(out.reshape(2, 2, 8, 64), ref, BF16_CHAIN_RTOL)


def _gemm_shapes(batch):
    """(m, n, k) of every K1 and K2 signature of the Burgers UNet2D."""
    return sorted({chip_smoke.gemm_dims(name, args)
                   for name, args, _ in chip_smoke.main_path_calls(64, (1, 2, 4, 8), batch)
                   if name in chip_smoke.TC_KERNELS})


@pytest.mark.parametrize("bf16", [False, True, "act"])
@pytest.mark.parametrize("batch", [50, 16])
def test_port_tile_plan_covers_k_and_fills_a_wave(batch, bf16):
    """The 3xTF32 core's plans (32-deep slices, TC_TILES) and the bf16
    core's (64-deep stages, TC_TILES_BF16): the splits cover K once, and
    the CTAs fill a wave wherever the splits allow it. "act": the persistent
    tile's plans (K1c and K2c, ``tile_plan(..., True, True)`` over
    TC_TILES_BF16ACT) cover K once, and their grid (``act_ctas``) is whole
    column groups, at most one CTA an SM and no CTA without a row tile."""
    if bf16 == "act":
        for m, n, k in _gemm_shapes(batch):
            plan = kb.tile_plan(m, n, k, True, True)
            assert (plan.bm, plan.bn) in kb.TC_TILES_BF16ACT, (m, n, k, plan)
            stages = math.ceil(k / kb.TC_BK_BF16)
            ranges = [(z * plan.per, min((z + 1) * plan.per, stages))
                      for z in range(plan.splits)]
            assert all(lo < hi for lo, hi in ranges) and ranges[-1][1] == stages
            assert plan.splits == 1 or plan.per >= kb.MIN_SLICES_PER_SPLIT
            groups = math.ceil(n / plan.bn) * plan.splits
            ctas = kb.act_ctas(plan, m, n)
            assert ctas % groups == 0 and ctas // groups <= math.ceil(m / plan.bm)
            assert ctas <= max(kb.SM_COUNT, groups), (m, n, k, plan, ctas)
            assert kb.act_rounds(plan, m, n) * ctas // groups >= math.ceil(m / plan.bm)
        return
    tiles, bk = (kb.TC_TILES_BF16, kb.TC_BK_BF16) if bf16 else (kb.TC_TILES, kb.TC_BK)
    shapes = _gemm_shapes(batch)
    assert len(shapes) >= 15
    for m, n, k in shapes:
        plan = kb.tile_plan(m, n, k, bf16)
        assert (plan.bm, plan.bn) in tiles, (m, n, k, plan)
        slices = math.ceil(k / bk)
        # split z walks K slices [z * per, min((z + 1) * per, slices)): all
        # non-empty, disjoint, together exactly [0, K)
        ranges = [(z * plan.per, min((z + 1) * plan.per, slices)) for z in range(plan.splits)]
        assert all(lo < hi for lo, hi in ranges)
        assert ranges[0][0] == 0 and ranges[-1][1] == slices
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert plan.splits == 1 or plan.per >= kb.MIN_SLICES_PER_SPLIT
        most = plan.ctas(m, n) // plan.splits * max(1, slices // kb.MIN_SLICES_PER_SPLIT)
        # a wave: 3xTF32, one CTA per SM; bf16 (picked by the modelled time
        # alone), three quarters of the tile's CTA slots
        wave = 0.75 * kb.SM_COUNT * tiles[plan.bm, plan.bn][2] if bf16 else kb.SM_COUNT
        assert plan.ctas(m, n) >= wave or most < wave, (m, n, k, plan)
        assert plan.bn == 64 or n > plan.bn // 2
        want_ws = plan.splits * m * n if plan.splits > 1 else 0
        assert plan.workspace_floats(m, n) == want_ws
    if not bf16:  # the 2 x 16 level needs split-K to fill the card
        assert kb.tile_plan(batch * 32, 512, 4608).splits > 1


# the 3xTF32 plans at every K1/K2 GEMM of the batch-50 forward, as they were
# before the bf16 core had a plan of its own: (m, n, k) -> (bm, bn, splits,
# per)
FP32_PLANS_B50 = {
    (1600, 256, 512): (64, 64, 2, 8), (1600, 256, 2304): (128, 128, 9, 8),
    (1600, 512, 768): (128, 128, 5, 5), (1600, 512, 2304): (128, 128, 5, 15),
    (1600, 512, 4608): (128, 128, 5, 29), (1600, 512, 6912): (128, 128, 5, 44),
    (6400, 128, 256): (64, 64, 1, 8), (6400, 128, 1152): (128, 128, 5, 8),
    (6400, 256, 384): (128, 128, 2, 6), (6400, 256, 2304): (128, 128, 5, 15),
    (6400, 256, 3456): (128, 128, 5, 22), (6400, 256, 4608): (128, 128, 5, 29),
    (25600, 64, 256): (128, 64, 1, 8), (25600, 64, 576): (128, 64, 1, 18),
    (25600, 128, 192): (128, 128, 1, 6), (25600, 128, 1152): (128, 128, 3, 12),
    (25600, 128, 1728): (128, 128, 3, 18), (25600, 128, 2304): (128, 128, 3, 24),
    (102400, 64, 128): (128, 64, 1, 4), (102400, 64, 576): (128, 64, 1, 18),
    (102400, 64, 1152): (128, 64, 1, 36)}


def test_port_fp32_plans_and_mega_tiles_unchanged_by_the_bf16_plan():
    """The bf16 plan is keyed apart: the 3xTF32 K1/K2 plans and the
    persistent kernel's tiles (MEGA_TILES, from TC_TILES) stay as they were."""
    from diffphycon_tpu_torch.kernels import unet2d_mega as km

    assert {s: tuple(kb.tile_plan(*s)) for s in _gemm_shapes(50)} == FP32_PLANS_B50
    assert all(kb.tile_plan(*s, False) == kb.tile_plan(*s) for s in FP32_PLANS_B50)
    assert km.MEGA_TILES == {(128, 128): (2.27, 1.94, 1), (128, 64): (1.57, 1.43, 1)}
    assert any(kb.tile_plan(*s, True) != kb.tile_plan(*s) for s in FP32_PLANS_B50)


# the bf16 core's plans (K1b, K2b) at every K1/K2 GEMM of the batch-50
# forward, as they were before K1c and K2c had a plan of their own: (m, n,
# k) -> (bm, bn, splits, per)
BF16_PLANS_B50 = {
    (1600, 256, 512): (64, 64, 2, 4), (1600, 256, 2304): (128, 128, 5, 8),
    (1600, 512, 768): (128, 64, 1, 12), (1600, 512, 2304): (128, 128, 2, 18),
    (1600, 512, 4608): (128, 256, 5, 15), (1600, 512, 6912): (128, 256, 5, 22),
    (6400, 128, 256): (64, 64, 1, 4), (6400, 128, 1152): (128, 128, 2, 9),
    (6400, 256, 384): (128, 128, 1, 6), (6400, 256, 2304): (128, 256, 2, 18),
    (6400, 256, 3456): (128, 256, 2, 27), (6400, 256, 4608): (128, 256, 2, 36),
    (25600, 64, 256): (64, 64, 1, 4), (25600, 64, 576): (128, 64, 1, 9),
    (25600, 128, 192): (128, 128, 1, 3), (25600, 128, 1152): (128, 128, 1, 18),
    (25600, 128, 1728): (128, 128, 1, 27), (25600, 128, 2304): (128, 128, 1, 36),
    (102400, 64, 128): (64, 64, 1, 2), (102400, 64, 576): (128, 64, 1, 9),
    (102400, 64, 1152): (128, 64, 1, 18)}


def test_port_bf16_plans_unchanged_by_the_bf16act_plan():
    """K1c's and K2c's plan (``act``) is keyed apart: the bf16 core's K1b /
    K2b plans and the 3xTF32 ones stay as they were, and its tiles are the
    persistent tile's 128-row ones."""
    assert {s: tuple(kb.tile_plan(*s, True)) for s in _gemm_shapes(50)} == BF16_PLANS_B50
    assert {s: tuple(kb.tile_plan(*s)) for s in _gemm_shapes(50)} == FP32_PLANS_B50
    assert all(kb.tile_plan(*s, True, False) == kb.tile_plan(*s, True) for s in BF16_PLANS_B50)
    assert all(kb.tile_plan(*s, True, True).bm == 128 for s in BF16_PLANS_B50)


# (args of conv2d_nhwc at batch 50) -> (halo_boxes, bf16act_layout's mode
# under the module's plan): halo tiles at the 16 x 128 and 8 x 64 levels'
# 3x3 convs, unless their halos and weights outgrow shared memory (where
# the weights then fit beside per-tap boxes, those: the 16 x 128 skip concat)
HALO_B50 = {
    (50, 16, 128, 64, 0, 64, 3, False): ((128, 1), "halo"),
    (50, 16, 128, 64, 64, 64, 3, False): ((128, 1), "boxes"),
    (50, 8, 64, 64, 0, 64, 3, False): ((64, 2), "halo"),
    (50, 8, 64, 128, 0, 128, 3, False): ((64, 2), "halo"),
    (50, 8, 64, 128, 64, 128, 3, False): ((64, 2), "boxes"),
    (50, 16, 128, 64, 64, 64, 1, False): (None, "boxes"),
    (50, 8, 64, 128, 64, 128, 1, False): (None, "boxes"),
    (50, 8, 64, 128, 0, 64, 3, True): (None, "boxes"),
    (50, 4, 32, 256, 0, 128, 3, True): (None, "boxes"),
    (50, 4, 32, 128, 0, 128, 3, False): (None, "boxes"),
    (50, 2, 16, 512, 256, 512, 3, False): (None, "boxes")}


def test_port_bf16act_halo_boxes_at_every_main_path_signature():
    """``halo_boxes`` (the launch's halo rule) and ``bf16act_layout`` at every
    K1c / K2c signature of the batch-50 forward: a halo exactly where the
    grid is whole 64-pixel runs of rows (16 x 128, 8 x 64) under a 3x3 conv
    that is not upsampled, boxes everywhere else (every channel count is a
    multiple of 64, so no main-path launch gathers), and every layout within
    the card's shared memory."""
    seen = set()
    for name, args, _ in chip_smoke.main_path_calls(64, (1, 2, 4, 8), 50):
        if name not in chip_smoke.TC_KERNELS or (name, args) in seen:
            continue
        seen.add((name, args))
        plan = kb.tile_plan(*chip_smoke.gemm_dims(name, args), True, True)
        lay = kb.bf16act_layout(name, args, plan)
        if name == "downsample_nhwc":
            assert lay["mode"] == "boxes", (args, lay)
            continue
        b_, h, w, ca, cb, co, k, up = args
        hb = kb.halo_boxes(h, w, ca, cb, k, up)
        assert hb == ((128, 1) if (h, w) == (16, 128) and k == 3 and not up else
                      (64, 2) if (h, w) == (8, 64) and k == 3 and not up else None), args
        if args in HALO_B50:
            assert (hb, lay["mode"]) == HALO_B50[args], (args, lay)
        assert lay["mode"] in ("halo", "boxes"), (args, lay)
        assert lay["ring"] >= (0 if lay["mode"] == "halo" and lay["hold"] else 3), (args, lay)
    assert len(seen) == 22


@pytest.mark.parametrize("args", [(2, 16, 128, 64, 0), (1, 16, 128, 64, 64),
                                  (2, 8, 64, 64, 0), (1, 8, 64, 128, 64),
                                  (1, 5, 256, 64, 0), (2, 6, 64, 8, 16)])
def test_port_bf16act_halo_emulation_equals_the_per_tap_gather(args):
    """The halo A tile as the persistent tile reads it (``halo_im2col``: one
    (bh + 2) x (bw + 2) box a tile, zeros outside the image, the nine taps
    views from ``halo_view_start``) equals the per-tap gather, so its
    tap-major float32 chain (``_bf16_chains``, one split and three) is the
    parent's bit for bit, and with flax's epilogue it agrees with
    ``conv2d_nhwc_plain`` on bf16 input within a bf16 step
    (chip_smoke.BF16ACT_KERNEL_RTOL): at the 16 x 128 and 8 x 64 levels'
    shapes, two sources, two tiles a row (W = 256), rows not a multiple of
    the tile's, and channels off the 64-channel blocks."""
    b_, h, w, ca, cb = args
    bw, bh = (128, 1) if w % 128 == 0 else (64, 2)
    co = 16
    bf = torch.bfloat16
    xa = torch.from_numpy(rand(b_, h, w, ca, seed=5)).to(bf)
    xb = torch.from_numpy(rand(b_, h, w, cb, seed=6)).to(bf) if cb else None
    wt = (torch.from_numpy(rand(9 * (ca + cb), co, seed=7)) / math.sqrt(9 * (ca + cb))).to(bf)
    bias = torch.from_numpy(0.1 * rand(co, seed=8))
    a_halo = kb.halo_im2col(xa.float(), None if xb is None else xb.float(), bw, bh)
    a_gather, _ = _conv_gather(xa.float(), None if xb is None else xb.float(), 3, False)
    assert torch.equal(a_halo, a_gather)
    for splits in (1, 3):
        assert torch.equal(_bf16_chains(a_halo, wt, splits), _bf16_chains(a_gather, wt, splits))
    out = kb.conv_bias_bf16(_bf16_chains(a_halo, wt, 1), bias).reshape(b_, h, w, co)
    ref = kb.conv2d_nhwc_plain(xa, wt, bias, x_b=xb, k=3)
    assert out.dtype == bf and ref.dtype == bf
    assert_close(out.float(), ref.float(), chip_smoke.BF16ACT_KERNEL_RTOL)


def test_port_tile_plan_balances_waves():
    plan = kb.tile_plan(24, 4, 108)  # 4 slices: too few to split
    assert plan.splits == 1 and plan.workspace_floats(24, 4) == 0
    plan = kb.tile_plan(100, 40, 2304)  # few tiles, 72 slices: split to 4 each
    assert plan.per == 4 and plan.ctas(100, 40) < kb.SM_COUNT
    # 52 tiles of 128 x 128, 144 slices: 5 splits fill two waves (260 CTAs)
    # with 29 slices each; 3 splits (156 CTAs) would leave a second wave of 24
    plan = kb.tile_plan(1600, 512, 4608)
    assert plan == kb.TilePlan(128, 128, 5, 29) and plan.ctas(1600, 512) == 260
