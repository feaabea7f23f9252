"""The port's hand-written kernels against their plain versions on an
NVIDIA GPU (``cuda`` marker; skips without a GPU).

This file imports neither JAX nor ``diffphycon_tpu``, so it also runs where
only the port is installed:
``python -m pytest tests/test_torch_port_cuda.py -q -m cuda --noconftest``.

Tolerance: max |kernel - plain| <= 1e-4 * max(1, max |plain|); both are
fp32-accurate and differ in summation order (and, for K1 and K2, by the
~2^-22 relative term that 3xTF32 drops).
"""

import math

import pytest
import torch

import chip_smoke
from diffphycon_tpu_torch.kernels import unet2d_blocks as kb
from torch_port_helpers import assert_close

RTOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU interpret mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_port_kernels_match_plain_on_gpu(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def r(*s):
        return torch.randn(*s, generator=g, device=cuda_device)

    xa, xb = r(2, 8, 16, 32), r(2, 8, 16, 16)
    for k, up, src_b in [(3, False, None), (1, False, xb), (3, False, xb), (3, True, None)]:
        ci = 32 + (16 if src_b is not None else 0)
        w, b = r(k * k * ci, 24) / ci, r(24)
        assert_close(kb.conv2d_nhwc(xa, w, b, x_b=src_b, k=k, upsample=up),
                     kb.conv2d_nhwc_plain(xa, w, b, x_b=src_b, k=k, upsample=up), RTOL)
    w, b = r(128, 24) / 128, r(24)
    assert_close(kb.downsample_nhwc(xa, w, b), kb.downsample_nhwc_plain(xa, w, b), RTOL)
    gamma, beta, ss = r(32), r(32), r(2, 64)
    assert_close(kb.group_norm_act(xa, gamma, beta, 2, ss=ss, res=xa),
                 kb.group_norm_act_plain(xa, gamma, beta, 2, ss=ss, res=xa), RTOL)
    with pytest.raises(ValueError, match="multiples of 4"):
        kb.conv2d_nhwc(r(1, 4, 4, 6), r(54, 8), r(8))
    with pytest.raises(TypeError, match="float32"):
        kb.conv2d_nhwc(xa.double(), w.double(), b.double())


def _conv_case(g, device, b, h, w, ca, cb, co, k, up=False):
    def r(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=device) * scale

    ci = ca + cb
    return (r(b, h, w, ca), r(b, h, w, cb) if cb else None,
            r(k * k * ci, co, scale=(k * k * ci) ** -0.5), r(co, scale=0.1))


def _check_conv(case, k, up):
    xa, xb, w, b = case
    assert_close(kb.conv2d_nhwc(xa, w, b, x_b=xb, k=k, upsample=up),
                 kb.conv2d_nhwc_plain(xa, w, b, x_b=xb, k=k, upsample=up), RTOL)


@pytest.mark.cuda
def test_port_tc_convs_match_plain_at_main_path_signatures(cuda_device):
    """K1 and K2 (3xTF32 tensor cores) at every signature of the Burgers
    UNet2D forward at batch 50, each through its own tile plan (split-K at
    the small levels)."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    seen = set()
    for name, args, _ in chip_smoke.main_path_calls(64, (1, 2, 4, 8), 50):
        if name not in ("conv2d_nhwc", "downsample_nhwc") or (name, args) in seen:
            continue
        seen.add((name, args))
        if name == "conv2d_nhwc":
            b, h, w, ca, cb, co, k, up = args
            _check_conv(_conv_case(g, cuda_device, b, h, w, ca, cb, co, k), k, up)
        else:
            b, h, w, c, co = args
            x, _, wt, bias = _conv_case(g, cuda_device, b, h, w, c, 0, co, 2)
            assert_close(kb.downsample_nhwc(x, wt, bias), kb.downsample_nhwc_plain(x, wt, bias),
                         RTOL)
        torch.cuda.synchronize()
    assert len(seen) == 22


def _forced_plan(bm, bn, splits):
    def plan(m, n, k, bf16=False, act=False):
        slices = math.ceil(k / (kb.TC_BK_BF16 if bf16 else kb.TC_BK))
        per = math.ceil(slices / splits)
        return kb.TilePlan(bm, bn, math.ceil(slices / per), per)
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("bm,bn", kb.TC_TILES)
@pytest.mark.parametrize("splits", [1, 3])
def test_port_tc_convs_ragged_shapes_every_tile(cuda_device, monkeypatch, bm, bn, splits):
    """Every tile shape, with and without split-K, on shapes no tile
    divides: M not a multiple of BM, Co = 4, Ca = 4 with Cb = 8, k = 1, an
    odd upsampled source, Co = 136 over two N tiles, C = 4 downsampling."""
    monkeypatch.setattr(kb, "tile_plan", _forced_plan(bm, bn, splits))
    g = torch.Generator(device=cuda_device).manual_seed(8)
    for args in [(3, 5, 7, 4, 8, 4, 3), (3, 5, 7, 4, 8, 12, 1), (2, 9, 15, 36, 0, 136, 3),
                 (1, 3, 5, 8, 0, 20, 3, True), (2, 4, 4, 64, 32, 64, 1)]:
        k, up = args[6], bool(args[7:] and args[7])
        _check_conv(_conv_case(g, cuda_device, *args[:7]), k, up)
    for b, h, w, c, co in [(3, 6, 10, 4, 4), (2, 10, 18, 20, 72)]:
        x, _, wt, bias = _conv_case(g, cuda_device, b, h, w, c, 0, co, 2)
        assert_close(kb.downsample_nhwc(x, wt, bias), kb.downsample_nhwc_plain(x, wt, bias), RTOL)


@pytest.mark.cuda
def test_port_tc_split_k_launches_are_bit_equal(cuda_device):
    """No atomics: the split partials are added in a fixed order."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    assert kb.tile_plan(1600, 512, 6912).splits > 1 and kb.tile_plan(1600, 256, 512).splits > 1
    xa, xb, w, b = _conv_case(g, cuda_device, 50, 2, 16, 512, 256, 512, 3)
    one = kb.conv2d_nhwc(xa, w, b, x_b=xb)
    assert torch.equal(one, kb.conv2d_nhwc(xa, w, b, x_b=xb))
    x, _, wd, bd = _conv_case(g, cuda_device, 50, 4, 32, 128, 0, 256, 2)
    assert torch.equal(kb.downsample_nhwc(x, wd, bd), kb.downsample_nhwc(x, wd, bd))


@pytest.mark.cuda
def test_port_tc_conv_error_is_fp32_level_at_the_deepest_k(cuda_device):
    """At K = 6912 (the skip-concat conv of the 2 x 16 level) K1 stays within
    5e-6 relative of a float64 conv: the 3xTF32 products and the per-slice
    fp32 promotion (one accumulator over all of K on the tensor cores drifts
    further as K grows). A weight edited in place between two launches is
    read afresh."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    xa, xb, w, b = _conv_case(g, cuda_device, 8, 2, 16, 512, 256, 512, 3)
    ref = kb.conv2d_nhwc_plain(xa.double(), w.double(), b.double(), x_b=xb.double())
    scale = max(1.0, ref.abs().max().item())
    assert (kb.conv2d_nhwc(xa, w, b, x_b=xb).double() - ref).abs().max().item() <= 5e-6 * scale
    w.mul_(-0.5)
    assert_close(kb.conv2d_nhwc(xa, w, b, x_b=xb), kb.conv2d_nhwc_plain(xa, w, b, x_b=xb), RTOL)


@pytest.mark.cuda
def test_port_tc_conv_gradients_match_plain_on_gpu(cuda_device):
    """Gradients through the K1 and K2 forwards (their autograd Functions'
    backward is the plain VJP) against the plain versions'."""
    g = torch.Generator(device=cuda_device).manual_seed(10)
    for args, k, up in [((2, 4, 16, 64, 32, 48, 3), 3, False), ((2, 4, 8, 32, 0, 16, 3), 3, True)]:
        case = [t.requires_grad_(True) if t is not None else None
                for t in _conv_case(g, cuda_device, *args)]
        xa, xb, w, b = case
        with torch.no_grad():
            shape = kb.conv2d_nhwc_plain(xa, w, b, x_b=xb, k=k, upsample=up).shape
        seed = torch.randn(shape, generator=g, device=cuda_device)
        grads = []
        for fn in (kb.conv2d_nhwc, kb.conv2d_nhwc_plain):
            (fn(xa, w, b, x_b=xb, k=k, upsample=up) * seed).sum().backward()
            grads.append([t.grad.clone() for t in case if t is not None])
            for t in case:
                if t is not None:
                    t.grad = None
        for gk, gp in zip(*grads):
            assert_close(gk, gp, RTOL)
    x, _, w, b = [t.requires_grad_(True) if t is not None else None
                  for t in _conv_case(g, cuda_device, 2, 8, 16, 32, 0, 64, 2)]
    gk = torch.autograd.grad(kb.downsample_nhwc(x, w, b).square().sum(), (x, w, b))
    gp = torch.autograd.grad(kb.downsample_nhwc_plain(x, w, b).square().sum(), (x, w, b))
    for a, c in zip(gk, gp):
        assert_close(a, c, RTOL)


@pytest.mark.cuda
def test_port_cg_kernel_matches_plain_on_gpu(cuda_device):
    """K4 at the smoke path's batch and domain, and the autograd backward
    (the same solve on the incoming gradient). Iteration counts within 2%:
    sums in another order can move the step where max|r| drops below the
    accuracy."""
    from diffphycon_tpu_torch.kernels import cg_pressure as kcg
    from diffphycon_tpu_torch.physics.fluids import pressure, smoke_env

    coeffs = smoke_env.smoke_domain_128().laplacian_coeffs(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    div = torch.randn(8, 127, 127, generator=g, device=cuda_device)
    p, iters = kcg.cg_pressure(div, coeffs, 1e-6, 500)
    p_plain, iters_plain = kcg.cg_pressure_plain(div, coeffs, 1e-6, 500)
    assert_close(p, p_plain, RTOL)
    assert ((iters - iters_plain).abs() <= (0.02 * iters_plain).ceil()).all(), (iters, iters_plain)
    assert (iters > 0).all() and (iters < 500).all()

    w = torch.randn(8, 127, 127, generator=g, device=cuda_device)
    d = div.clone().requires_grad_(True)
    (pressure.solve_pressure_cg(d, coeffs, 1e-6, 500) * w).sum().backward()
    assert_close(d.grad, kcg.cg_pressure_plain(w, coeffs, 1e-6, 500)[0], RTOL)

    with pytest.raises(TypeError, match="float32"):
        kcg.cg_pressure(div.double(), coeffs)
    with pytest.raises(ValueError, match="coefficients on cpu"):
        kcg.cg_pressure(div, smoke_env.smoke_domain_128().laplacian_coeffs("cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8, 20])
@pytest.mark.parametrize("size", [63, 127])
def test_port_cg_cluster_kernel_batches_and_domains(cuda_device, batch, size):
    """K4's cluster launch at batch 1, 8 and 20 (20 clusters: more than one
    wave where the card holds fewer) on the 64 and 128 smoke domains, with
    one element that starts converged; two calls bit-equal."""
    from diffphycon_tpu_torch.kernels import cg_pressure as kcg
    from diffphycon_tpu_torch.physics.fluids import smoke_env

    domain = smoke_env.smoke_domain_128() if size == 127 else smoke_env.smoke_domain_64()
    coeffs = domain.laplacian_coeffs(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(size + batch)
    div = torch.randn(batch, size, size, generator=g, device=cuda_device)
    div[batch // 2] = 0.0
    p, iters = kcg.cg_pressure(div, coeffs, 1e-6, 500)
    p_plain, iters_plain = kcg.cg_pressure_plain(div, coeffs, 1e-6, 500)
    assert_close(p, p_plain, RTOL)
    assert ((iters - iters_plain).abs() <= (0.02 * iters_plain).ceil()).all(), (iters, iters_plain)
    assert iters[batch // 2] == 0 and torch.equal(p[batch // 2], torch.zeros_like(p[0]))
    p2, iters2 = kcg.cg_pressure(div, coeffs, 1e-6, 500)
    assert torch.equal(p, p2) and torch.equal(iters, iters2)
    assert kcg._plan(batch, size, size).cluster in kcg.CG_CLUSTERS


def _attn_params(c, g, device, linear):
    def r(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=device) * scale

    p = {"norm_g": 1 + r(c, scale=0.1), "wqkv": r(c, 384, scale=c ** -0.5),
         "wo": r(128, c, scale=128 ** -0.5), "bo": r(c, scale=0.1)}
    if linear:
        p["out_g"] = 1 + r(c, scale=0.1)
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 16, 128, 64), (2, 2, 16, 512)])
def test_port_linear_attention_kernel_matches_plain_on_gpu(cuda_device, shape):
    """K5 at the first and the last level of the Burgers net (2048 and 32
    tokens), and the plain VJP of its autograd Function."""
    from diffphycon_tpu_torch.kernels import attention as ka

    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(*shape, generator=g, device=cuda_device)
    p = _attn_params(shape[-1], g, cuda_device, linear=True)
    assert_close(ka.linear_attention_block(x, p), ka.linear_attention_block_plain(x, p), RTOL)

    xg = x.clone().requires_grad_(True)
    wg = p["wqkv"].clone().requires_grad_(True)
    w = torch.randn(shape, generator=g, device=cuda_device)
    (ka.linear_attention_block(xg, {**p, "wqkv": wg}) * w).sum().backward()
    xr = x.clone().requires_grad_(True)
    wr = p["wqkv"].clone().requires_grad_(True)
    (ka.linear_attention_block_plain(xr, {**p, "wqkv": wr}) * w).sum().backward()
    assert_close(xg.grad, xr.grad, RTOL)
    assert_close(wg.grad, wr.grad, RTOL)

    with pytest.raises(TypeError, match="float32"):
        ka.linear_attention_block(x.double(), {k: v.double() for k, v in p.items()})
    wide = torch.randn(1, 2, 2, 520, device=cuda_device)
    with pytest.raises(ValueError, match="channels"):
        ka.linear_attention_block(wide, _attn_params(520, g, cuda_device, linear=True))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(50, 2, 16, 512), (3, 4, 7, 64), (4, 4, 32, 256),
                                   (2, 16, 128, 64)])
def test_port_attention_kernel_matches_plain_on_gpu(cuda_device, shape):
    """K6 at the Burgers bottleneck (32 tokens, 512 channels), a ragged
    28-token tile, the 3-level net's 128-token bottleneck and a 2048-token
    level; two calls bit-equal; gradients through the plain VJP; and 64
    tokens, more than a one-block-per-sample kernel holds."""
    from diffphycon_tpu_torch.kernels import attention as ka

    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(*shape, generator=g, device=cuda_device)
    p = _attn_params(shape[-1], g, cuda_device, linear=False)
    out = ka.attention_block(x, p)
    assert_close(out, ka.attention_block_plain(x, p), RTOL)
    assert torch.equal(out, ka.attention_block(x, p))
    x64 = torch.randn(1, 4, 16, shape[-1], generator=g, device=cuda_device)
    assert_close(ka.attention_block(x64, p), ka.attention_block_plain(x64, p), RTOL)

    xg = x.clone().requires_grad_(True)
    wg = p["wo"].clone().requires_grad_(True)
    w = torch.randn(shape, generator=g, device=cuda_device)
    (ka.attention_block(xg, {**p, "wo": wg}) * w).sum().backward()
    xr = x.clone().requires_grad_(True)
    wr = p["wo"].clone().requires_grad_(True)
    (ka.attention_block_plain(xr, {**p, "wo": wr}) * w).sum().backward()
    assert_close(xg.grad, xr.grad, RTOL)
    assert_close(wg.grad, wr.grad, RTOL)

    with pytest.raises(TypeError, match="float32"):
        ka.attention_block(x.double(), {k: v.double() for k, v in p.items()})
    with pytest.raises(ValueError, match="channels"):
        ka.attention_block(torch.randn(1, 2, 2, 1024, device=cuda_device),
                           _attn_params(1024, g, cuda_device, linear=False))


@pytest.mark.cuda
def test_port_unet2d_kernel_gradients_match_plain_on_gpu(cuda_device):
    """Every parameter gradient of a loss through the kernel-backed forward
    (K1-K3, K5, K6 with plain VJPs) against the plain forward; relative
    per-tensor error 1e-4 (the forwards differ by summation order only)."""
    from diffphycon_tpu_torch.nets.init import seeded_init_
    from diffphycon_tpu_torch.nets.unet2d import UNet2D

    net = seeded_init_(UNet2D(dim=8, dim_mults=(1, 2, 4, 8)),
                       torch.Generator().manual_seed(0)).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(2, 16, 128, 2, generator=g, device=cuda_device)
    t = torch.tensor([3.0, 600.0], device=cuda_device)
    grads, launches = [], []
    for fwd in (net.forward, net.forward_plain):
        net.zero_grad()
        kb.reset_launch_counts()
        fwd(x, t).square().mean().backward()
        grads.append({n: q.grad.clone() for n, q in net.named_parameters()})
        launches.append(kb.launch_counts())
    assert launches[0]["linear_attention_block"] == 8 and launches[0]["attention_block"] == 1
    assert all(v == 0 for v in launches[1].values())
    for name, gk in grads[0].items():
        gp = grads[1][name]
        assert gp.abs().max() > 0, name
        assert (gk - gp).norm() <= 1e-4 * gp.norm(), name


def _res_pack(c, g, device):
    def r(*s, scale=1.0, shift=0.0):
        return torch.randn(*s, generator=g, device=device) * scale + shift

    return {"w1": r(9 * c, c, scale=(9 * c) ** -0.5), "b1": r(c, scale=0.1),
            "gs1": r(c, scale=0.1, shift=1.0), "gb1": r(c, scale=0.1),
            "w2": r(9 * c, c, scale=(9 * c) ** -0.5), "b2": r(c, scale=0.1),
            "gs2": r(c, scale=0.1, shift=1.0), "gb2": r(c, scale=0.1)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [((3, 16, 128, 64), 1), ((2, 4, 32, 256), 2)])
def test_port_resblock_pair_kernel_matches_plain_on_gpu(cuda_device, shape, groups):
    """K7 (one launch of the persistent kernel) against two plain ResBlocks,
    with the second FiLM a strided column slice of a wider tensor."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    b, c = shape[0], shape[-1]
    x = torch.randn(*shape, generator=g, device=cuda_device)
    ss_a = 0.5 * torch.randn(b, 2 * c, generator=g, device=cuda_device)
    ss_b = (0.5 * torch.randn(b, 4 * c, generator=g, device=cuda_device))[:, c:3 * c]
    p_a, p_b = _res_pack(c, g, cuda_device), _res_pack(c, g, cuda_device)
    kb.reset_launch_counts()
    out = kb.resblock_pair(x, ss_a, ss_b, p_a, p_b, groups=groups)
    counts = kb.launch_counts()
    assert counts["resblock_pair"] == 1 and sum(counts.values()) == 1, counts
    assert_close(out, kb.resblock_pair_plain(x, ss_a, ss_b, p_a, p_b, groups), RTOL)
    assert torch.equal(out, kb.resblock_pair(x, ss_a, ss_b, p_a, p_b, groups=groups))
    with pytest.raises(TypeError, match="float32"):
        kb.resblock_pair(x.double(), ss_a, ss_b, p_a, p_b)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,mults,shape,groups", [(8, (1, 2, 4, 8), (3, 16, 128, 2), 1),
                                                    (16, (1, 2, 4), (2, 16, 128, 2), 2),
                                                    (16, (1, 2), (2, 16, 128, 2), 1),
                                                    (8, (4,), (3, 8, 24, 2), 1)])
def test_port_unet2d_mega_kernel_matches_plain_on_gpu(cuda_device, dim, mults, shape, groups):
    """K8: one launch per forward_mega, against forward_plain, bit-equal
    from run to run; forward-only. Bottlenecks of 32, 128, 512 (the 2-level
    net: K8 refused more than 128 tokens before its attention stages became
    K6's) and 192 tokens (a one-level net, a ragged last 64-query tile)."""
    from diffphycon_tpu_torch.nets.init import seeded_init_
    from diffphycon_tpu_torch.nets.unet2d import UNet2D

    net = seeded_init_(UNet2D(dim=dim, dim_mults=mults, resnet_block_groups=groups),
                       torch.Generator().manual_seed(0)).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.randn(*shape, generator=g, device=cuda_device)
    t = torch.linspace(0, 999, shape[0], device=cuda_device)
    with torch.no_grad():
        kb.reset_launch_counts()
        out = net.forward_mega(x, t)
        counts = kb.launch_counts()
        assert counts["unet2d_mega"] == 1 and sum(counts.values()) == 1, counts
        assert_close(out, net.forward_plain(x, t), RTOL)
        assert torch.equal(out, net.forward_mega(x, t))
    with pytest.raises(RuntimeError, match="forward-only"):
        net.forward_mega(x, t)


@pytest.mark.cuda
def test_port_unet2d_mega_grid_and_split_plans_on_gpu(cuda_device):
    """One CTA per SM; a plan made for the card's grid, with split-K convs,
    gives the same output as forward_plain, and bit-equal repeats: the last
    split to arrive adds the partials in split order whichever CTA it is."""
    from diffphycon_tpu_torch.kernels import unet2d_mega as km
    from diffphycon_tpu_torch.nets.init import seeded_init_
    from diffphycon_tpu_torch.nets.unet2d import UNet2D, _conv_nchw

    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert km.grid_blocks(cuda_device) == sms
    net = seeded_init_(UNet2D(dim=32, dim_mults=(1, 2, 4)),
                       torch.Generator().manual_seed(1)).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn(4, 16, 128, 2, generator=g, device=cuda_device)
    t = torch.linspace(0, 999, 4, device=cuda_device)
    with torch.no_grad():
        packs = net._kernel_pack()
        film = net._film(t, packs)
        x0 = _conv_nchw(x, net.init_conv)
        plan = km.mega_plan(packs, x0.shape, net.groups, 4, 32, x0.device)
        assert plan.grid == sms and plan.n_counters > 0
        assert any(st.ints.get("splits", 1) > 1 for st in plan.stages)
        ref = km.unet2d_mega_plain(x0, film, packs, plan)
        out = km.unet2d_mega(x0, film, packs, plan)
        assert km.unet2d_mega.grid == sms
        assert_close(out, ref, RTOL)
        for _ in range(3):
            assert torch.equal(out, km.unet2d_mega(x0, film, packs, plan))
        # a plan for another grid is refused, not run
        other = km.mega_plan(packs, x0.shape, net.groups, 4, 32, x0.device, grid=sms // 2)
        with pytest.raises(RuntimeError, match="the plan was made for"):
            km.unet2d_mega(x0, film, packs, other)


def _main_path_sites(kind, batch=50):
    return sorted({a for k, a, _ in chip_smoke.main_path_calls(64, (1, 2, 4, 8), batch)
                   if k == kind})


@pytest.mark.cuda
def test_port_linear_attention_tc_at_main_path_sites(cuda_device):
    """K5 (3xTF32 projections, chunked context) at the seven shapes of its 8
    sites in the Burgers UNet2D at batch 50, each against the plain version,
    and two calls bit-equal (no atomics; the partials merge in chunk
    order)."""
    from diffphycon_tpu_torch.kernels import attention as ka

    g = torch.Generator(device=cuda_device).manual_seed(12)
    sites = _main_path_sites("linear_attention_block")
    assert len(sites) == 7
    for b, h, w, c in sites:
        x = 2 * torch.randn(b, h, w, c, generator=g, device=cuda_device) + 0.3
        p = _attn_params(c, g, cuda_device, linear=True)
        out = ka.linear_attention_block(x, p)
        assert_close(out, ka.linear_attention_block_plain(x, p), RTOL)
        assert torch.equal(out, ka.linear_attention_block(x, p))
        torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 5, 27, 64), (2, 9, 40, 96), (5, 4, 8, 8), (1, 16, 128, 16),
                                   (2, 1, 3, 512)])
def test_port_linear_attention_tc_ragged_shapes(cuda_device, shape):
    """Token counts that no tile or chunk divides (135, 360, 32, 2048, 3),
    channels below one 32-deep slice (8, 16) or off a multiple of 32 (96),
    and the stages launched apart (K5a, then K5b on its partials) equal to
    the whole call."""
    from diffphycon_tpu_torch.kernels import attention as ka

    g = torch.Generator(device=cuda_device).manual_seed(13)
    x = 2 * torch.randn(*shape, generator=g, device=cuda_device) + 0.3
    p = _attn_params(shape[-1], g, cuda_device, linear=True)
    out = ka.linear_attention_block(x, p)
    assert_close(out, ka.linear_attention_block_plain(x, p), RTOL)
    stage_a, stage_b = ka.linear_attention_stages(x, p)
    stage_a()
    assert torch.equal(stage_b(), out)
    with pytest.raises(ValueError, match="multiple of 4"):
        ka.linear_attention_block(torch.randn(1, 2, 2, 6, device=cuda_device),
                                  _attn_params(6, g, cuda_device, linear=True))


def _gn_case(g, device, shape, film, groups=1):
    def r(*s, scale=1.0, shift=0.0):
        return torch.randn(*s, generator=g, device=device) * scale + shift

    b, c = shape[0], shape[-1]
    x = r(*shape, scale=2.0, shift=0.5)
    gamma, beta = r(c, scale=0.5, shift=1.0), r(c, scale=0.1)
    # the FiLM as a strided column slice of a wider projection, as UNet2D passes it
    ss = r(b, 4 * c, scale=0.5)[:, c:3 * c] if film else None
    res = None if film else r(*shape)
    return x, gamma, beta, groups, ss, res


@pytest.mark.cuda
def test_port_group_norm_cluster_at_main_path_signatures(cuda_device):
    """K3 (one cluster launch per call) at every signature of the Burgers
    UNet2D forward at batch 50 and 16, against the plain version, and two
    calls bit-equal (the cluster merges its partials in rank order)."""
    g = torch.Generator(device=cuda_device).manual_seed(14)
    seen = 0
    for batch in (50, 16):
        for b, h, w, c, film in _main_path_sites("group_norm_act", batch):
            x, gamma, beta, groups, ss, res = _gn_case(g, cuda_device, (b, h, w, c), film)
            kb.reset_launch_counts()
            out = kb.group_norm_act(x, gamma, beta, groups, ss=ss, res=res)
            assert kb.launch_counts()["group_norm_act"] == 1
            assert_close(out, kb.group_norm_act_plain(x, gamma, beta, groups, ss=ss, res=res), RTOL)
            assert torch.equal(out, kb.group_norm_act(x, gamma, beta, groups, ss=ss, res=res))
            seen += 1
    assert seen == 28  # 14 signatures at each batch


@pytest.mark.cuda
@pytest.mark.parametrize("args,bn", [((2, 16, 128, 64, 0, 64), 64), ((7, 16, 128, 64, 0, 64), 64),
                                     ((2, 8, 64, 64, 0, 64), 64), ((2, 8, 64, 128, 0, 128), 128),
                                     ((3, 8, 64, 64, 64, 128), 128),
                                     ((40, 8, 64, 128, 0, 128), 128),
                                     ((1, 16, 256, 64, 0, 64), 64)])
def test_port_bf16act_halo_views_equal_per_tap_boxes(cuda_device, monkeypatch, args, bn):
    """The persistent tile's halo A tiles (one (bh + 2) x (bw + 2) box a
    64-channel block, the nine taps descriptor views into it at any pixel
    with the base-offset field 0) give outputs bit-equal to per-tap TMA
    boxes (``unet2d_blocks.BF16ACT_HALO`` off) under the same plan, at the 16
    x 128 and 8 x 64 levels' shapes, with held weights (one tile a CTA and
    several, the warpgroups in turns) and streamed ones (one tile a CTA, and
    two in turns at batch 40), with one and two sources, and at a grid twice
    as wide (two tiles a row)."""
    b_, h, w, ca, cb, co = args
    monkeypatch.setattr(kb, "tile_plan", _forced_plan(128, bn, 1))
    g = torch.Generator(device=cuda_device).manual_seed(23)
    xa, xb, wt, bias = _conv_case(g, cuda_device, b_, h, w, ca, cb, co, 3)
    bf = torch.bfloat16
    xa, wt = xa.to(bf), wt.to(bf)
    xb = None if xb is None else xb.to(bf)
    plan = kb.tile_plan(b_ * h * w, co, 9 * (ca + cb), True, True)
    assert kb.bf16act_layout("conv2d_nhwc", (b_, h, w, ca, cb, co, 3, False),
                             plan)["mode"] == "halo"
    with torch.no_grad():
        halo = kb.conv2d_nhwc(xa, wt, bias, x_b=xb, k=3)
        monkeypatch.setattr(kb, "BF16ACT_HALO", False)
        boxes = kb.conv2d_nhwc(xa, wt, bias, x_b=xb, k=3)
    assert torch.equal(halo, boxes)
    _bf16act_check(lambda: halo, lambda: kb.conv2d_nhwc_plain(xa, wt, bias, x_b=xb, k=3))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups,film", [((3, 5, 7, 32), 2, True), ((2, 4, 8, 64), 4, False),
                                               ((1, 3, 3, 8), 2, True), ((2, 64, 256, 64), 1, True),
                                               ((2, 40, 256, 64), 2, False)])
def test_port_group_norm_cluster_ragged_and_groups(cuda_device, shape, groups, film):
    """Groups 2 and 4 (strided rows), rows no cluster divides evenly (9
    vectors over 8 CTAs), and rows of 1M and 320k floats (each CTA holds 52
    KB of its slice and reads the rest from device memory); then the
    gradients through the plain VJP against the plain version's."""
    g = torch.Generator(device=cuda_device).manual_seed(15)
    x, gamma, beta, groups, ss, res = _gn_case(g, cuda_device, shape, film, groups)
    out = kb.group_norm_act(x, gamma, beta, groups, ss=ss, res=res)
    assert_close(out, kb.group_norm_act_plain(x, gamma, beta, groups, ss=ss, res=res), RTOL)
    assert torch.equal(out, kb.group_norm_act(x, gamma, beta, groups, ss=ss, res=res))
    ins = [t.detach().clone().requires_grad_(True) for t in (x, gamma, beta)]
    seed = torch.randn(shape, generator=g, device=cuda_device)
    grads = []
    for fn in (kb.group_norm_act, kb.group_norm_act_plain):
        grads.append(torch.autograd.grad((fn(*ins, groups, ss=ss, res=res) * seed).sum(), ins))
    for gk, gp in zip(*grads):
        assert_close(gk, gp, RTOL)
    with pytest.raises(ValueError, match="multiple of 4 channels"):
        kb.group_norm_act(torch.randn(1, 2, 2, 12, device=cuda_device), gamma[:12], beta[:12], 2)


# the bf16 variants against their bf16 plain versions: both round the same
# operands to bf16 and sum exact products in fp32 (summation order, and for
# K5 and K6 a ChanLN output that rounds to the neighbouring bf16 value);
# the per-block bound of tests/test_torch_port_bf16.py
BF16_RTOL = 2e-3


def _bf16_attn(c, g, device, linear):
    p = _attn_params(c, g, device, linear)
    return {**p, "wqkv": p["wqkv"].to(torch.bfloat16), "wo": p["wo"].to(torch.bfloat16)}


@pytest.mark.cuda
def test_port_bf16_convs_match_plain_at_main_path_signatures(cuda_device):
    """K1's and K2's bf16 variants (bf16 wgmma, the activation rounded at
    the product) at every signature of the Burgers UNet2D forward at batch
    50, each through its own tile plan, two calls bit-equal; every launch a
    bf16 one."""
    g = torch.Generator(device=cuda_device).manual_seed(17)
    seen = set()
    kb.reset_launch_counts()
    for name, args, _ in chip_smoke.main_path_calls(64, (1, 2, 4, 8), 50):
        if name not in ("conv2d_nhwc", "downsample_nhwc") or (name, args) in seen:
            continue
        seen.add((name, args))
        if name == "conv2d_nhwc":
            b, h, w, ca, cb, co, k, up = args
            xa, xb, wt, bias = _conv_case(g, cuda_device, b, h, w, ca, cb, co, k)
            wt = wt.to(torch.bfloat16)
            out = kb.conv2d_nhwc(xa, wt, bias, x_b=xb, k=k, upsample=up)
            assert_close(out, kb.conv2d_nhwc_plain(xa, wt, bias, x_b=xb, k=k, upsample=up),
                         BF16_RTOL)
            assert torch.equal(out, kb.conv2d_nhwc(xa, wt, bias, x_b=xb, k=k, upsample=up))
        else:
            b, h, w, c, co = args
            x, _, wt, bias = _conv_case(g, cuda_device, b, h, w, c, 0, co, 2)
            wt = wt.to(torch.bfloat16)
            assert_close(kb.downsample_nhwc(x, wt, bias), kb.downsample_nhwc_plain(x, wt, bias),
                         BF16_RTOL)
        torch.cuda.synchronize()
    counts = kb.launch_counts()
    assert len(seen) == 22
    assert counts["conv2d_nhwc.bf16"] == counts["conv2d_nhwc"] > 0
    assert counts["downsample_nhwc.bf16"] == counts["downsample_nhwc"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("bm,bn", kb.TC_TILES_BF16)
@pytest.mark.parametrize("splits", [1, 3])
def test_port_bf16_convs_ragged_shapes_every_tile(cuda_device, monkeypatch, bm, bn, splits):
    """The bf16 core (csrc/igemm_bf16.cuh) under every tile shape of its
    plan, with and without split-K. Through the gather: M off every tile, K
    off the 64-deep stage (Ca = 4 with Cb = 8: K = 108; Ca = 36 with Cb = 4:
    K = 360 over 6 stages), k = 1, an odd upsampled source, Co = 136 over
    two N tiles. Through TMA boxes (64-channel blocks): tiles of whole
    images past the batch, with two sources, upsampled (4 parity classes)
    and not, and K2 at stride 2. And Co = 12 (not a multiple of 8) raises,
    and so does a bfloat16 activation with a float32 weight."""
    monkeypatch.setattr(kb, "tile_plan", _forced_plan(bm, bn, splits))
    g = torch.Generator(device=cuda_device).manual_seed(18)
    for args in [(3, 5, 7, 4, 8, 8, 3), (3, 5, 7, 4, 8, 16, 1), (2, 9, 15, 36, 0, 136, 3),
                 (1, 3, 5, 8, 0, 24, 3, True), (2, 4, 4, 64, 32, 64, 1),
                 (2, 5, 7, 36, 4, 24, 3), (3, 2, 8, 64, 64, 136, 3),
                 (3, 2, 4, 64, 64, 24, 3, True), (3, 4, 8, 128, 0, 64, 1, True)]:
        k, up = args[6], bool(args[7:] and args[7])
        xa, xb, wt, bias = _conv_case(g, cuda_device, *args[:7])
        wt = wt.to(torch.bfloat16)
        assert_close(kb.conv2d_nhwc(xa, wt, bias, x_b=xb, k=k, upsample=up),
                     kb.conv2d_nhwc_plain(xa, wt, bias, x_b=xb, k=k, upsample=up), BF16_RTOL)
    for b, h, w, c, co in [(3, 6, 10, 4, 8), (2, 10, 18, 20, 72), (3, 4, 8, 64, 72)]:
        x, _, wt, bias = _conv_case(g, cuda_device, b, h, w, c, 0, co, 2)
        wt = wt.to(torch.bfloat16)
        assert_close(kb.downsample_nhwc(x, wt, bias), kb.downsample_nhwc_plain(x, wt, bias),
                     BF16_RTOL)
    xa, _, wt, bias = _conv_case(g, cuda_device, 1, 4, 4, 8, 0, 12, 3)
    with pytest.raises(ValueError, match="multiple of 8"):
        kb.conv2d_nhwc(xa, wt.to(torch.bfloat16), bias)
    with pytest.raises(TypeError, match="bfloat16 activations take bfloat16 weights"):
        kb.conv2d_nhwc(xa.to(torch.bfloat16), wt, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [None, (128, 128, 1)])
def test_port_bf16_conv_chain_error_at_the_deepest_k(cuda_device, monkeypatch, forced):
    """At K = 6912 (the skip-concat conv of the 2 x 16 level, batch 8) the
    bf16 core's one chain of products per split stays within 1e-5 relative
    of a float64 conv of the same bf16-rounded operands, under the module's
    plan and as one chain of all 108 stages (one 128 x 128 tile per output
    tile, no split)."""
    if forced is not None:
        monkeypatch.setattr(kb, "tile_plan", _forced_plan(*forced))
    g = torch.Generator(device=cuda_device).manual_seed(20)
    xa, xb, w, b = _conv_case(g, cuda_device, 8, 2, 16, 512, 256, 512, 3)
    w = w.to(torch.bfloat16)
    ref = kb.conv2d_nhwc_plain(xa.to(torch.bfloat16).double(), w.double(), b.double(),
                               x_b=xb.to(torch.bfloat16).double())
    scale = max(1.0, ref.abs().max().item())
    assert (kb.conv2d_nhwc(xa, w, b, x_b=xb).double() - ref).abs().max().item() <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("bm,bn", kb.TC_TILES_BF16)
def test_port_bf16_core_one_tile_reads_the_weight_mn_major(cuda_device, monkeypatch, bm, bn):
    """One output tile of the bf16 core over one 64-deep stage (a 1x1 conv:
    M = BM, K = 64, Co = BN): wgmma reads the weight slice as stored,
    MN-major (imm-trans-b = 1), through desc_mn's leading byte offset (64-
    column atoms) and stride byte offset (8-row k groups); a wrong offset
    reads other rows or columns. Against the plain bf16 product to fp32
    summation order (64 exact products each: 1e-5), and bit-equal with the
    weight a view 16 bytes into a larger tensor."""
    monkeypatch.setattr(kb, "tile_plan", _forced_plan(bm, bn, 1))
    g = torch.Generator(device=cuda_device).manual_seed(19)
    xa, _, wt, bias = _conv_case(g, cuda_device, 1, bm // 16, 16, 64, 0, bn, 1)
    wt = wt.to(torch.bfloat16)
    out = kb.conv2d_nhwc(xa, wt, bias, k=1)
    assert_close(out, kb.conv2d_nhwc_plain(xa, wt, bias, k=1), 1e-5)
    store = torch.zeros(wt.numel() + 8, dtype=torch.bfloat16, device=cuda_device)
    view = store[8:].view(wt.shape)
    view.copy_(wt)
    assert view.storage_offset() == 8 and view.data_ptr() % 16 == 0
    assert torch.equal(kb.conv2d_nhwc(xa, view, bias, k=1), out)


@pytest.mark.cuda
@pytest.mark.parametrize("linear", [True, False])
def test_port_bf16_attention_kernels_match_plain(cuda_device, linear):
    """K5's and K6's bf16 variants (bf16 wgmma projections, 3xTF32 context
    and core) at every main-path site at batch 50 and on ragged shapes, two
    calls bit-equal; the plain VJP reaches the fp32 weight through
    .to(bfloat16). The 64-token tiles of K5b, K6a and K6c run over the
    flattened tokens: 32-token samples two to a tile (3 x 2 x 16 at 512
    channels), 24 and 21 tokens whose tiles start inside a sample and hold
    up to four (the third and fourth contexts read from L2), and C = 8 (one
    16-deep product of a 64-deep block of zeros past C)."""
    from diffphycon_tpu_torch.kernels import attention as ka

    g = torch.Generator(device=cuda_device).manual_seed(19)
    kern = ka.linear_attention_block if linear else ka.attention_block
    plain = ka.linear_attention_block_plain if linear else ka.attention_block_plain
    sites = _main_path_sites("linear_attention_block" if linear else "attention_block")
    kb.reset_launch_counts()
    for b, h, w, c in sites + [(3, 5, 27, 64), (2, 9, 40, 96), (2, 1, 3, 512), (3, 2, 16, 512),
                               (5, 1, 24, 256), (2, 3, 7, 96), (3, 4, 7, 8), (4, 2, 16, 8)]:
        x = 2 * torch.randn(b, h, w, c, generator=g, device=cuda_device) + 0.3
        p = _bf16_attn(c, g, cuda_device, linear)
        out = kern(x, p)
        assert_close(out, plain(x, p), BF16_RTOL)
        assert torch.equal(out, kern(x, p))
        torch.cuda.synchronize()
    name = "linear_attention_block" if linear else "attention_block"
    counts = kb.launch_counts()
    assert counts[f"{name}.bf16"] == counts[name] > 0

    x = torch.randn(2, 4, 8, 64, generator=g, device=cuda_device)
    p32 = _attn_params(64, g, cuda_device, linear)
    wg = p32["wqkv"].clone().requires_grad_(True)
    wr = p32["wqkv"].clone().requires_grad_(True)
    w = torch.randn(x.shape, generator=g, device=cuda_device)
    p16 = {**p32, "wo": p32["wo"].to(torch.bfloat16)}
    (kern(x, {**p16, "wqkv": wg.to(torch.bfloat16)}) * w).sum().backward()
    (plain(x, {**p16, "wqkv": wr.to(torch.bfloat16)}) * w).sum().backward()
    assert wg.grad.dtype == torch.float32
    assert_close(wg.grad, wr.grad, BF16_RTOL)


@pytest.mark.cuda
def test_port_unet2d_bf16_forward_on_gpu(cuda_device):
    """A dim-16 bf16 UNet2D: the kernel forward against the plain forward
    (1e-2, the CPU tests' whole-net bound: rounding flips cascade), every
    K1, K2, K5 and K6 launch a bf16 one, K3 unchanged; forward_mega (K8)
    and K7 run their bf16 instantiation on the bf16 packs."""
    from diffphycon_tpu_torch.nets.init import seeded_init_
    from diffphycon_tpu_torch.nets.unet2d import UNet2D

    net = seeded_init_(UNet2D(dim=16, dim_mults=(1, 2, 4, 8), weight_dtype=torch.bfloat16),
                       torch.Generator().manual_seed(0)).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(20)
    x = torch.randn(4, 16, 128, 2, generator=g, device=cuda_device)
    t = torch.tensor([3.0, 300.0, 700.0, 999.0], device=cuda_device)
    with torch.no_grad():
        kb.reset_launch_counts()
        out = net(x, t)
        counts = kb.launch_counts()
        plain = net.forward_plain(x, t)
        assert_close(out, plain, 1e-2)
        kb.reset_launch_counts()
        assert_close(net.forward_mega(x, t), plain, 1e-2)
        mega_counts = kb.launch_counts()
        p = net.pack()["res"][0]  # a bf16 ResBlock of 16 channels
        h, ss = torch.randn(4, 16, 128, 16, generator=g, device=cuda_device), x.new_zeros(4, 32)
        assert_close(kb.resblock_pair(h, ss, ss, p, p), kb.resblock_pair_plain(h, ss, ss, p, p),
                     1e-2)
    assert counts["conv2d_nhwc"] == counts["conv2d_nhwc.bf16"] == 52
    assert counts["downsample_nhwc"] == counts["downsample_nhwc.bf16"] == 3
    assert counts["linear_attention_block"] == counts["linear_attention_block.bf16"] == 8
    assert counts["attention_block"] == counts["attention_block.bf16"] == 1
    assert counts["group_norm_act"] == 38
    assert mega_counts["unet2d_mega"] == mega_counts["unet2d_mega.bf16"] == 1
    assert sum(mega_counts.values()) == 2, mega_counts


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups", [((3, 16, 128, 64), 1), ((2, 4, 32, 256), 2)]
                         + [((chip_smoke.B, h, w, c), 1) for h, w, c in chip_smoke.PAIR_SHAPES])
def test_port_resblock_pair_bf16_kernel_matches_plain_on_gpu(cuda_device, shape, groups):
    """K7's bf16 instantiation (bf16 conv weights) against the bf16 plain
    pair (1e-2: a rounding flip of one activation moves a term by 2^-8, and
    GroupNorm carries it on), bit-equal repeats, counted as a bf16 launch;
    a pair of mixed weight dtypes raises. Also at phase 9's five pair shapes
    (batch 50), whose convs take the A tile by TMA boxes, split-K among
    them."""
    g = torch.Generator(device=cuda_device).manual_seed(21)
    b, c = shape[0], shape[-1]
    x = torch.randn(*shape, generator=g, device=cuda_device)
    ss_a = 0.5 * torch.randn(b, 2 * c, generator=g, device=cuda_device)
    ss_b = 0.5 * torch.randn(b, 2 * c, generator=g, device=cuda_device)
    p_a, p_b = (_res_pack(c, g, cuda_device) for _ in range(2))
    for p in (p_a, p_b):
        p["w1"], p["w2"] = p["w1"].to(torch.bfloat16), p["w2"].to(torch.bfloat16)
    with torch.no_grad():
        kb.reset_launch_counts()
        out = kb.resblock_pair(x, ss_a, ss_b, p_a, p_b, groups=groups)
        counts = kb.launch_counts()
        assert counts["resblock_pair"] == counts["resblock_pair.bf16"] == 1, counts
        assert_close(out, kb.resblock_pair_plain(x, ss_a, ss_b, p_a, p_b, groups), 1e-2)
        assert torch.equal(out, kb.resblock_pair(x, ss_a, ss_b, p_a, p_b, groups=groups))
        with pytest.raises(TypeError, match="mixed"):
            kb.resblock_pair(x, ss_a, ss_b, p_a, {**p_b, "w2": p_b["w2"].float()}, groups=groups)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,mults,shape", [(8, (1, 2, 4, 8), (3, 16, 128, 2)),
                                             (16, (1, 2), (2, 16, 128, 2)),
                                             (16, (1, 2, 4), (2, 16, 128, 2)),
                                             (64, (1, 2), (8, 16, 128, 2))])
def test_port_unet2d_mega_bf16_kernel_matches_plain_on_gpu(cuda_device, dim, mults, shape):
    """K8's bf16 instantiation: the kernel against its plain version (the
    bf16 plain replay) on the inputs forward_mega gives it (1e-2), one
    launch counted as bf16, and 20 launches back to back all bit-equal (a
    missing proxy fence between a stage's stores and the next stage's TMA
    reads shows as a rare wrong tile), and a CUDA graph of one launch
    replayed to the same bits, also the second of two graphs captured on
    one pool, replayed alone; the 32- and 512-token bottlenecks.
    The conv stages gather their A tiles where a source has channels off
    64 (every stage of the 2-level dim-16 net, most of the dim-8 and the
    3-level dim-16 nets) and take TMA boxes elsewhere (their 64-channel
    levels, through the upsample too, and every stage of the dim-64 net);
    at batch 8 the dim-64 net's K5b work items take several tiles each."""
    from diffphycon_tpu_torch.kernels import unet2d_mega as km
    from diffphycon_tpu_torch.nets.init import seeded_init_
    from diffphycon_tpu_torch.nets.unet2d import UNet2D, _conv_nchw

    net = seeded_init_(UNet2D(dim=dim, dim_mults=mults, weight_dtype=torch.bfloat16),
                       torch.Generator().manual_seed(0)).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(22)
    x = torch.randn(*shape, generator=g, device=cuda_device)
    t = torch.linspace(0, 999, shape[0], device=cuda_device)
    with torch.no_grad():
        packs = net._kernel_pack()
        film = net._film(t, packs)
        x0 = _conv_nchw(x, net.init_conv, torch.bfloat16)
        plan = km.mega_plan(packs, x0.shape, net.groups, 4, 32, x0.device)
        assert plan.weight_dtype == torch.bfloat16
        boxes = [row[km.EXT] for st, row in zip(plan.stages, plan.table)
                 if st.op in (km.CONV, km.DOWN)]
        want = "all" if dim == 64 else "none" if mults == (1, 2) else "some"
        assert {"none": sum(boxes) == 0, "all": all(boxes),
                "some": 0 < sum(boxes) < len(boxes)}[want], boxes
        kb.reset_launch_counts()
        out = km.unet2d_mega(x0, film, packs, plan)
        counts = kb.launch_counts()
        assert counts["unet2d_mega"] == counts["unet2d_mega.bf16"] == 1, counts
        assert_close(out, km.unet2d_mega_plain(x0, film, packs, plan), 1e-2)
        repeats = [km.unet2d_mega(x0, film, packs, plan) for _ in range(20)]
        assert all(torch.equal(out, r) for r in repeats)
        # in a CUDA graph: the capture writes the tensor maps for its own
        # workspace on its own stream, and the replay gives the same bits
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = km.unet2d_mega(x0, film, packs, plan)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, captured)
        # two captures sharing one pool (the same stream, and perhaps the
        # same workspace address), only the second replayed: its own
        # captured writes must give its maps
        first, second = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(first):
            km.unet2d_mega(x0, film, packs, plan)
        with torch.cuda.graph(second, pool=first.pool()):
            captured = km.unet2d_mega(x0, film, packs, plan)
        second.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, captured)


BF16ACT_RTOL = chip_smoke.BF16ACT_KERNEL_RTOL


def _bf16act_check(kern, plain):
    out, ref = kern(), plain()
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert_close(out.float(), ref.float(), BF16ACT_RTOL)
    assert torch.equal(out, kern())


@pytest.mark.cuda
def test_port_bf16act_kernels_match_plain_at_main_path_signatures(cuda_device):
    """The bf16-activation variants (flax dtype=bfloat16) of K1, K2, K3, K5
    and K6 at every signature of the Burgers UNet2D forward (batch 4),
    against their plain versions on the same bf16 inputs
    (chip_smoke.BF16ACT_KERNEL_RTOL: two bf16 steps), bfloat16 out, two
    calls bit-equal; every launch a bf16-activation one."""
    import torch.nn.functional as F

    g = torch.Generator(device=cuda_device).manual_seed(21)
    seen = set()
    kb.reset_launch_counts()
    with torch.no_grad():
        for name, args, _ in chip_smoke.main_path_calls(64, (1, 2, 4, 8), 4):
            if (name, args) in seen:
                continue
            seen.add((name, args))
            kern, plain = chip_smoke.kernel_case_bf16act(torch, F, kb, g, name, args)[:2]
            _bf16act_check(kern, plain)
    counts = kb.launch_counts()
    for k in chip_smoke.BF16ACT_KERNELS:
        assert counts[f"{k}.bf16act"] == counts[k] > 0, (k, counts)
    assert not any(counts[f"{k}.bf16"] for k in chip_smoke.BF16_KERNELS)


@pytest.mark.cuda
@pytest.mark.parametrize("bm,bn", kb.TC_TILES_BF16ACT)
@pytest.mark.parametrize("splits", [1, 3])
def test_port_bf16act_convs_ragged_shapes_every_tile(cuda_device, monkeypatch, bm, bn, splits):
    """K1 and K2 on bf16 activations (the persistent tile,
    csrc/igemm_bf16act.cuh) under every tile shape of their plan, with and
    without split-K (the fp32 partials reduced in split order, then
    rounded): through the gather (8-channel chunks: Ca = 8 with Cb = 16, Ca =
    40 with Cb = 8, an odd upsampled source, k = 1, Co = 136), through TMA
    boxes of 64 bf16 channels (whole images past the batch, two sources,
    upsampled and not, K2 at stride 2) and through halo tiles (16 x 128 and
    8 x 64 grids, one and two sources); the persistent walk with fewer row
    tiles than the grid (batch 1), with tiles not a multiple of it (batch 7
    and 16) and with a weight slice too large to hold (K = 4608)."""
    monkeypatch.setattr(kb, "tile_plan", _forced_plan(bm, bn, splits))
    g = torch.Generator(device=cuda_device).manual_seed(22)
    bf = torch.bfloat16
    for args in [(3, 5, 7, 8, 16, 8, 3), (3, 5, 7, 8, 16, 16, 1), (2, 9, 15, 40, 8, 136, 3),
                 (1, 3, 5, 8, 0, 24, 3, True), (2, 4, 4, 64, 64, 64, 1),
                 (3, 2, 8, 64, 64, 136, 3), (3, 2, 4, 64, 64, 24, 3, True),
                 (3, 4, 8, 128, 0, 64, 1, True), (1, 16, 128, 64, 0, 64, 3),
                 (16, 16, 128, 64, 64, 64, 3), (7, 8, 64, 64, 0, 72, 3),
                 (16, 8, 64, 128, 0, 128, 3), (7, 4, 32, 128, 64, 64, 3),
                 (16, 2, 16, 512, 0, 64, 3)]:
        k, up = args[6], bool(args[7:] and args[7])
        xa, xb, wt, bias = _conv_case(g, cuda_device, *args[:7])
        xa, wt = xa.to(bf), wt.to(bf)
        xb = None if xb is None else xb.to(bf)
        _bf16act_check(lambda: kb.conv2d_nhwc(xa, wt, bias, x_b=xb, k=k, upsample=up),
                       lambda: kb.conv2d_nhwc_plain(xa, wt, bias, x_b=xb, k=k, upsample=up))
    for b, h, w, c, co in [(3, 6, 10, 8, 8), (2, 10, 18, 24, 72), (3, 4, 8, 64, 72),
                           (16, 16, 128, 64, 64), (1, 8, 64, 64, 128)]:
        x, _, wt, bias = _conv_case(g, cuda_device, b, h, w, c, 0, co, 2)
        x, wt = x.to(bf), wt.to(bf)
        _bf16act_check(lambda: kb.downsample_nhwc(x, wt, bias),
                       lambda: kb.downsample_nhwc_plain(x, wt, bias))
    xa, _, wt, bias = _conv_case(g, cuda_device, 1, 4, 4, 12, 0, 16, 3)
    with pytest.raises(ValueError, match="multiples of 8"):
        kb.conv2d_nhwc(xa.to(bf), wt.to(bf), bias)


@pytest.mark.cuda
@pytest.mark.parametrize("args,bn", [((2, 16, 128, 64, 0, 64), 64), ((7, 16, 128, 64, 0, 64), 64),
                                     ((2, 8, 64, 64, 0, 64), 64), ((2, 8, 64, 128, 0, 128), 128),
                                     ((3, 8, 64, 64, 64, 128), 128),
                                     ((40, 8, 64, 128, 0, 128), 128),
                                     ((1, 16, 256, 64, 0, 64), 64)])
def test_port_bf16act_halo_views_equal_per_tap_boxes(cuda_device, monkeypatch, args, bn):
    """The persistent tile's halo A tiles (one (bh + 2) x (bw + 2) box a
    64-channel block, the nine taps descriptor views into it at any pixel
    with the base-offset field 0) give outputs bit-equal to per-tap TMA
    boxes (``unet2d_blocks.BF16ACT_HALO`` off) under the same plan, at the 16
    x 128 and 8 x 64 levels' shapes, with held weights (one tile a CTA and
    several, the warpgroups in turns) and streamed ones (one tile a CTA, and
    two in turns at batch 40), with one and two sources, and at a grid twice
    as wide (two tiles a row)."""
    b_, h, w, ca, cb, co = args
    monkeypatch.setattr(kb, "tile_plan", _forced_plan(128, bn, 1))
    g = torch.Generator(device=cuda_device).manual_seed(23)
    xa, xb, wt, bias = _conv_case(g, cuda_device, b_, h, w, ca, cb, co, 3)
    bf = torch.bfloat16
    xa, wt = xa.to(bf), wt.to(bf)
    xb = None if xb is None else xb.to(bf)
    plan = kb.tile_plan(b_ * h * w, co, 9 * (ca + cb), True, True)
    assert kb.bf16act_layout("conv2d_nhwc", (b_, h, w, ca, cb, co, 3, False),
                             plan)["mode"] == "halo"
    with torch.no_grad():
        halo = kb.conv2d_nhwc(xa, wt, bias, x_b=xb, k=3)
        monkeypatch.setattr(kb, "BF16ACT_HALO", False)
        boxes = kb.conv2d_nhwc(xa, wt, bias, x_b=xb, k=3)
    assert torch.equal(halo, boxes)
    _bf16act_check(lambda: halo, lambda: kb.conv2d_nhwc_plain(xa, wt, bias, x_b=xb, k=3))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups,film", [((3, 5, 7, 32), 2, True), ((2, 4, 8, 64), 4, False),
                                               ((2, 16, 128, 64), 1, True),
                                               ((50, 2, 16, 512), 1, False),
                                               ((50, 16, 128, 64), 1, False),
                                               ((50, 8, 64, 128), 1, True),
                                               ((50, 4, 32, 256), 1, False),
                                               ((50, 2, 16, 256), 1, True),
                                               ((50, 2, 16, 512), 1, True),
                                               ((4, 9, 13, 48), 1, False),
                                               ((2, 5, 6, 24), 1, True),
                                               ((1, 64, 128, 64), 1, False),
                                               ((3, 4, 8, 64), 2, "unaligned")])
def test_port_bf16act_group_norm_shapes(cuda_device, shape, groups, film):
    """K3 on bf16 activations: groups, FiLM rows strided (a column slice of
    a wider bf16 projection), the residual, and rows held in shared memory
    or re-read, against the plain version; the five (H, W, C) of the
    Burgers net at batch 50, 6 and 3 vectors of 8 channels a pixel (the
    threads of a CTA then walk several channel vectors: coefficients per
    vector), and a row of 64 vectors a thread, past the residual a thread
    loads before the statistics and past what a CTA holds; and a FiLM row
    that starts off a 16-byte boundary (copied 2 bytes at a time)."""
    g = torch.Generator(device=cuda_device).manual_seed(23)
    b, c = shape[0], shape[-1]
    bf = torch.bfloat16
    x = (2 * torch.randn(*shape, generator=g, device=cuda_device) + 0.5).to(bf)
    gamma = 1 + 0.5 * torch.randn(c, generator=g, device=cuda_device)
    beta = 0.1 * torch.randn(c, generator=g, device=cuda_device)
    ss = (0.5 * torch.randn(b, 4 * c, generator=g, device=cuda_device)).to(bf)[:, c:3 * c]
    if film == "unaligned":
        ss = (0.5 * torch.randn(b, 4 * c + 1, generator=g, device=cuda_device)).to(bf)
        ss = ss[:, c + 1:3 * c + 1]
    res = torch.randn(*shape, generator=g, device=cuda_device).to(bf)
    kw = {"ss": ss} if film else {"res": res}
    _bf16act_check(lambda: kb.group_norm_act(x, gamma, beta, groups, **kw),
                   lambda: kb.group_norm_act_plain(x, gamma, beta, groups, **kw))


def _update_check(lib, y, scale, shift, res, flags):
    """(fast, exact) of group_norm_bf16act_update_check on int32 bf16 pairs,
    four a vector."""
    fast, exact = torch.empty_like(y), torch.empty_like(y)
    err = lib.group_norm_bf16act_update_check(
        y.data_ptr(), scale.data_ptr(), shift.data_ptr(), res.data_ptr(), flags,
        y.numel() // 4, fast.data_ptr(), exact.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    return fast, exact


@pytest.mark.cuda
def test_port_bf16act_group_norm_update_bit_equal_to_exact_chain(cuda_device):
    """The bf16-activation K3's update after the fp32 affine, as the kernel
    computes it (bf16x2 FiLM with scale + 1, the SiLU chain on the SFU, the
    residual; group_norm_act.cu: act8, silu8, film_f1), is bit-equal to
    the exact per-op chain (each op in fp32, rounded to bf16, expf and
    __frcp_rn) through the kernel's own device functions: the SiLU on all
    65,536 bf16 inputs in both halves of a pair, FiLM and the residual on
    2^20 sampled pairs of bit patterns (every exponent, subnormals,
    infinities, NaNs) and 2^20 of activation-like values; and ex2.approx
    lies within the guard silu8 allows for of expf on every input whose
    result is normal."""
    import ctypes

    from diffphycon_tpu_torch.kernels import _build

    lib = _build.load_library()
    i32 = torch.int32
    every = torch.arange(65536, dtype=torch.int64, device=cuda_device)
    y = every | (every << 16)
    y = torch.where(y >= 2 ** 31, y - 2 ** 32, y).to(i32)  # each pattern in both halves
    zero = torch.zeros_like(y)
    fast, exact = _update_check(lib, y, zero, zero, zero, 0)
    assert torch.equal(fast, exact), int((fast != exact).sum())
    g = torch.Generator(device=cuda_device).manual_seed(26)
    n = 1 << 20

    def bits():
        return torch.randint(-2 ** 31, 2 ** 31, (n,), generator=g, device=cuda_device,
                             dtype=torch.int64).to(i32)

    def values(scale):
        v = (scale * torch.randn(2 * n, generator=g, device=cuda_device)).to(torch.bfloat16)
        return v.view(i32)

    for operands in ((bits(), bits(), bits(), bits()),
                     (values(4.0), values(0.5), values(0.5), values(2.0))):
        for flags in (1, 2, 3):
            fast, exact = _update_check(lib, *operands, flags)
            assert torch.equal(fast, exact), (flags, int((fast != exact).sum()))
    out = torch.zeros(1, dtype=i32, device=cuda_device)
    guard = (ctypes.c_int * 1)()
    assert lib.group_norm_bf16act_exp_ulps(out.data_ptr(), ctypes.addressof(guard),
                                           torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert 0 < out.item() <= guard[0], (out.item(), guard[0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 5, 27, 64), (2, 9, 40, 96), (4, 4, 32, 256),
                                   (50, 2, 16, 512), (2, 16, 128, 64), (1, 3, 3, 8),
                                   (1, 64, 128, 64), (5, 1, 3, 16)])
@pytest.mark.parametrize("linear", [True, False])
def test_port_bf16act_attention_kernels_match_plain(cuda_device, shape, linear):
    """K5 and K6 on bf16 activations at ragged token counts (a sample's last
    64-token tile partly empty), channel counts off 64 and the main path's
    sites; 8192 tokens, more than a K5b cluster holds at once (8 ranks of
    1024 tokens, each in two runs of 512; K6b over 128 key tiles), and 3
    tokens a sample at B = 5."""
    from diffphycon_tpu_torch.kernels import attention as ka

    g = torch.Generator(device=cuda_device).manual_seed(24)
    x = (2 * torch.randn(*shape, generator=g, device=cuda_device) + 0.3).to(torch.bfloat16)
    p = _bf16_attn(shape[-1], g, cuda_device, linear)
    kern = ka.linear_attention_block if linear else ka.attention_block
    plain = ka.linear_attention_block_plain if linear else ka.attention_block_plain
    _bf16act_check(lambda: kern(x, p), lambda: plain(x, p))


@pytest.mark.cuda
def test_port_unet2d_flax_bf16_forward_on_gpu(cuda_device):
    """A dim-16 flax dtype=bfloat16 UNet2D: the kernel forward against the
    plain forward (5e-2, the CPU tests' whole-net bound: rounding flips
    cascade), bfloat16 out, every K1, K2, K3, K5 and K6 launch a
    bf16-activation one; forward_mega refuses the mode."""
    from diffphycon_tpu_torch.nets.init import seeded_init_
    from diffphycon_tpu_torch.nets.unet2d import UNet2D

    net = seeded_init_(UNet2D(dim=16, dim_mults=(1, 2, 4, 8), dtype=torch.bfloat16),
                       torch.Generator().manual_seed(0)).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(25)
    x = torch.randn(4, 16, 128, 2, generator=g, device=cuda_device)
    t = torch.tensor([3.0, 300.0, 700.0, 999.0], device=cuda_device)
    with torch.no_grad():
        kb.reset_launch_counts()
        out = net(x, t)
        counts = kb.launch_counts()
        assert out.dtype == torch.bfloat16
        assert_close(out.float(), net.forward_plain(x, t).float(), 5e-2)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            net.forward_mega(x, t)
    want = chip_smoke.expected_counts(chip_smoke.main_path_calls(16, (1, 2, 4, 8), 4),
                                      bf16act=True)
    assert counts == want, counts


def _untouched_digests(device):
    """SHA-256 (first 16 hex digits) of the outputs of the kernels whose
    bodies the bf16 persistent-kernel redesign must leave as they are: fp32
    K1-K8 (the 3xTF32 bodies of igemm_tc.cuh, linear_attention_tc.cuh and
    attention.cuh, K3, K4, and the persistent kernel's float instance), and
    the per-block bf16 K1 (3x3 by TMA boxes, through the nearest-2x
    upsample, from two sources, and a shape the gather takes), K2, K5 and K6
    (igemm_bf16.cuh and attention_bf16.cuh, whose bodies the persistent
    kernel's bf16 instance now shares), and the bf16-activation K1 (the same
    five convolutions), K2 and K3 (FiLM, and the residual). Inputs from
    numpy generators, nets from seeded_init_ on the CPU, so the digests
    depend on the kernels alone."""
    import hashlib

    import numpy as np

    from diffphycon_tpu_torch.kernels import attention as ka
    from diffphycon_tpu_torch.kernels import cg_pressure as kcg
    from diffphycon_tpu_torch.nets.init import seeded_init_
    from diffphycon_tpu_torch.nets.unet2d import UNet2D
    from diffphycon_tpu_torch.physics.fluids import smoke_env

    rng = np.random.default_rng(23)

    def r(*s, scale=1.0, shift=0.0):
        return torch.as_tensor(rng.normal(size=s).astype(np.float32) * scale + shift,
                               device=device)

    def attn(c, linear):
        p = {"norm_g": r(c, scale=0.1, shift=1.0), "wqkv": r(c, 384, scale=c ** -0.5),
             "wo": r(128, c, scale=128 ** -0.5), "bo": r(c, scale=0.1)}
        if linear:
            p["out_g"] = r(c, scale=0.1, shift=1.0)
        return p

    def bf16(p):
        return {k: v.to(torch.bfloat16) if k in ("wqkv", "wo") else v for k, v in p.items()}

    def digest(t):
        torch.cuda.synchronize()
        return hashlib.sha256(t.float().cpu().numpy().tobytes()).hexdigest()[:16]

    out = {}
    with torch.no_grad():
        for shape in ((3, 16, 128, 64), (2, 2, 16, 512), (5, 1, 24, 256)):
            out[f"k5_f32{list(shape)}"] = digest(
                ka.linear_attention_block(r(*shape), attn(shape[-1], True)))
        for shape in ((50, 2, 16, 512), (3, 4, 7, 64)):
            out[f"k6_f32{list(shape)}"] = digest(
                ka.attention_block(r(*shape), attn(shape[-1], False)))
        c = 256
        pack = {"w1": r(9 * c, c, scale=(9 * c) ** -0.5), "b1": r(c, scale=0.1),
                "gs1": r(c, scale=0.1, shift=1.0), "gb1": r(c, scale=0.1),
                "w2": r(9 * c, c, scale=(9 * c) ** -0.5), "b2": r(c, scale=0.1),
                "gs2": r(c, scale=0.1, shift=1.0), "gb2": r(c, scale=0.1)}
        x, ss = r(2, 4, 32, 256), r(2, 512, scale=0.5)
        out["k7_f32"] = digest(kb.resblock_pair(x, ss, ss, pack, pack, groups=2))
        net = seeded_init_(UNet2D(dim=8, dim_mults=(1, 2, 4, 8)),
                           torch.Generator().manual_seed(0)).to(device)
        out["k8_f32"] = digest(net.forward_mega(r(3, 16, 128, 2),
                                                torch.linspace(0, 999, 3, device=device)))
        # K1 / K2 in both weight dtypes: (name, xa, xb, co, k, upsample)
        convs = (("3x3", (3, 16, 128, 64), None, 64, 3, False),
                 ("up", (2, 8, 64, 128), None, 64, 3, True),
                 ("cat", (2, 8, 64, 128), 64, 128, 3, False),
                 ("cat_1x1", (2, 8, 64, 128), 64, 64, 1, False),
                 ("gather", (2, 4, 20, 48), 24, 40, 3, False))
        for name, xs, cb, co, k, up in convs:
            xa, xb = r(*xs), (r(*xs[:3], cb) if cb else None)
            ci = xs[3] + (cb or 0)
            w, b = r(k * k * ci, co, scale=(k * k * ci) ** -0.5), r(co, scale=0.1)
            for dt in ("f32", "bf16"):
                wd = w if dt == "f32" else w.to(torch.bfloat16)
                out[f"k1_{dt}_{name}"] = digest(kb.conv2d_nhwc(xa, wd, b, x_b=xb, k=k,
                                                               upsample=up))
        x = r(3, 16, 128, 64)
        w, b = r(256, 96, scale=256 ** -0.5), r(96, scale=0.1)
        out["k2_f32"] = digest(kb.downsample_nhwc(x, w, b))
        out["k2_bf16"] = digest(kb.downsample_nhwc(x, w.to(torch.bfloat16), b))
        out["k3_f32"] = digest(kb.group_norm_act(x, r(64, scale=0.1, shift=1.0), r(64), 2,
                                                 ss=r(3, 128, scale=0.5), res=x))
        coeffs = smoke_env.smoke_domain_128().laplacian_coeffs(device)
        p, iters = kcg.cg_pressure(r(8, 127, 127), coeffs, 1e-6, 500)
        out["k4_f32"] = digest(p) + "/" + digest(iters)
        for shape in ((3, 16, 128, 64), (2, 2, 16, 512), (5, 1, 24, 256)):
            out[f"k5_bf16{list(shape)}"] = digest(
                ka.linear_attention_block(r(*shape), bf16(attn(shape[-1], True))))
        for shape in ((50, 2, 16, 512), (3, 4, 7, 64)):
            out[f"k6_bf16{list(shape)}"] = digest(
                ka.attention_block(r(*shape), bf16(attn(shape[-1], False))))
        # the bf16-activation K1, K2 and K3 (flax dtype=bfloat16; drawn last,
        # so that the inputs above stay as they were recorded)
        bf = torch.bfloat16
        for name, xs, cb, co, k, up in convs:
            xa, xb = r(*xs).to(bf), (r(*xs[:3], cb).to(bf) if cb else None)
            ci = xs[3] + (cb or 0)
            w, b = r(k * k * ci, co, scale=(k * k * ci) ** -0.5).to(bf), r(co, scale=0.1)
            out[f"k1_bf16act_{name}"] = digest(kb.conv2d_nhwc(xa, w, b, x_b=xb, k=k,
                                                               upsample=up))
        x = r(3, 16, 128, 64).to(bf)
        w, b = r(256, 96, scale=256 ** -0.5).to(bf), r(96, scale=0.1)
        out["k2_bf16act"] = digest(kb.downsample_nhwc(x, w, b))
        out["k3_bf16act_film"] = digest(kb.group_norm_act(
            x, r(64, scale=0.1, shift=1.0), r(64), 2, ss=r(3, 128, scale=0.5).to(bf)))
        out["k3_bf16act_res"] = digest(kb.group_norm_act(
            x, r(64, scale=0.1, shift=1.0), r(64), 1, res=r(3, 16, 128, 64).to(bf)))
    return out


# recorded on NVIDIA H100 80GB HBM3: the fp32 K5-K8 entries before K5's and
# K6's bf16 variants moved to csrc/attention_bf16.cuh, the bf16-activation
# K1, K2 and K3 entries before the bf16-activation K5 and K6 were redesigned
# (attention_bf16act.cu), the others from the kernels as they were before
# the persistent kernel's bf16 instance moved to igemm_bf16.cuh and
# attention_bf16.cuh
UNTOUCHED_DIGESTS = {
    "k5_f32[3, 16, 128, 64]": "bbeddfc90955d650", "k5_f32[2, 2, 16, 512]": "5a8074b50d321977",
    "k5_f32[5, 1, 24, 256]": "3fa15c66f5d7855b", "k6_f32[50, 2, 16, 512]": "e8b5c7f4d5c1d999",
    "k6_f32[3, 4, 7, 64]": "a25c9b6edcff0e8e", "k7_f32": "6fe6e64efa1397a2",
    "k8_f32": "764fedba11a8ccbd", "k1_f32_3x3": "f83adeaf9db92631",
    "k1_bf16_3x3": "c7785adfa212cabc", "k1_f32_up": "67adf97ed9860365",
    "k1_bf16_up": "e9cce75a2cdbae1f", "k1_f32_cat": "f4a0fced413941a6",
    "k1_bf16_cat": "81f81380d890e6af", "k1_f32_cat_1x1": "4508950b8e69911a",
    "k1_bf16_cat_1x1": "5c02bf56daa56661", "k1_f32_gather": "5139485dfcc202bb",
    "k1_bf16_gather": "c670f6ef49f57c2e", "k2_f32": "a5c7dbe1dd1382e2",
    "k2_bf16": "56069682d7a22bc0", "k3_f32": "c0f27a0ad0842015",
    "k4_f32": "e9056aff984e6d09/ffc9d9983e3c4e00", "k5_bf16[3, 16, 128, 64]": "2726d63b27c5c3bb",
    "k5_bf16[2, 2, 16, 512]": "4ced4eee0a522900", "k5_bf16[5, 1, 24, 256]": "3153e4274788254f",
    "k6_bf16[50, 2, 16, 512]": "d2e9a93c577ab818", "k6_bf16[3, 4, 7, 64]": "ef20c83e845a86b0",
    "k1_bf16act_3x3": "d33dba17a5ace8e9", "k1_bf16act_up": "48462140abb466cc",
    "k1_bf16act_cat": "e4581f5725024804", "k1_bf16act_cat_1x1": "6951f11372d8e3c0",
    "k1_bf16act_gather": "82d55f4235776b68", "k2_bf16act": "dfbe87a0110a7d0b",
    "k3_bf16act_film": "8c877c7a24eb8002", "k3_bf16act_res": "50e6b352aeb1b640"}


# the bf16-activation plans of the parent of the persistent tile at the
# digests' K1c / K2c GEMMs: (m, n, k) -> (splits, per), all at bn 64 (bm 64
# or 128 there: the rows of a tile do not change a sum)
PARENT_BF16ACT_PLANS = {(6144, 64, 576): (2, 5), (4096, 64, 1152): (4, 5),
                        (1024, 128, 1728): (6, 5), (1024, 64, 192): (1, 3),
                        (160, 40, 648): (2, 6), (1536, 96, 256): (1, 4)}


@pytest.mark.cuda
def test_port_untouched_kernels_bit_equal_to_recorded_digests(cuda_device, monkeypatch):
    """fp32 K1-K8, the per-block bf16 K1, K2, K5 and K6 and the
    bf16-activation K1, K2 and K3 give outputs bit-equal to digests recorded
    before later redesigns of other kernels (the persistent kernel's bf16
    instance, the bf16-activation K5 and K6, the persistent tile of K1c and
    K2c): the bodies they run stayed as they were, and K1c and K2c keep the
    old core's sums. K1c and K2c run here under their parent's splits
    (PARENT_BF16ACT_PLANS): a split is a different sum."""
    planner = kb.tile_plan

    def pinned(m, n, k, bf16=False, act=False):
        if not act:
            return planner(m, n, k, bf16)
        splits, per = PARENT_BF16ACT_PLANS[m, n, k]
        return kb.TilePlan(128, 64, splits, per)

    monkeypatch.setattr(kb, "tile_plan", pinned)
    assert _untouched_digests(cuda_device) == UNTOUCHED_DIGESTS
