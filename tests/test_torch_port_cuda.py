"""The port's hand-written kernels against their plain versions on an
NVIDIA GPU (``cuda`` marker; skips without a GPU).

This file imports neither JAX nor ``diffphycon_tpu``, so it also runs where
only the port is installed:
``python -m pytest tests/test_torch_port_cuda.py -q -m cuda --noconftest``.

Tolerance: max |kernel - plain| <= 1e-4 * max(1, max |plain|); both are
float32 and differ in summation order only.
"""

import pytest
import torch

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
@pytest.mark.parametrize("shape", [(50, 2, 16, 512), (3, 4, 7, 64)])
def test_port_attention_kernel_matches_plain_on_gpu(cuda_device, shape):
    """K6 at the Burgers bottleneck (32 tokens, 512 channels) and at a ragged
    28-token tile."""
    from diffphycon_tpu_torch.kernels import attention as ka

    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(*shape, generator=g, device=cuda_device)
    p = _attn_params(shape[-1], g, cuda_device, linear=False)
    assert_close(ka.attention_block(x, p), ka.attention_block_plain(x, p), RTOL)
    with pytest.raises(TypeError, match="float32"):
        ka.attention_block(x.double(), {k: v.double() for k, v in p.items()})
    with pytest.raises(ValueError, match="channels"):
        ka.attention_block(torch.randn(1, 2, 2, 1024, device=cuda_device),
                           _attn_params(1024, g, cuda_device, linear=False))
    with pytest.raises(ValueError, match="tokens"):
        ka.attention_block(torch.randn(1, 4, 16, shape[-1], device=cuda_device), p)


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
