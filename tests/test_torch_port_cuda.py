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
