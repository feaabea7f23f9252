"""Plain versions of K5 (linear attention) and K6 (full attention) against
the Pallas kernels they replace (interpret mode) and their XLA twins, their
VJPs against ``jax.vjp`` of the flax blocks, and the 1x1 conv of K1 against
``_matmul_bias_kernel`` (Pallas row 8).

Tolerances (max |port - jax| <= rtol * max(1, max |jax|)):
- forwards: 1e-5, float32 on both sides, summation order only;
- VJPs: 1e-4 for the input and every parameter gradient (a backward sums
  over all tokens and channels in another order);
- the parameter gradients of a UNet2D denoising loss: per tensor, max abs
  <= 1e-4 * max(1, max |jax grad|) (a ~40-block backward in another order).

The kernels themselves run only on an NVIDIA GPU (test_torch_port_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.benchmarks import burgers as jbench
from diffphycon_tpu.nets import blocks as jb
from diffphycon_tpu.nets.unet2d import UNet2D as JaxUNet2D
from diffphycon_tpu.research import pallas_unet2d as pu
from diffphycon_tpu_torch.benchmarks import burgers as tbench
from diffphycon_tpu_torch.kernels import attention as ka
from diffphycon_tpu_torch.kernels import unet2d_blocks as kb
from diffphycon_tpu_torch.nets import blocks as tb
from diffphycon_tpu_torch.nets.unet2d import UNet2D
from diffphycon_tpu_torch.utils import convert
from torch_port_helpers import assert_close, flax_tree, rand

FWD_RTOL = 1e-5
VJP_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _interpret():
    pu.set_interpret(True)
    yield
    pu.set_interpret(False)


def _attn_params(c, linear, seed=0):
    p = {"norm_g": 1 + 0.1 * rand(c, seed=seed),
         "wqkv": rand(c, 384, seed=seed + 1) / np.sqrt(c),
         "wo": rand(128, c, seed=seed + 2) / np.sqrt(128), "bo": 0.1 * rand(c, seed=seed + 3)}
    if linear:
        p["out_g"] = 1 + 0.1 * rand(c, seed=seed + 4)
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("linear", [True, False])
@pytest.mark.parametrize("c", [16, 32])
def test_port_attention_plain_matches_pallas_and_xla(linear, c):
    x = 2 * rand(2, 4, 8, c, seed=5) + 0.3
    p = _attn_params(c, linear)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    if linear:
        pallas = pu.linear_attention_block(jnp.asarray(x), jp)
        xla = pu.linear_attention_block_xla(jnp.asarray(x), jp)
        out = ka.linear_attention_block_plain(torch.from_numpy(x), tp)
        wrapped = ka.linear_attention_block(torch.from_numpy(x), tp)
    else:
        pallas = pu.attention_block(jnp.asarray(x), jp)
        xla = pu.attention_block_xla(jnp.asarray(x), jp)
        out = ka.attention_block_plain(torch.from_numpy(x), tp)
        wrapped = ka.attention_block(torch.from_numpy(x), tp)
    assert_close(out, pallas, FWD_RTOL)
    assert_close(out, xla, FWD_RTOL)
    torch.testing.assert_close(wrapped, out, rtol=0, atol=0)  # CPU takes the plain version


@pytest.mark.parametrize("linear", [True, False])
def test_port_attention_block_vjp_matches_jax(linear):
    """Input and parameter gradients of <block(x), w> through the port's
    block module (packed weights, plain version on the CPU) against jax.vjp
    of the flax block, the parameter gradients carried through the
    converter's mapping (a linear map, so it maps gradients too)."""
    x, w = rand(2, 4, 8, 32, seed=1), rand(2, 4, 8, 32, seed=2)
    mod = (jb.LinearAttentionBlock if linear else jb.AttentionBlock)(32)
    params = flax_tree(mod, jnp.asarray(x))["params"]
    out, vjp = jax.vjp(lambda pr, xx: mod.apply({"params": pr}, xx), params, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(w))

    def to_sd(tree):
        sd = {}
        convert._attention(jax.tree.map(np.asarray, tree), "fn", sd, linear)
        return sd

    port = (tb.LinearAttentionBlock if linear else tb.AttentionBlock)(32)
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in to_sd(params).items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    y = (ka.linear_attention_block if linear else ka.attention_block)(xt, port.pack())
    (y * torch.from_numpy(w)).sum().backward()
    assert_close(y, out, FWD_RTOL)
    assert_close(xt.grad, gx, VJP_RTOL)
    ref = to_sd(gp)
    for name, prm in port.named_parameters():
        assert_close(prm.grad, ref[name], VJP_RTOL)


def test_port_attention_pack_layout():
    """A block's pack() is the Pallas _attn_p layout of the same weights."""
    x = rand(2, 4, 8, 16)
    for linear in (True, False):
        mod = (jb.LinearAttentionBlock if linear else jb.AttentionBlock)(16)
        params = flax_tree(mod, jnp.asarray(x))["params"]
        port = (tb.LinearAttentionBlock if linear else tb.AttentionBlock)(16)
        sd = {}
        convert._attention(jax.tree.map(np.asarray, params), "fn", sd, linear)
        port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
        ref = pu._attn_p({"norm": params["norm"], "attn": params["attn"]})
        packed = port.pack()
        assert set(packed) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(packed[k].detach().numpy(), np.asarray(ref[k]))


def test_port_conv1x1_plain_matches_pallas_matmul_bias():
    """K1 with k=1 computes x @ w + b, the Pallas _matmul_bias_kernel."""
    x = rand(2, 4, 16, 24)
    w, b = rand(24, 12, seed=1) / np.float32(np.sqrt(24)), 0.1 * rand(12, seed=2)
    ref = pu.conv(jnp.asarray(x), {"w": jnp.asarray(w), "b": jnp.asarray(b)}, 1, 1)
    out = kb.conv2d_nhwc_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                               k=1)
    assert_close(out, ref, FWD_RTOL)


def test_port_attention_wrappers_on_cpu_launch_nothing():
    kb.reset_launch_counts()
    x = torch.from_numpy(rand(1, 2, 4, 16))
    tp = {k: torch.from_numpy(v) for k, v in _attn_params(16, True).items()}
    ka.linear_attention_block(x, tp)
    ka.attention_block(x, tp)
    counts = kb.launch_counts()
    assert counts["linear_attention_block"] == 0 and counts["attention_block"] == 0


def test_port_unet2d_loss_gradients_match_jax_grad():
    """Every parameter gradient of the Burgers denoising loss (u0/uT
    conditioning) through a dim-8, mults (1, 2) UNet2D against jax.grad,
    fed JAX's noise and t; the JAX gradient tree carried to the port's
    parameter names by the converter."""
    net = JaxUNet2D(dim=8, dim_mults=(1, 2), channels=2, out_dim=2, resnet_block_groups=1)
    x = 0.5 * rand(2, 16, 32, 2, seed=3)
    t = np.array([11, 650])
    params = flax_tree(net, jnp.asarray(x), jnp.asarray(t, jnp.float32))
    key = jax.random.PRNGKey(7)
    kw = dict(is_condition_u0=True, is_condition_uT=True)
    jgd = jbench.build_diffusion(jbench.BurgersConfig(**kw), net.apply)
    cond = jbench.derive_cond(jnp.asarray(x))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jgd.p_losses(p, key, jnp.asarray(x), jnp.asarray(t), cond)))(params)
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))

    port = convert.load_flax_unet2d(UNet2D(dim=8, dim_mults=(1, 2)), params)
    tgd = tbench.build_diffusion(tbench.BurgersConfig(**kw), port, device="cpu")
    xt = torch.from_numpy(x)
    loss = tgd.p_losses(xt, torch.from_numpy(t), tbench.derive_cond(xt), torch.from_numpy(noise))
    loss.backward()
    assert_close(loss, jloss, 1e-5)
    ref = convert.flax_unet2d_to_state_dict(jax.tree.map(np.asarray, jgrads))
    named = dict(port.named_parameters())
    assert set(named) == set(ref)
    for name, prm in named.items():
        assert_close(prm.grad, ref[name], 1e-4)
