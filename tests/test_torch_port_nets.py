"""Port UNet2D and its blocks against the JAX package's Flax modules, on
JAX parameter trees carried across by ``load_flax_unet2d`` (and convert's
per-block mappers).

Tolerance: max |port - jax| <= 1e-4 * max(1, max |jax|). Both sides compute
in float32 (JAX at 'highest' matmul precision, see conftest) and differ only
in summation order; the observed gap is ~1e-6 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.nets import blocks as jb
from diffphycon_tpu.nets.unet2d import UNet2D as JaxUNet2D
from diffphycon_tpu.utils.torch_convert import convert_unet2d
from diffphycon_tpu_torch.kernels import attention as ka
from diffphycon_tpu_torch.nets import blocks as tb
from diffphycon_tpu_torch.nets.unet2d import UNet2D
from diffphycon_tpu_torch.utils import convert
from torch_port_helpers import assert_close, flax_tree, rand

RTOL = 1e-4


def _close(out, ref):
    assert_close(out, ref, RTOL)


def _load(module, fill, tree):
    """Load one flax sub-tree into a port module through convert's mappers."""
    sd = {}
    fill(jax.tree.map(np.asarray, tree), "m", sd)
    module.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return module



def test_port_time_mlp():
    t = np.array([0.0, 17.0, 999.0], np.float32)
    mod = jb.TimeMLP(16, 64)
    params = flax_tree(mod, jnp.asarray(t))["params"]

    def fill(tree, name, sd):
        convert._linear(tree["fc1"], f"{name}.1", sd)
        convert._linear(tree["fc2"], f"{name}.3", sd)

    port = _load(tb.time_mlp(16, 64), fill, params)
    _close(tb.sinusoidal_pos_emb(torch.from_numpy(t), 16),
           jb.sinusoidal_pos_emb(jnp.asarray(t), 16))
    with torch.no_grad():
        _close(port(torch.from_numpy(t)), mod.apply({"params": params}, jnp.asarray(t)))


def test_port_chan_layer_norm():
    x = rand(2, 4, 8, 16) * 3 + 1
    mod = jb.ChanLayerNorm(16)
    params = {"g": jnp.asarray(rand(16, seed=1))}
    port = _load(tb.LayerNorm(16), convert._gain, params)
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), mod.apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("ca,cb,co", [(16, 0, 16), (16, 0, 32), (32, 16, 32)])
def test_port_resnet_block(ca, cb, co):
    x, skip = rand(2, 8, 32, ca), rand(2, 8, 32, cb, seed=1)
    temb = rand(2, 64, seed=2)
    xin = np.concatenate([x, skip], -1) if cb else x
    mod = jb.ResnetBlock(co, groups=1)
    params = flax_tree(mod, jnp.asarray(xin), jnp.asarray(temb))["params"]
    ref = mod.apply({"params": params}, jnp.asarray(xin), jnp.asarray(temb))
    port = _load(tb.ResnetBlock(ca + cb, co, 64, groups=1), convert._resnet_block, params)
    x_b = torch.from_numpy(skip) if cb else None
    with torch.no_grad():
        _close(port(torch.from_numpy(x), torch.from_numpy(temb), x_b=x_b), ref)


@pytest.mark.parametrize("linear", [True, False])
def test_port_attention_blocks(linear):
    x = rand(2, 4, 8, 32)
    mod = (jb.LinearAttentionBlock if linear else jb.AttentionBlock)(32)
    params = flax_tree(mod, jnp.asarray(x))["params"]
    port = (tb.LinearAttentionBlock if linear else tb.AttentionBlock)(32)
    port = _load(port, lambda tr, n, sd: convert._attention(tr, f"{n}.fn", sd, linear),
                 params)
    block = ka.linear_attention_block if linear else ka.attention_block
    with torch.no_grad():
        _close(block(torch.from_numpy(x), port.pack()),
               mod.apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["down", "up"])
def test_port_resample_blocks(kind):
    x = rand(2, 8, 16, 16)
    mod = jb.Downsample(32) if kind == "down" else jb.Upsample(8)
    params = flax_tree(mod, jnp.asarray(x))["params"]
    port = tb.Downsample(16, 32) if kind == "down" else tb.Upsample(16, 8)
    port = _load(port, lambda tr, n, sd: convert._conv(tr["conv"], f"{n}.1", sd), params)
    ref = mod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), ref)
    _close(tb.space_to_depth(torch.from_numpy(x)), jb.space_to_depth(jnp.asarray(x)))


@pytest.fixture(scope="module")
def small_unet():
    net = JaxUNet2D(dim=16, dim_mults=(1, 2, 4), channels=2, out_dim=2,
                    resnet_block_groups=1)
    x, t = rand(2, 16, 128, 2), np.array([3.0, 700.0], np.float32)
    params = flax_tree(net, jnp.asarray(x), jnp.asarray(t))
    ref = np.asarray(jax.jit(net.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    port = UNet2D(dim=16, dim_mults=(1, 2, 4), channels=2, out_dim=2)
    convert.load_flax_unet2d(port, params)
    return port, params, x, t, ref


def test_port_unet2d_matches_flax(small_unet):
    port, _, x, t, ref = small_unet
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(t))
        plain = port.forward_plain(torch.from_numpy(x), torch.from_numpy(t))
    _close(out, ref)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


def test_port_unet2d_state_dict_round_trip(small_unet):
    port, params, *_ = small_unet
    back = convert_unet2d(port.state_dict(), num_levels=3)
    same = jax.tree.map(np.array_equal, params["params"], back)
    assert all(jax.tree.leaves(same))
    assert jax.tree.structure(params["params"]) == jax.tree.structure(back)


def test_port_params_npz_round_trip_and_repack(small_unet, tmp_path):
    port, params, x, t, ref = small_unet
    path = tmp_path / "w.npz"
    convert.save_flax_npz(path, params)
    fresh = UNet2D(dim=16, dim_mults=(1, 2, 4), channels=2, out_dim=2)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    with torch.no_grad():
        before = fresh(xt, tt)  # caches kernel-layout weights of the random init
        convert.load_flax_unet2d(fresh, convert.load_flax_npz(path))
        after = fresh(xt, tt)   # the cache must follow load_state_dict
    assert not torch.allclose(before, after)
    torch.testing.assert_close(after, port(xt, tt).detach(), rtol=0, atol=0)
    _close(after, ref)
