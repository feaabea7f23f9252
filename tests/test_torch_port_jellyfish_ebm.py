"""The port's jellyfish EBM loss against the JAX package on the CPU, at a
small size (the joint UNet3D 7 -> 4 channels, dim 8, mults (1, 2), batch 2
of 4 frames of 16x16): the loss and its parameter gradient (double
backward: the gradient of -sum(model(x)^2) with respect to the noisy state
is matched to the noise), with JAX's t and noise fed in, through the port's
UNet3D with and without remat_all.

Tolerances (max |port - jax| <= rtol * max(1, max |jax|)):
- the loss: 1e-5, the net's float32 sums in another order;
- the parameter gradient: 1e-4 of the largest gradient entry, a
  second-order quantity: the backward of the backward through every conv,
  GroupNorm and attention carries the forwards' ~1e-6 gap two passes
  further;
- remat against no remat: exact (the same ops recomputed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.benchmarks import jellyfish as jbench
from diffphycon_tpu.nets.unet3d import UNet3D as JaxUNet3D
from diffphycon_tpu_torch.benchmarks import jellyfish as tbench
from diffphycon_tpu_torch.nets.unet3d import UNet3D
from diffphycon_tpu_torch.utils import convert
from torch_port_helpers import flax_tree

F, H, B = 4, 16, 2
CFG = dict(dim=8, dim_mults=(1, 2), frames=F, image_size=H, timesteps=20,
           beta_schedule="cosine")


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(seed):
    rng = np.random.default_rng(seed)
    state0 = rng.uniform(-1, 1, size=(B, F, H, H, 3)).astype(np.float32)
    bd0 = rng.normal(size=(B, F, H, H, 3)).astype(np.float32)
    thetas0 = rng.normal(size=(B, F)).astype(np.float32)
    return state0, bd0, thetas0



@pytest.fixture(scope="module")
def ebm():
    """JAX's EBM loss and parameter gradient (jitted, remat on as its default
    is), and the port's from the same weights and draws, with remat_all off
    and on."""
    net = JaxUNet3D(dim=8, dim_mults=(1, 2), channels=7, out_dim=4)
    p = flax_tree(net, jnp.zeros((1, F, H, H, 7)), jnp.zeros((1,)), seed=0)
    jgd = jbench.JellyfishDiffusion(jbench.JellyfishConfig(**CFG), net.apply)
    state0, bd0, thetas0 = _batch(0)
    t = np.array([3, 17])
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, state0.shape, jnp.float32))
    loss, grads = jax.jit(jax.value_and_grad(jgd.p_losses_states))(
        p, key, jnp.asarray(state0), jnp.asarray(bd0), jnp.asarray(thetas0), jnp.asarray(t))
    out = {"jax": (float(loss), convert.flax_unet3d_to_state_dict(jax.device_get(grads)))}
    for remat_all in (False, True):
        port = convert.load_flax_unet3d(
            UNet3D(dim=8, dim_mults=(1, 2), channels=7, out_dim=4, remat_all=remat_all), p)
        gd = tbench.JellyfishDiffusion(tbench.JellyfishConfig(**CFG), port, device="cpu")
        lp = gd.p_losses_states(_t(state0), _t(bd0), _t(thetas0), _t(t), _t(noise))
        lp.backward()
        out[remat_all] = (float(lp.detach()), {k: v.grad for k, v in port.named_parameters()})
    return out


@pytest.mark.parametrize("remat_all", [False, True])
def test_port_ebm_loss_and_grad_match_jax(ebm, remat_all):
    jloss, jgrad = ebm["jax"]
    loss, grad = ebm[remat_all]
    assert abs(loss - jloss) <= 1e-5 * max(1.0, abs(jloss))
    assert grad.keys() == jgrad.keys()
    scale = max(float(np.abs(v).max()) for v in jgrad.values())
    for k, g in grad.items():
        err = float((g - _t(jgrad[k])).abs().max())
        assert err <= 1e-4 * max(1.0, scale), (k, err)


def test_port_ebm_grad_remat_equals_no_remat(ebm):
    assert ebm[True][0] == ebm[False][0]
    for k, g in ebm[True][1].items():
        assert torch.equal(g, ebm[False][1][k]), k
