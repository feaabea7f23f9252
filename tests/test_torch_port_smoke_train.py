"""Smoke training in the port against the JAX package on the CPU: one
optimizer step of the UNet3D (dim 8, mults (1, 2), 4 frames of 16x16) on
the smoke spec, joint (C=6) and w model (C=2), with JAX's t and noise fed
in: ``p_losses`` through the Trainer's backward, clip, Adam on MultiStepLR
and EMA, against ``jax.value_and_grad`` and ``TrainState.apply_gradients``,
with and without ``remat_all``. The app is in
test_torch_port_smoke_train_app.py.

Tolerances (max |port - jax| <= rtol * max(1, max |jax|)):
- the loss: 1e-5, the net's float32 sums in another order; the gradient:
  1e-5 of its largest entry;
- the updated weights: 1e-6 (Adam's first step moves each weight by ~lr *
  sign(g)), but where the gradient is under 1e-3 of its largest entry
  (rounding noise, e.g. the conv biases before a GroupNorm, which Adam
  scales up to ~lr either way): 2 * lr;
- remat_all against without: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.benchmarks import smoke as jbench
from diffphycon_tpu.training import train_state as jts
from diffphycon_tpu_torch.benchmarks import smoke as tbench
from diffphycon_tpu_torch.diffusion import smoke_derive_cond
from diffphycon_tpu_torch.training.trainer import Trainer, TrainerConfig
from diffphycon_tpu_torch.utils import convert
from torch_port_helpers import flax_tree, rand

SMALL = dict(dim=8, dim_mults=(1, 2), frames=4, image_size=16)
LR = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_step(ch, params, x, t, key):
    """JAX's loss, gradient and weights after one TrainState step."""
    cfg = jbench.SmokeConfig(is_w_model=ch == 2, **SMALL)
    gd = jbench.build_diffusion(cfg, jbench.build_unet(cfg).apply)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: gd.p_losses(p, key, x, t, jbench.derive_cond(x))))(params)
    state = jts.TrainState.create(params, jts.make_optimizer(jts.multistep_lr(
        LR, (50_000, 150_000, 300_000), 0.1)), jts.EMAConfig())
    state = jax.jit(lambda s, g: s.apply_gradients(g))(state, grads)
    return (float(loss), convert.flax_unet3d_to_state_dict(jax.device_get(grads)),
            convert.flax_unet3d_to_state_dict(jax.device_get(state.params)))


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """{ch: (JAX loss, grads, weights, {remat_all: (port loss, grads,
    weights)})}."""
    out = {}
    for ch in (6, 2):
        cfg = tbench.SmokeConfig(is_w_model=ch == 2, **SMALL)
        jnet = jbench.build_unet(jbench.SmokeConfig(is_w_model=ch == 2, **SMALL))
        params = flax_tree(jnet, jnp.zeros((1, 4, 16, 16, ch)), jnp.zeros((1,)), seed=ch)
        x = np.clip(rand(2, 4, 16, 16, ch, seed=ch), -1, 1)
        t = np.array([5, 640])
        key = jax.random.PRNGKey(ch)
        noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
        ports = {}
        for remat_all in (False, True):
            net = convert.load_flax_unet3d(
                tbench.UNet3D(dim=8, dim_mults=(1, 2), channels=ch, out_dim=ch,
                              remat_all=remat_all), params)
            gd = tbench.build_diffusion(cfg, net, device="cpu")
            folder = tmp_path_factory.mktemp(f"run{ch}{remat_all}")
            tr = Trainer(gd, net, iter(()), smoke_derive_cond,
                         TrainerConfig(train_lr=LR, lr_schedule="multistep",
                                       results_folder=str(folder)), device="cpu")
            loss = gd.p_losses(_t(x), _t(t), smoke_derive_cond(_t(x)), _t(noise))
            loss.backward()
            grads = {k: v.grad.clone() for k, v in net.named_parameters()}
            tr.apply_gradients()
            ports[remat_all] = (float(loss.detach()), grads,
                                {k: v.detach().clone() for k, v in net.state_dict().items()})
        out[ch] = (*_jax_step(ch, params, jnp.asarray(x), jnp.asarray(t), key), ports)
    return out


@pytest.mark.parametrize("remat_all", [False, True])
@pytest.mark.parametrize("ch", [6, 2])
def test_port_smoke_train_step_matches_jax(steps, ch, remat_all):
    jloss, jgrads, jw, ports = steps[ch]
    loss, grads, w = ports[remat_all]
    assert abs(loss - jloss) <= 1e-5 * max(1.0, abs(jloss))
    gmax = max(float(np.abs(g).max()) for g in jgrads.values())
    bad = {}
    for k, v in w.items():
        g = _t(jgrads[k])
        gerr = float((grads[k] - g).abs().max())
        # Adam's first step is ~lr * sign(g): the weights agree to 1e-6 where
        # the gradient stands clear of rounding noise, to 2 * lr elsewhere
        # (e.g. a conv bias right before a GroupNorm: zero gradient in exact
        # arithmetic)
        tol = torch.where(g.abs() > 1e-3 * gmax, 1e-6 * max(1.0, float(np.abs(jw[k]).max())),
                          2 * LR)
        if gerr > 1e-5 * max(1.0, gmax) or bool(((v - _t(jw[k])).abs() > tol).any()):
            bad[k] = gerr
    assert not bad, bad


@pytest.mark.parametrize("ch", [6, 2])
def test_port_smoke_train_step_remat_exact(steps, ch):
    (l0, _, w0), (l1, _, w1) = steps[ch][3][False], steps[ch][3][True]
    assert l0 == l1
    assert all(torch.equal(w0[k], w1[k]) for k in w0)
