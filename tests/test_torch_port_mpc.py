"""The port's jellyfish MPC baseline (``baselines/mpc_jellyfish.py``)
against the JAX package on the CPU: ``mpc_plan`` and
``mpc_receding_horizon`` (Adam) on the JAX tests' stub pipeline, and
``mpc_plan`` on tiny surrogates (UNet2Dv2 / ForceUNet dim 8, mults (1,),
8x8 frames; ``mpc_receding_horizon`` on them in
test_torch_port_mpc_surrogates.py), with JAX's initial draws fed in; and
the port's live-steps-only planning rollout against the masked
fixed-length rollout the JAX program runs.

Tolerances (max |port - jax| <= rtol * max(1, max |jax|)):
- stub pipeline (a few elementwise ops a step): 1e-5 on thetas, states
  and forces after the Adam iterations;
- surrogates: 1e-4. Each replanning iteration differentiates through up to
  num_t steps of three nets (float32 sums in another order, ~1e-6 a
  forward); Adam moves a theta by ~lr = 5e-2 a step, so a wrong term is
  ~500 times the limit;
- live against masked rollout: objective and gradient 1e-6 (the same ops,
  the masked steps multiply by zero).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.baselines import mpc_jellyfish as jmpc
from diffphycon_tpu.benchmarks import jellyfish as jbench
from diffphycon_tpu.nets.unet2dv2 import ForceUNet as JaxForceUNet
from diffphycon_tpu.nets.unet2dv2 import UNet2Dv2 as JaxUNet2Dv2
from diffphycon_tpu_torch.baselines import mpc_jellyfish as tmpc
from diffphycon_tpu_torch.benchmarks import jellyfish as tbench
from diffphycon_tpu_torch.nets.unet2dv2 import ForceUNet, UNet2Dv2
from diffphycon_tpu_torch.utils import convert
from torch_port_helpers import assert_close, flax_tree

H = 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _stubs(xp):
    """The JAX tests' stub pipeline (tests/test_baselines.py) in numpy-like
    ops of ``xp``: the state decays, the boundary offset feeds the force."""
    def sim(x, delta):
        return x[..., :3] * 0.9 + delta.reshape(-1, 1, 1, 1) * 0.01

    def force(x):
        return x[..., 2:3].mean(axis=(1, 2)) if xp is jnp else x[..., 2:3].mean(dim=(1, 2))

    def bd(bd, delta):
        return bd + delta.reshape(-1, 1, 1, 1) * 0.1

    return sim, force, bd


def _stub_pipelines():
    cfg = dict(dim=8, frames=6, image_size=H)
    jsim, jforce, jbd = _stubs(jnp)
    jppl = jbench.SurrogatePipeline(
        jbench.JellyfishConfig(**cfg), lambda p, x, d: jsim(x, d), None,
        lambda p, x: jforce(x), None, lambda p, b, d: jbd(b, d), None)
    tppl = tbench.SurrogatePipeline(tbench.JellyfishConfig(**cfg), *_stubs(torch))
    return jppl, tppl


def _inputs(seed, b=2, h=H):
    rng = np.random.default_rng(seed)
    s0 = rng.normal(size=(b, h, h, 3)).astype(np.float32)
    b0 = rng.normal(size=(b, h, h, 3)).astype(np.float32)
    return s0, b0


def test_port_mpc_plan_matches_jax():
    jppl, tppl = _stub_pipelines()
    s0, b0 = _inputs(3)
    th0 = np.zeros(2, np.float32)
    ref = jmpc.mpc_plan(jppl, jnp.asarray(s0), jnp.asarray(b0), jnp.asarray(th0), horizon=6,
                        lr=5e-2, iters=5, reg_ratio=0.1, seed=0)
    noise = _t(jax.random.normal(jax.random.PRNGKey(0), (2, 6)))  # mpc_plan's draw
    out = tmpc.mpc_plan(tppl, _t(s0), _t(b0), _t(th0), horizon=6, lr=5e-2, iters=5,
                        reg_ratio=0.1, noise=noise)
    np.testing.assert_allclose(out[2], ref[2], rtol=1e-5)
    assert out[2][-1] < out[2][0]
    assert_close(out[0], ref[0], 1e-5)
    assert_close(out[1], ref[1], 1e-5)
    assert float(out[0][:, 0].abs().max()) == 0.0


def _theta_plan0(b, num_t, seed=0):
    """mpc_receding_horizon's initial plan, drawn as JAX draws it."""
    return 0.7 * jax.random.uniform(jax.random.PRNGKey(seed), (b, num_t)) + 0.2


@pytest.mark.parametrize("coefs", [dict(lamda=0.0), dict(lamda=10.0, coef_endcondition=0.5,
                                                         coef_clip=2.0)])
def test_port_mpc_receding_horizon_matches_jax_on_stubs(coefs):
    jppl, tppl = _stub_pipelines()
    s0, b0 = _inputs(5)
    th0 = np.full(2, 0.5, np.float32)
    ref = jmpc.mpc_receding_horizon(jppl, jnp.asarray(s0), jnp.asarray(b0), jnp.asarray(th0),
                                    frames=5, num_iters=6, lr=0.1, **coefs)
    out = tmpc.mpc_receding_horizon(tppl, _t(s0), _t(b0), _t(th0), frames=5, num_iters=6,
                                    lr=0.1, theta_plan0=_t(_theta_plan0(2, 4)), **coefs)
    assert out[0].shape == (2, 5) and out[1].shape == (2, 5, H, H, 3) and out[2].shape == (2, 5)
    for o, r in zip(out, ref):
        assert_close(o, r, 1e-5)
    assert float(out[0][:, 1:].min()) >= 0.2 - 1e-6 and float(out[0][:, 1:].max()) <= 1.1 + 1e-6


def _masked_plan_rollout(ppl, state, bd, theta_prev, plan, t):
    """The JAX program's planning rollout: all num_t steps, the index
    clipped to the plan, each force times live = (t + k < num_t), shifted to
    absolute positions."""
    num_t = plan.shape[1]
    forces, th_prev = [], theta_prev
    for k in range(num_t):
        th_k = plan[:, min(t + k, num_t - 1)]
        delta = th_k - th_prev
        state, force = ppl.step(state, bd, delta)
        bd = ppl.bd_updater(bd, delta)
        forces.append(force * float(t + k < num_t))
        th_prev = th_k
    forces = torch.roll(torch.stack(forces, 1), t, dims=1)
    pos = torch.arange(num_t)[None]
    return torch.where(pos >= t, forces, torch.zeros_like(forces))


@pytest.mark.parametrize("t", [0, 2, 4])
def test_port_live_steps_rollout_equals_masked(t, monkeypatch):
    _, tppl = _stub_pipelines()
    s0, b0 = _inputs(7)
    rng = np.random.default_rng(t)
    plan0 = _t(rng.uniform(0.2, 1.1, size=(2, 5)).astype(np.float32))
    realized = torch.zeros(2, 5)
    realized[:, :t] = _t(rng.normal(size=(2, t)).astype(np.float32))
    args = (_t(s0), _t(b0), torch.tensor([0.5, 0.6]), realized, t, torch.tensor([0.5, 0.6]),
            10.0, 0.5, 2.0, 0.15)
    out = {}
    for name in ("live", "masked"):
        if name == "masked":
            monkeypatch.setattr(tmpc, "plan_rollout", _masked_plan_rollout)
        plan = plan0.clone().requires_grad_(True)
        val = tmpc.mpc_objective(tppl, plan, *args)
        val.backward()
        out[name] = (val.detach(), plan.grad)
    assert_close(out["live"][0], out["masked"][0].numpy(), 1e-6)
    assert_close(out["live"][1], out["masked"][1].numpy(), 1e-6)


def surrogate_pipelines():
    """(JAX pipeline, the port's with the same weights, s0, b0, theta_0):
    UNet2Dv2 simulator
    and bd-updater and the ForceUNet, dim 8, mults (1,), 8x8 frames, the
    pressure denormalised by p_min / p_max."""
    h, small = 8, dict(dim=8, dim_mults=(1,))
    sim = JaxUNet2Dv2(channels=6, out_dim=3, **small)
    bd = JaxUNet2Dv2(channels=3, out_dim=3, **small)
    force = JaxForceUNet(channels=4, **small)
    p_sim = flax_tree(sim, jnp.zeros((1, h, h, 6)), jnp.zeros((1,)), seed=1)
    p_bd = flax_tree(bd, jnp.zeros((1, h, h, 3)), jnp.zeros((1,)), seed=2)
    p_force = flax_tree(force, jnp.zeros((1, h, h, 4)), seed=3)
    cfg = dict(dim=8, frames=4, image_size=h)
    jppl = jbench.SurrogatePipeline(jbench.JellyfishConfig(**cfg), sim.apply, p_sim,
                                    force.apply, p_force, bd.apply, p_bd, p_min=-2.0, p_max=3.0)
    tppl = tbench.SurrogatePipeline(
        tbench.JellyfishConfig(**cfg),
        convert.load_flax_unet2dv2(UNet2Dv2(channels=6, out_dim=3, **small), p_sim),
        convert.load_flax_force_unet(ForceUNet(channels=4, **small), p_force),
        convert.load_flax_unet2dv2(UNet2Dv2(channels=3, out_dim=3, **small), p_bd),
        p_min=-2.0, p_max=3.0)
    s0, b0 = _inputs(9)
    return jppl, tppl, np.tanh(s0), b0, np.array([0.4, 0.7], np.float32)


def test_port_mpc_plan_matches_jax_on_surrogates():
    jppl, tppl, s0, b0, th0 = surrogate_pipelines()
    ref = jmpc.mpc_plan(jppl, jnp.asarray(s0), jnp.asarray(b0), jnp.asarray(th0), horizon=4,
                        lr=5e-2, iters=2, reg_ratio=0.1, seed=1)
    noise = _t(jax.random.normal(jax.random.PRNGKey(1), (2, 4)))
    out = tmpc.mpc_plan(tppl, _t(s0), _t(b0), _t(th0), horizon=4, lr=5e-2, iters=2,
                        reg_ratio=0.1, noise=noise)
    np.testing.assert_allclose(out[2], ref[2], rtol=1e-4)
    assert_close(out[0], ref[0], 1e-4)
    assert_close(out[1], ref[1], 1e-4)


def test_port_mpc_lbfgs_raises_and_names_roadmap():
    _, tppl = _stub_pipelines()
    s0, b0 = _inputs(1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, MPC_LBFGS"):
        tmpc.mpc_receding_horizon(tppl, _t(s0), _t(b0), torch.zeros(2), frames=3,
                                  optimizer="lbfgs")
