"""The port's Burgers latent operator (``nets/burgers_operator.py``), its
training step (``apps/train_burgers_operator.py``) and the SL baseline
through it, against the JAX package on the CPU, at the published widths
(s = 128; s_ob 128 and 64) with seeded weights carried by
``utils.convert.load_flax_burgers_operator``.

Tolerances (max |port - jax| <= rtol * max(1, max |jax|)):
- operator rollout: 1e-5 (conv sums in another order; seen ~3e-6 on a
  field of max ~4); two clipped-AdamW steps: loss 1e-5, parameters 3e-5
  absolute. Adam's lr * g / (|g| + eps) turns 1e-8 rounding in the few
  gradient entries near eps into ~1e-5; the schedule's second lr, were it
  wrong, would move every entry by 1.5e-4, and the decay (weight decay 1
  here) by ~1e-4;
- SL through the operator, 3 Adam steps: 1e-5 on the J history, 1e-3
  absolute on f (2% of the lr 5e-2, see the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffphycon_tpu.baselines.sl_burgers import sl_optimize_control as jax_sl
from diffphycon_tpu.nets.burgers_operator import NetU as JaxNetU
from diffphycon_tpu.nets.burgers_operator import SurrogateOperator as JaxOperator
from diffphycon_tpu.nets.burgers_operator import _upsample_linear_1d as jax_upsample
from diffphycon_tpu.physics import burgers as jburgers
from diffphycon_tpu_torch.apps.train_burgers_operator import make_train_step, operator_loss
from diffphycon_tpu_torch.baselines.sl_burgers import sl_optimize_control
from diffphycon_tpu_torch.nets import burgers_operator as tob
from diffphycon_tpu_torch.utils import convert
from torch_port_helpers import assert_close


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def operators():
    """(JAX operator, its params, the port's with the same weights) at
    s_ob 128 and 64."""
    out = {}
    for s_ob in (128, 64):
        jop = JaxOperator(s=128, s_ob=s_ob)
        rng = np.random.default_rng(s_ob)

        def fill(path, leaf):  # kernels N(0, 1/fan_in), biases 0.1 N(0, 1)
            scale = (1 / np.sqrt(np.prod(leaf.shape[:-1])) if path[-1].key == "kernel"
                     else 0.1)
            return (scale * rng.normal(size=leaf.shape)).astype(np.float32)

        params = jax.tree_util.tree_map_with_path(
            fill, jax.eval_shape(jop.init, jax.random.PRNGKey(0)))
        top = tob.SurrogateOperator(s=128, s_ob=s_ob, device="cpu")
        convert.load_flax_burgers_operator(top, params)
        out[s_ob] = (jop, params, top)
    return out


def test_port_upsample_linear_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 7, 3)).astype(np.float32)  # (B, N, C)
    out = tob._upsample_linear_1d(_t(x).permute(0, 2, 1)).permute(0, 2, 1)
    assert_close(out, jax_upsample(jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("s_ob", [128, 64])
def test_port_operator_simulate_and_rollout_match_jax(operators, s_ob):
    jop, params, top = operators[s_ob]
    rng = np.random.default_rng(s_ob)
    u0 = rng.normal(size=(3, s_ob)).astype(np.float32)
    f = rng.normal(size=(3, 4, 128)).astype(np.float32)
    with torch.no_grad():
        assert_close(top.simulate(_t(u0), _t(f[:, 0])),
                     jop.simulate(params, jnp.asarray(u0), jnp.asarray(f[:, 0])), 1e-5)
        out = top.rollout(_t(u0), _t(f))
    assert out.shape == (3, 5, s_ob)
    assert_close(out, jop.rollout(params, jnp.asarray(u0), jnp.asarray(f)), 1e-5)


def _jax_operator_loss(op, s_ob):
    """The JAX app's loss (apps/train_burgers_operator.py:92-116)."""
    h4 = s_ob // 4

    def rel(a, b):
        num = jnp.linalg.norm((a - b).reshape(a.shape[0], -1), axis=1)
        return num / (jnp.linalg.norm(b.reshape(b.shape[0], -1), axis=1) + 1e-8)

    def loss_fn(params, ut, ft, un):
        f_in, u_in, un_in = ft[..., None], ut[..., None], un[..., None]
        f_rec, f_lat = op.net_f.apply(params["f"], f_in)
        u_rec, u_lat = op.net_u.apply(params["u"], u_in)
        _, un_lat = op.net_u.apply(params["u"], un_in)
        if u_lat.shape[-1] < f_lat.shape[-1]:
            f_lat = f_lat[:, : u_lat.shape[-1]] + f_lat[:, u_lat.shape[-1]:]
        trans = op.net_trans.apply(params["trans"], jnp.concatenate(
            [u_lat.reshape(-1, 8, h4), f_lat.reshape(-1, 8, h4)], axis=1))
        u_next = op.net_u.apply(params["u"], trans.reshape(-1, 8 * h4), method=JaxNetU.decode)
        return (rel(f_rec, f_in).mean() + 0.5 * rel(u_rec, u_in).mean()
                + 2.5 * rel(u_next, un_in).mean() + rel(trans.reshape(-1, 8 * h4), un_lat).mean())

    return loss_fn


@pytest.mark.parametrize("s_ob", [128, 64])
def test_port_operator_train_step_matches_jax(operators, s_ob):
    """Two clipped-AdamW steps under the cosine schedule (optax chain of
    clip_by_global_norm and adamw(cosine_decay_schedule)); the clip is
    active (the rel-norm gradients exceed 0.05), the weight decay 1 so that
    its term shows."""
    jop, params, _ = operators[s_ob]
    top = tob.SurrogateOperator(s=128, s_ob=s_ob, device="cpu")
    convert.load_flax_burgers_operator(top, params)
    rng = np.random.default_rng(7)
    batches = [tuple(rng.normal(size=(6, n)).astype(np.float32) for n in (s_ob, 128, s_ob))
               for _ in range(2)]
    lr, n_steps, wd, clip = 1e-3, 4, 1.0, 0.05
    tx = optax.chain(optax.clip_by_global_norm(clip),
                     optax.adamw(optax.cosine_decay_schedule(lr, n_steps), weight_decay=wd))
    loss_fn = _jax_operator_loss(jop, s_ob)

    @jax.jit
    def jax_step(p, state, ut, ft, un):
        loss, g = jax.value_and_grad(loss_fn)(p, ut, ft, un)
        upd, state = tx.update(g, state, p)
        return optax.apply_updates(p, upd), state, loss, optax.global_norm(g)

    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(p)
    step = make_train_step(top, lr, n_steps, wd, clip)
    for i, (ut, ft, un) in enumerate(batches):
        p, state, jl, gnorm = jax_step(p, state, *map(jnp.asarray, (ut, ft, un)))
        tl = step(i, _t(ut), _t(ft), _t(un))
        assert abs(float(tl) - float(jl)) <= 1e-5 * max(1.0, abs(float(jl)))
        if i == 0:
            assert float(gnorm) > clip
    sd = top.state_dict()
    for k, v in convert.flax_burgers_operator_to_state_dict(
            jax.tree_util.tree_map(np.asarray, p)).items():
        assert float((sd[k] - _t(v)).abs().max()) <= 3e-5, k
    # the port's loss is the JAX app's at the trained weights
    ut, ft, un = batches[0]
    _, _, jl, _ = jax_step(p, state, *map(jnp.asarray, (ut, ft, un)))
    assert_close(operator_loss(top, _t(ut), _t(ft), _t(un)).detach(), jl, 1e-5)


@pytest.mark.parametrize("partial_control", [None, "front_rear_quarter"])
def test_port_sl_through_operator_matches_jax(operators, partial_control):
    jop, params, top = operators[128]
    u0, f = jburgers.make_burgers_data(2, seed=5)
    traj = np.asarray(jburgers.burgers_solve(jnp.asarray(u0), jnp.asarray(f), dt=1e-3))
    f_ref, hist_ref = jax_sl(jnp.asarray(u0), jnp.asarray(traj[:, -1]), lr=5e-2, steps=3,
                             partial_control=partial_control, surrogate=(jop, params))
    state = {k: v.clone() for k, v in top.state_dict().items()}
    f_out, hist = sl_optimize_control(_t(u0), _t(traj[:, -1]), lr=5e-2, steps=3,
                                      partial_control=partial_control, surrogate=(top, state))
    np.testing.assert_allclose(hist, hist_ref, rtol=1e-5)
    # one entry's gradient is ~7e-10, under Adam's eps, where the two agree
    # to 3% only: its update lr * g / (|g| + eps) differs by ~1e-4 a step
    assert float((f_out - _t(f_ref)).abs().max()) <= 1e-3
    # the operator's own weights took no gradient and did not move
    assert all(p.grad is None for p in top.parameters())
    assert all(torch.equal(v, state[k]) for k, v in top.state_dict().items())
