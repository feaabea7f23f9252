"""The port's RL baselines (``baselines/rl.py``) against the JAX package on
the CPU: every net at small widths (the conv nets at 64x64, where flax's
"SAME" stride-2 padding is (0, 1) and its transposed conv unflipped), the
log prob and soft clamp, the replay buffers' sampled batches, and one update
of each learner (BC, ValueLearner, QSarsaLearner, BPPO, SAC) from the same
weights (carried by ``utils.convert``), the same numpy-sampled batch and
JAX's noise fed in.

Tolerances (max |port - jax| <= rtol * max(1, max |jax|)):
- nets: 1e-5 (float32 sums in another order);
- updates: losses 1e-5; parameters 1e-6 absolute. Each Adam step moves
  an entry by ~lr = 1e-3 (lr * g / (|g| + eps)), so a wrong loss term is
  ~1e3 times the limit; the only exact-zero gradients (dead ReLUs) are
  zero on both sides. BPPO's advantage over a batch of 32 normalised by
  the unbiased std (torch's default) in place of jnp.std's population std
  would scale its loss by sqrt(32 / 31), 1.6%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.baselines import rl as jrl
from diffphycon_tpu_torch.baselines import rl as trl
from diffphycon_tpu_torch.utils import convert
from torch_port_helpers import assert_close, flax_tree

S, A, H, D = 8, 6, 16, 2  # state dim, action dim, hidden, depth
LR, BATCH = 1e-3, 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _toy_buffers(seed=0, b=16, t=10):
    """The same offline transitions in the JAX and the port's buffer."""
    rng = np.random.default_rng(seed)
    states = rng.normal(size=(b, t + 1, S)).astype(np.float32)
    actions = np.tanh(rng.normal(size=(b, t, A))).astype(np.float32)
    rewards = -np.linalg.norm(states[:, 1:], axis=-1).astype(np.float32)
    return (jrl.ReplayBuffer.from_trajectories(states, actions, rewards),
            trl.ReplayBuffer.from_trajectories(states, actions, rewards))


def test_port_log_prob_and_soft_clamp_match_jax():
    rng = np.random.default_rng(0)
    mu, a = rng.normal(size=(2, 3, 4)).astype(np.float32), rng.normal(size=(2, 3, 4))
    std = np.exp(rng.normal(size=(2, 3, 4))).astype(np.float32)
    assert_close(trl.gauss_log_prob(_t(mu), _t(std), _t(a.astype(np.float32))),
                 jrl.gauss_log_prob(jnp.asarray(mu), jnp.asarray(std), jnp.asarray(a)), 1e-6)
    x = np.linspace(-1, 1, 11).astype(np.float32)
    assert_close(trl.soft_clamp(_t(x), -5.0, 0.0), jrl.soft_clamp(jnp.asarray(x), -5.0, 0.0),
                 1e-7)


def test_port_mlp_nets_match_jax():
    rng = np.random.default_rng(1)
    s, a = rng.normal(size=(5, S)).astype(np.float32), rng.normal(size=(5, A)).astype(np.float32)
    pol = jrl.GaussPolicyMLP(H, D, A)
    p = flax_tree(pol, jnp.zeros((1, S)), seed=1)
    tpol = convert.load_flax_mlp(trl.GaussPolicyMLP(S, H, D, A), p)
    mu, std = pol.apply(p, jnp.asarray(s))
    tmu, tstd = tpol(_t(s))
    assert_close(tmu, mu, 1e-5)
    assert_close(tstd, std, 1e-5)
    v = jrl.ValueMLP(H, D)
    pv = flax_tree(v, jnp.zeros((1, S)), seed=2)
    assert_close(convert.load_flax_mlp(trl.ValueMLP(S, H, D), pv)(_t(s)),
                 v.apply(pv, jnp.asarray(s)), 1e-5)
    q = jrl.QMLP(H, D)
    pq = flax_tree(q, jnp.zeros((1, S)), jnp.zeros((1, A)), seed=3)
    assert_close(convert.load_flax_mlp(trl.QMLP(S, A, H, D), pq)(_t(s), _t(a)),
                 q.apply(pq, jnp.asarray(s), jnp.asarray(a)), 1e-5)


@pytest.mark.parametrize("size", [64, 20])  # 20: odd sizes (10 -> 5 -> 3) pad (1, 1)
def test_port_conv_nets_match_jax(size):
    rng = np.random.default_rng(size)
    s = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    a = rng.normal(size=(2, size, size, 2)).astype(np.float32)
    q = jrl.ConvQ(features=8, hidden_dim=16)
    pq = flax_tree(q, jnp.zeros((1, size, size, 3)), jnp.zeros((1, size, size, 2)), seed=5)
    tq = convert.load_flax_conv_q(trl.ConvQ(5, size, features=8, hidden_dim=16), pq)
    assert_close(tq(_t(s), _t(a)), q.apply(pq, jnp.asarray(s), jnp.asarray(a)), 1e-5)
    if size % 8:
        return  # the policy's decoder doubles 8 -> 64 back to the input size only
    pol = jrl.ConvGaussPolicy(action_channels=2, features=8)
    pp = flax_tree(pol, jnp.zeros((1, size, size, 3)), seed=4)
    tpol = convert.load_flax_conv_gauss_policy(trl.ConvGaussPolicy(3, 2, features=8), pp)
    mu, std = pol.apply(pp, jnp.asarray(s))
    tmu, tstd = tpol(_t(s))
    assert tmu.shape == (2, size, size, 2)
    assert_close(tmu, mu, 1e-5)
    assert_close(tstd, std, 1e-5)


def test_port_replay_buffers_sample_what_jax_samples():
    jbuf, tbuf = _toy_buffers()
    for ref, out in zip(jbuf.sample(np.random.default_rng(3), 7),
                        tbuf.sample(np.random.default_rng(3), 7, "cpu")):
        assert np.array_equal(np.asarray(ref), out.numpy())
    jr, tr = jrl.RingReplay(10, S, A), trl.RingReplay(10, S, A)
    rng = np.random.default_rng(4)
    for n in (6, 7):  # wraps around
        batch = (rng.normal(size=(n, S)), rng.normal(size=(n, A)), rng.normal(size=n),
                 rng.normal(size=(n, S)), 1.0)
        jr.push_batch(*batch)
        tr.push_batch(*batch)
    assert (tr.pos, tr.size) == (jr.pos, jr.size) == (3, 10)
    for ref, out in zip(jr.sample(np.random.default_rng(5), 9),
                        tr.sample(np.random.default_rng(5), 9, "cpu")):
        assert np.array_equal(np.asarray(ref), out.numpy())


def _assert_params(module, sd_ref):
    sd = module.state_dict()
    for k, v in sd_ref.items():
        assert float((sd[k] - _t(v)).abs().max()) <= 1e-6, k


def _learners():
    """(JAX learner, port learner with its weights) pairs for BC, V and Q."""
    jbc = jrl.BehaviorCloning(S, A, H, D, lr=LR, batch_size=BATCH, seed=0)
    tbc = trl.BehaviorCloning(S, A, H, D, lr=LR, batch_size=BATCH, seed=0, device="cpu")
    convert.load_flax_mlp(tbc.policy, _np(jbc.params))
    jv = jrl.ValueLearner(S, H, D, lr=LR, batch_size=BATCH, seed=1)
    tv = trl.ValueLearner(S, H, D, lr=LR, batch_size=BATCH, seed=1, device="cpu")
    convert.load_flax_mlp(tv.net, _np(jv.params))
    jq = jrl.QSarsaLearner(S, A, H, D, lr=LR, batch_size=BATCH, seed=2)
    tq = trl.QSarsaLearner(S, A, H, D, lr=LR, batch_size=BATCH, seed=2, device="cpu")
    convert.load_flax_mlp(tq.net, _np(jq.params))
    convert.load_flax_mlp(tq.target, _np(jq.target_params))
    return (jbc, tbc), (jv, tv), (jq, tq)


def test_port_bc_value_qsarsa_bppo_updates_match_jax():
    buf, tbuf = _toy_buffers()
    (jbc, tbc), (jv, tv), (jq, tq) = _learners()
    for j, t in ((jbc, tbc), (jv, tv), (jq, tq)):
        for _ in range(2):
            ref = j.update(buf)
            assert abs(t.update(tbuf) - ref) <= 1e-5 * max(1.0, abs(ref))
    _assert_params(tbc.policy, convert.flax_mlp_to_state_dict(_np(jbc.params)))
    _assert_params(tv.net, convert.flax_mlp_to_state_dict(_np(jv.params)))
    _assert_params(tq.net, convert.flax_mlp_to_state_dict(_np(jq.params)))
    _assert_params(tq.target, convert.flax_mlp_to_state_dict(_np(jq.target_params)))

    jb = jrl.BPPO(jbc, jq, jv, lr=LR, batch_size=BATCH, seed=3)
    tb = trl.BPPO(tbc, tq, tv, lr=LR, batch_size=BATCH, seed=3)
    key = jax.random.PRNGKey(3)  # BPPO.update's key splits, replayed for the noise
    for _ in range(2):
        key, k = jax.random.split(key)
        noise = _t(jax.random.normal(k, (BATCH, A)))
        ref = jb.update(buf)
        assert abs(tb.update(tbuf, noise=noise) - ref) <= 1e-5 * max(1.0, abs(ref))
    assert tb.clip_ratio == pytest.approx(jb.clip_ratio)
    _assert_params(tb.policy, convert.flax_mlp_to_state_dict(_np(jb.params)))
    _assert_params(tb.old_policy, convert.flax_mlp_to_state_dict(_np(jb.old_params)))
    tb.replace_old()
    assert all(torch.equal(a, b) for a, b in zip(tb.policy.parameters(),
                                                 tb.old_policy.parameters()))
    s = _t(buf.state[:4])
    assert_close(tb.select_action(s), jbc.select_action(jb.params, jnp.asarray(buf.state[:4])),
                 1e-5)


def test_port_sac_updates_match_jax():
    buf, tbuf = _toy_buffers(seed=1)
    jsac = jrl.SAC(S, A, H, D, lr=LR, gamma=0.9, tau=0.05, batch_size=BATCH, seed=0)
    tsac = trl.SAC(S, A, H, D, lr=LR, gamma=0.9, tau=0.05, batch_size=BATCH, seed=0,
                   device="cpu")
    assert tsac.target_entropy == jsac.target_entropy == -float(A)
    pairs = ((tsac.policy, "pi_params"), (tsac.q1, "q1_params"), (tsac.q2, "q2_params"),
             (tsac.q1_target, "q1_target"), (tsac.q2_target, "q2_target"))
    for module, name in pairs:
        convert.load_flax_mlp(module, _np(getattr(jsac, name)))
    key = jax.random.PRNGKey(1)  # SAC.update's key splits, replayed for the noise
    for _ in range(2):
        key, k = jax.random.split(key)
        k1, k2 = jax.random.split(k)
        noise = (_t(jax.random.normal(k1, (BATCH, A))), _t(jax.random.normal(k2, (BATCH, A))))
        ql_ref, pl_ref = jsac.update(buf)
        ql, pl = tsac.update(tbuf, noise=noise)
        assert abs(ql - ql_ref) <= 1e-5 * max(1.0, abs(ql_ref))
        assert abs(pl - pl_ref) <= 1e-5 * max(1.0, abs(pl_ref))
    for module, name in pairs:
        _assert_params(module, convert.flax_mlp_to_state_dict(_np(getattr(jsac, name))))
    assert abs(tsac.log_alpha.item() - float(jsac.log_alpha)) <= 1e-6
    s = buf.state[:4]
    assert_close(tsac.select_action(_t(s)), jsac.select_action(jnp.asarray(s)), 1e-5)
