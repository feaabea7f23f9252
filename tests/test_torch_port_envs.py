"""The port's RL environments (``baselines/envs.py``) against the JAX
package on the CPU, on the same fed-in actions.

- ``SmokeRLEnv``: the real 128^2 solver, 2 frames of 2 sub-steps, reset
  from the numpy generator's start boxes (the same draws) and from given
  densities that start at the target bucket's mouth (so the smoke-out
  rewards are not zero); obs, rewards and metrics within 1e-5 * max(1,
  max |jax|) at batch 1. At batch 2, 1e-4: JAX's CPU CG stops on the
  batch's largest residual while the port stops each element on its own
  (a deliberate difference, see ROADMAP.md), so the second element runs
  other iteration counts (accuracy 1e-6 on a ~1 field).
- ``JellyfishRLEnv`` on the tiny converted surrogates of
  test_torch_port_mpc.py (UNet2Dv2 / ForceUNet dim 8, 8x8 frames), full
  and partial observation: obs, rewards and metrics within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.baselines import envs as jenvs
from diffphycon_tpu_torch.baselines import envs as tenvs
from test_torch_port_mpc import surrogate_pipelines
from torch_port_helpers import assert_close

FRAMES, SUB = 2, 2


def _smoke_actions(b, seed):
    rng = np.random.default_rng(seed)
    a = np.zeros((FRAMES, b, 64, 64, 2), np.float32)
    a[..., 1] = 0.5
    return np.clip(a + 0.6 * rng.normal(size=a.shape), -1.5, 1.5).astype(np.float32)


def _bucket_start(b):
    """Smoke just below the target bucket (rows 112-126, columns 54-73),
    part of it already inside."""
    d0 = np.zeros((b, 128, 128), np.float32)
    for i in range(b):
        d0[i, 104 + 2 * i : 116 + 2 * i, 56 + 3 * i : 70 + 3 * i] = 1.0
    return d0


@pytest.mark.parametrize("batch,start,rtol", [(1, "rng", 1e-5), (1, "bucket", 1e-5),
                                              (2, "bucket", 1e-4)])
def test_port_smoke_env_matches_jax(batch, start, rtol):
    d0 = _bucket_start(batch) if start == "bucket" else None
    jenv = jenvs.SmokeRLEnv(frames=FRAMES, sub_steps=SUB, w_energy=0.01)
    tenv = tenvs.SmokeRLEnv(frames=FRAMES, sub_steps=SUB, w_energy=0.01, device="cpu")
    obs_j = jenv.reset(batch, np.random.default_rng(3), density0=d0)
    obs_t = tenv.reset(batch, np.random.default_rng(3), density0=d0)
    assert obs_t.shape == (batch, 64, 64, 4)
    assert_close(obs_t, np.asarray(obs_j), rtol)
    rewards = []
    for a in _smoke_actions(batch, seed=batch):
        obs_j, r_j, done_j = jenv.step(a)
        obs_t, r_t, done_t = tenv.step(a)
        assert done_t == done_j
        assert_close(obs_t, np.asarray(obs_j), rtol)
        assert_close(r_t, np.asarray(r_j), rtol)
        rewards.append(r_t)
    assert done_t
    mj, mt = jenv.metrics(), tenv.metrics()
    assert set(mt) == set(mj)
    for k in mj:
        assert abs(mt[k] - mj[k]) <= rtol * max(1.0, abs(mj[k])), (k, mt[k], mj[k])
    if start == "bucket":  # smoke reached the target bucket during the episode
        assert float(torch.stack(rewards).abs().max()) > 1e-3 and mt["smoke_out"] > 0


@pytest.mark.parametrize("partially_observed", [False, True])
def test_port_jellyfish_env_matches_jax(partially_observed):
    jppl, tppl, s0, b0, th0 = surrogate_pipelines()
    kw = dict(frames=3, act_scale=0.1, reg=10.0, partially_observed=partially_observed)
    jenv, tenv = jenvs.JellyfishRLEnv(jppl, **kw), tenvs.JellyfishRLEnv(tppl, device="cpu", **kw)
    obs_j, obs_t = jenv.reset(s0, b0, th0), tenv.reset(s0, b0, th0)
    assert obs_t.shape == (2, 8 * 8 * ((1 if partially_observed else 3) + 4))
    assert_close(obs_t, np.asarray(obs_j), 1e-5)
    actions = np.array([[[0.5], [-2.0]], [[-0.3], [0.8]], [[1.0], [0.1]]], np.float32)
    for a in actions:
        obs_j, r_j, done_j = jenv.step(jnp.asarray(a))
        obs_t, r_t, done_t = tenv.step(a)
        assert done_t == done_j
        assert_close(obs_t, np.asarray(obs_j), 1e-5)
        assert_close(r_t, np.asarray(r_j), 1e-5)
    assert done_t
    mj, mt = jenv.metrics(), tenv.metrics()
    for k in mj:
        assert abs(mt[k] - mj[k]) <= 1e-5 * max(1.0, abs(mj[k])), (k, mt[k], mj[k])
