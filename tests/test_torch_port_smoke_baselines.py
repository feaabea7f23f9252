"""The port's smoke RL baselines app (``apps/train_baselines_smoke.py``)
against the JAX app on the CPU, then end to end at tiny widths.

- Behavior data: the port's ``behavior_data`` (heuristic episodes of the
  port's ``SmokeRLEnv``, 2 frames of 2 sub-steps) against the same
  episodes through the JAX app's own ``run_episode`` and
  ``behavior_action`` on the JAX env, from the same numpy generator: the
  actions equal, the states and rewards within 1e-5 * max(1, max |jax|)
  (batch 1, the env tolerance of test_torch_port_envs.py).
- BC closed loop: JAX's ``BehaviorCloning`` policy (a flat MLP, hidden 16)
  carried over by ``utils.convert`` and run by each app's ``run_episode``
  at batch 2, from densities that start at the target bucket: the J
  metrics within 1e-4 (batch 2: JAX's CPU CG stops on the batch max).
- The app for bc, bppo and sac at tiny widths (sac: the conv policy and
  twin conv critics), bc also from a generated dataset
  (``--behavior_from_dataset``, ``--eval_from_dataset``): the row's
  fields finite, appended to ``--save_file``.
"""

import json
import math

import apps.train_baselines_smoke as japp
import jax
import numpy as np
import pytest

from diffphycon_tpu.baselines import envs as jenvs
from diffphycon_tpu.baselines import rl as jrl
from diffphycon_tpu_torch.apps import generate_smoke
from diffphycon_tpu_torch.apps import train_baselines_smoke as tapp
from diffphycon_tpu_torch.baselines import envs as tenvs
from diffphycon_tpu_torch.baselines import rl as trl
from diffphycon_tpu_torch.utils import convert
from test_torch_port_envs import _bucket_start
from torch_port_helpers import assert_close

TINY = ["--frames", "2", "--sub_steps", "2", "--n_episodes", "2", "--n_test", "2",
        "--bc_steps", "2", "--critic_steps", "2", "--bppo_steps", "2", "--sac_steps", "4",
        "--sac_episodes_per_round", "1", "--batch_size", "4", "--hidden_dim", "16"]


@pytest.mark.parametrize("partially_observed", [False, True])
def test_port_smoke_behavior_data_matches_jax_app(partially_observed):
    args = tapp.build_parser().parse_args(
        TINY + ["--device", "cpu", "--partially_observed", str(partially_observed)])
    tenv = tenvs.SmokeRLEnv(frames=2, sub_steps=2, device="cpu")
    states, actions, rewards = tapp.behavior_data(args, tenv, np.random.default_rng(4))
    jenv = jenvs.SmokeRLEnv(frames=2, sub_steps=2)
    rng = np.random.default_rng(4)
    js, ja, jr = [], [], []
    for _ in range(2):  # the JAX app's loop (apps/train_baselines_smoke.py)
        trans, _ = japp.run_episode(jenv, lambda o: japp.behavior_action(jenv, rng, 0), 1,
                                    rng, partially_observed)
        js.append(np.stack([np.asarray(tr[0][0]) for tr in trans]
                           + [np.asarray(trans[-1][0][0])]))
        ja.append(np.stack([np.asarray(tr[1][0]) for tr in trans]))
        jr.append(np.stack([float(tr[2][0]) for tr in trans]))
    assert states.shape == (2, 3, 64, 64, 4) and actions.shape == (2, 2, 64, 64, 2)
    np.testing.assert_array_equal(actions, np.stack(ja))
    assert_close(states, np.stack(js), 1e-5)
    assert_close(rewards, np.stack(jr).astype(np.float32), 1e-5)
    if partially_observed:
        assert not states[..., 1:3].any()


def test_port_smoke_bc_closed_loop_matches_jax_app():
    jbc = jrl.BehaviorCloning(64 * 64 * 4, 64 * 64 * 2, hidden_dim=16, depth=2, seed=0)
    tbc = trl.BehaviorCloning(64 * 64 * 4, 64 * 64 * 2, hidden_dim=16, depth=2, device="cpu")
    convert.load_flax_mlp(tbc.policy, jax.tree_util.tree_map(np.asarray, jbc.params))
    jsel = jax.jit(lambda o: jbc.select_action(jbc.params, o.reshape(o.shape[0], -1))
                   .reshape(o.shape[0], 64, 64, 2))
    d0 = _bucket_start(2)
    jenv = jenvs.SmokeRLEnv(frames=2, sub_steps=2)
    tenv = tenvs.SmokeRLEnv(frames=2, sub_steps=2, device="cpu")
    _, mj = japp.run_episode(jenv, jsel, 2, np.random.default_rng(0), False, density0=d0)
    trans, mt = tapp.run_episode(
        tenv, lambda o: tbc.select_action(o.reshape(2, -1)).reshape(2, 64, 64, 2), 2,
        np.random.default_rng(0), False, density0=d0)
    assert len(trans) == 2 and mj["smoke_out"] > 0
    for k in mj:
        assert abs(mt[k] - mj[k]) <= 1e-4 * max(1.0, abs(mj[k])), (k, mt[k], mj[k])


@pytest.fixture(scope="module")
def smoke_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("smoke_rl")
    generate_smoke.main(generate_smoke.build_parser().parse_args(
        ["--device", "cpu", "--out", str(root), "--n_test", "2", "--n_train", "2", "--batch", "2",
         "--max_iterations", "20", "--filter_rate", "-1", "--min_sum_rate", "-1",
         "--max_sum_rate", "1e9"]))
    return root


@pytest.mark.parametrize("method,from_dataset", [("bc", False), ("bppo", False), ("sac", False),
                                                 ("bc", True)])
def test_port_train_baselines_smoke_app_tiny(method, from_dataset, tmp_path, smoke_data):
    save = tmp_path / "baselines.json"
    extra = (["--behavior_from_dataset", str(smoke_data), "--eval_from_dataset",
              str(smoke_data)] if from_dataset else [])
    row = tapp.main(tapp.build_parser().parse_args(
        TINY + extra + ["--cpu", "--method", method, "--save_file", str(save)]))
    losses = {"bc": ["bc_loss"], "bppo": ["bc_loss", "bppo_loss"],
              "sac": ["sac_q_loss", "sac_pi_loss"]}[method]
    assert set(row) == {"method", "partially_observed", "updates", "update_s", "J_target",
                        "smoke_out", "J_energy", "eval_walltime_s", *losses}
    assert all(math.isfinite(row[k]) for k in losses + ["J_target", "smoke_out", "J_energy"])
    assert row["updates"] == {"bc": 2, "bppo": 8, "sac": 4}[method]
    assert json.loads(save.read_text().splitlines()[-1]) == row
