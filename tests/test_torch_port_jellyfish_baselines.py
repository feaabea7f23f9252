"""The port's jellyfish RL baselines app (``apps/train_baselines_jellyfish.py``)
against the JAX package on the CPU, then end to end at tiny widths.

The surrogates are seeded flax trees of UNet2Dv2 / ForceUNet at dim 8,
mults (1, 2) (the benchmark's build functions fix the published widths, so they
are replaced for this module), saved as the port's surrogate files and
converted by ``utils.convert`` for the port; the data are
``synthetic_jellyfish`` sims (64x64, 2 train, 2 test).

- Offline buffer: the port's ``offline_buffer`` (the dataset's theta steps
  replayed through the port's ``JellyfishRLEnv``) against the JAX app's
  loop on the JAX env with the same weights, 4 frames: actions equal,
  observations and rewards within 1e-5 * max(1, max |jax|) (three small
  nets a step; float32 sums in another order). The nets take one
  GroupNorm group: the boundary fields are 97% exact zeros, so at dim 8
  with the default 8 groups each group is one nearly constant channel
  whose tiny variance amplifies rounding (the bd-updater step then differs
  by 6e-5 relative, 4e-6 with one group of 8 channels; the published
  widths have 8 channels per group too). Partial observation is held in
  test_torch_port_envs.py.
- BC closed loop: JAX's ``BehaviorCloning`` (hidden 16) carried over and
  run on the test split in both envs: the metrics within 1e-5.
- The app for bc, bppo and sac: the row's fields finite, appended to
  ``--save_file``.
"""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.baselines import envs as jenvs
from diffphycon_tpu.baselines import rl as jrl
from diffphycon_tpu.benchmarks import jellyfish as jbench
from diffphycon_tpu.nets.unet2dv2 import ForceUNet as JaxForceUNet
from diffphycon_tpu.nets.unet2dv2 import UNet2Dv2 as JaxUNet2Dv2
from diffphycon_tpu_torch.apps import train_baselines_jellyfish as tapp
from diffphycon_tpu_torch.baselines import rl as trl
from diffphycon_tpu_torch.benchmarks import jellyfish as tbench
from diffphycon_tpu_torch.nets.unet2dv2 import ForceUNet, UNet2Dv2
from diffphycon_tpu_torch.training.data import load_jellyfish_dataset, synthetic_jellyfish
from diffphycon_tpu_torch.training.surrogates import PARAMS_FILE
from diffphycon_tpu_torch.utils import convert
from torch_port_helpers import assert_close, flax_tree

SMALL = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=1)
FRAMES = 4
# name -> (flax module, its init inputs, the port's module, converter)
NETS = {
    "simulator": (JaxUNet2Dv2(channels=6, out_dim=3, **SMALL),
                  (jnp.zeros((1, 64, 64, 6)), jnp.zeros((1,))),
                  lambda: UNet2Dv2(channels=6, out_dim=3, **SMALL), convert.load_flax_unet2dv2),
    "force": (JaxForceUNet(channels=4, **SMALL), (jnp.zeros((1, 64, 64, 4)),),
              lambda: ForceUNet(channels=4, **SMALL), convert.load_flax_force_unet),
    "boundary_updater": (JaxUNet2Dv2(channels=3, out_dim=3, **SMALL),
                         (jnp.zeros((1, 64, 64, 3)), jnp.zeros((1,))),
                         lambda: UNet2Dv2(channels=3, out_dim=3, **SMALL),
                         convert.load_flax_unet2dv2),
}


def _small(make):
    def build(cfg, seed=None, device=None):
        return tbench._place(make(), seed, device)
    return build


@pytest.fixture(scope="module", autouse=True)
def small_surrogates():
    """The app builds its surrogates through these small build functions."""
    with pytest.MonkeyPatch.context() as mp:
        for name, attr in (("simulator", "build_simulator_unet"), ("force", "build_force_unet"),
                           ("boundary_updater", "build_bd_updater")):
            mp.setattr(tbench, attr, _small(NETS[name][2]))
        yield


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(dataset root, surrogate folder, the JAX env on a pipeline with the
    same weights; one env, so that JAX compiles its step once per batch)."""
    root = tmp_path_factory.mktemp("jelly_rl")
    synthetic_jellyfish(2, str(root / "train_data"), seed=0)
    synthetic_jellyfish(2, str(root / "test_data"), seed=1)
    params = {}
    for i, (name, (jnet, inputs, make, load)) in enumerate(NETS.items()):
        params[name] = flax_tree(jnet, *inputs, seed=i + 1)
        (root / "sur" / name).mkdir(parents=True)
        torch.save(load(make(), params[name]).state_dict(), root / "sur" / name / PARAMS_FILE)
    norm = load_jellyfish_dataset(str(root), "train", n=1)["norm"]
    jppl = jbench.SurrogatePipeline(
        jbench.JellyfishConfig(), NETS["simulator"][0].apply, params["simulator"],
        NETS["force"][0].apply, params["force"], NETS["boundary_updater"][0].apply,
        params["boundary_updater"], p_min=float(norm["p_min"]), p_max=float(norm["p_max"]))
    args = _args(root, root / "sur")
    return root, root / "sur", jenvs.JellyfishRLEnv(jppl, frames=FRAMES, act_scale=args.act_scale,
                                                    reg=args.reg_ratio)


def _args(root, sur, *extra):
    return tapp.build_parser().parse_args(
        ["--dataset_path", str(root), "--surrogate_folder", str(sur), "--device", "cpu",
         "--frames", str(FRAMES), "--n_test", "2", "--bc_steps", "2", "--critic_steps", "2",
         "--bppo_steps", "2", "--sac_steps", "4", "--sac_episodes_per_round", "1",
         "--batch_size", "4", "--hidden_dim", "16", "--reg_ratio", "10"] + list(extra))


def test_port_jellyfish_offline_buffer_matches_jax_env(setup):
    root, sur, jenv = setup
    args = _args(root, sur)
    tenv, _ = tapp.build_env(args, torch.device("cpu"))
    d = load_jellyfish_dataset(str(root), "train")
    obs, act, rew = tapp.offline_buffer(args, tenv, d["states"], d["bd"], d["thetas"], 2)
    jo, ja, jr = [], [], []
    for i in range(2):  # the JAX app's loop (apps/train_baselines_jellyfish.py)
        o = jenv.reset(d["states"][i, :1], d["bd"][i, :1], d["thetas"][i, :1])
        o_list, a_list, r_list = [o], [], []
        for t in range(FRAMES - 1):
            dt = float(d["thetas"][i, t + 1] - d["thetas"][i, t])
            a = np.asarray([[np.clip(dt / args.act_scale, -1, 1)]], np.float32)
            o, r, _ = jenv.step(a)
            o_list.append(o)
            a_list.append(a)
            r_list.append(np.asarray(r))
        jo.append(np.concatenate(o_list))
        ja.append(np.concatenate(a_list))
        jr.append(np.concatenate(r_list))
    assert obs.shape == (2, FRAMES, 64 * 64 * 7)
    np.testing.assert_array_equal(act, np.stack(ja))
    assert_close(obs, np.stack(jo), 1e-5)
    assert_close(rew, np.stack(jr), 1e-5)


def test_port_jellyfish_bc_closed_loop_matches_jax_env(setup):
    root, sur, jenv = setup
    tenv, _ = tapp.build_env(_args(root, sur), torch.device("cpu"))
    obs_dim = 64 * 64 * 7
    jbc = jrl.BehaviorCloning(obs_dim, 1, hidden_dim=16, depth=2, seed=0)
    tbc = trl.BehaviorCloning(obs_dim, 1, hidden_dim=16, depth=2, device="cpu")
    convert.load_flax_mlp(tbc.policy, jax.tree_util.tree_map(np.asarray, jbc.params))
    test = load_jellyfish_dataset(str(root), "test", n=2)
    start = (test["states"][:, 0], test["bd"][:, 0], test["thetas"][:, 0])
    jsel = jax.jit(lambda o: jbc.select_action(jbc.params, o))
    for env, select in ((jenv, lambda o: np.asarray(jsel(o))), (tenv, tbc.select_action)):
        obs, done = env.reset(*start), False
        while not done:
            obs, _, done = env.step(select(obs))
    mj, mt = jenv.metrics(), tenv.metrics()
    assert mt["theta_reg"] > 0
    for k in mj:
        assert abs(mt[k] - mj[k]) <= 1e-5 * max(1.0, abs(mj[k])), (k, mt[k], mj[k])


@pytest.mark.parametrize("method", ["bc", "bppo", "sac"])
def test_port_train_baselines_jellyfish_app_tiny(setup, method, tmp_path):
    root, sur, _ = setup
    save = tmp_path / "baselines.json"
    row = tapp.main(_args(root, sur, "--method", method, "--save_file", str(save)))
    losses = {"bc": ["bc_loss"], "bppo": ["bc_loss", "bppo_loss"],
              "sac": ["sac_q_loss", "sac_pi_loss"]}[method]
    assert set(row) == {"method", "partially_observed", "updates", "update_s", "avg_force",
                        "theta_reg", "J_jellyfish", "objective_convention", *losses}
    assert all(math.isfinite(row[k]) for k in losses + ["avg_force", "theta_reg", "J_jellyfish"])
    assert row["updates"] == {"bc": 2, "bppo": 8, "sac": 4}[method]
    assert json.loads(Path(save).read_text().splitlines()[-1]) == row
