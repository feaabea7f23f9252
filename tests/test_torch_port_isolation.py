"""The port stands alone: it imports no JAX, flax or diffphycon_tpu module
(and no matplotlib at import: ``utils/viz.py`` imports it at its first
plot, and the GPU machine lacks it), and its entry points run on CUDA
unless told otherwise."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import diffphycon_tpu_torch
from diffphycon_tpu_torch import resolve_device
from diffphycon_tpu_torch.apps import (
    eval_pid_sl_burgers,
    infer_jellyfish,
    train_baselines_burgers,
    train_baselines_jellyfish,
    train_baselines_smoke,
    train_burgers_operator,
    train_sac_burgers,
)
from diffphycon_tpu_torch.baselines import envs, rl
from diffphycon_tpu_torch.benchmarks import burgers as bench
from diffphycon_tpu_torch.benchmarks import jellyfish as jelly_bench
from diffphycon_tpu_torch.benchmarks import smoke as smoke_bench
from diffphycon_tpu_torch.control.geometry import compute_pressforce_from_mask
from diffphycon_tpu_torch.diffusion import (
    DiffusionConstants,
    GaussianDiffusion,
    make_guidance_schedule,
)
from diffphycon_tpu_torch.nets.burgers_operator import SurrogateOperator
from diffphycon_tpu_torch.parallel import make_mesh
from diffphycon_tpu_torch.physics.fluids.smoke_env import SmokeSim
from diffphycon_tpu_torch.training.surrogates import load_surrogate
from diffphycon_tpu_torch.training.trainer import Trainer, TrainerConfig

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax_or_reference_package():
    names = sorted(m.name for m in pkgutil.walk_packages(
        diffphycon_tpu_torch.__path__, "diffphycon_tpu_torch."))
    assert "diffphycon_tpu_torch.kernels.unet2d_blocks" in names
    assert "diffphycon_tpu_torch.apps.infer_burgers" in names
    for new in ("kernels.cg_pressure", "physics.fluids.pressure", "physics.fluids.smoke_env",
                "nets.unet3d", "benchmarks.smoke", "apps.generate_smoke", "apps.infer_smoke",
                "kernels.attention", "training.train_state", "training.trainer",
                "apps.train_burgers", "kernels.unet2d_mega", "apps.train_smoke",
                "nets.unet2dv2", "training.surrogates", "benchmarks.jellyfish",
                "control.geometry", "apps.generate_jellyfish_forces",
                "apps.train_surrogates_jellyfish", "apps.train_jellyfish",
                "apps.infer_jellyfish", "baselines.rl", "baselines.sl_burgers",
                "baselines.pid_burgers", "baselines.mpc_jellyfish", "nets.burgers_operator",
                "apps.train_burgers_operator", "apps.eval_pid_sl_burgers",
                "apps.train_baselines_burgers", "apps.train_sac_burgers", "baselines.envs",
                "baselines.lbfgs", "apps.train_baselines_smoke",
                "apps.train_baselines_jellyfish", "parallel.mesh", "parallel.dryrun",
                "physics.ks", "utils.fluidformat", "utils.native_io", "utils.profiling",
                "utils.viz"):
        assert f"diffphycon_tpu_torch.{new}" in names
    code = (
        "import importlib, sys\n"
        f"for name in {['diffphycon_tpu_torch'] + names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'diffphycon_tpu', 'triton', 'matplotlib'))\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"port imported: {out.stdout.strip()}"


def test_port_cuda_request_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jelly_cfg = jelly_bench.JellyfishConfig(dim=8, dim_mults=(1,), image_size=8)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(dev)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.init_params(bench.BurgersConfig(dim=8, dim_mults=(1,)))
    # the diffusion entry points and the smoke builders default to CUDA too
    for make in (lambda: DiffusionConstants.create(10, "linear"),
                 lambda: make_guidance_schedule(None, 10),
                 lambda: make_guidance_schedule("cosine", 10),
                 lambda: GaussianDiffusion(lambda x, t: x, sample_shape=(4,), timesteps=10),
                 lambda: SmokeSim.create(),
                 lambda: smoke_bench.build_guidance(smoke_bench.SmokeConfig()),
                 lambda: Trainer(None, torch.nn.Linear(2, 2), iter(()), None,
                                 TrainerConfig(results_folder=str(tmp_path / "run"))),
                 # the jellyfish build_* functions, diffusion, surrogate loader, labels
                 lambda: jelly_bench.build_joint_unet(jelly_cfg),
                 lambda: jelly_bench.build_thetas_unet(jelly_cfg),
                 lambda: jelly_bench.build_bd_updater(jelly_cfg),
                 lambda: jelly_bench.build_force_unet(jelly_cfg),
                 lambda: jelly_bench.build_simulator_unet(jelly_cfg),
                 lambda: jelly_bench.JellyfishDiffusion(jelly_cfg, None),
                 lambda: load_surrogate(str(tmp_path), "force", torch.nn.Linear(2, 2)),
                 lambda: compute_pressforce_from_mask(np.zeros((64, 64)),
                                                      np.zeros((62, 62, 3))),
                 # the baselines: the latent operator, a learner, the MPC entry
                 lambda: SurrogateOperator(),
                 lambda: rl.BehaviorCloning(4, 4, hidden_dim=8),
                 lambda: rl.SAC(4, 4, hidden_dim=8),
                 lambda: infer_jellyfish.main(infer_jellyfish.build_parser().parse_args(
                     ["--inference_method", "MPC", "--dataset_path", str(tmp_path)])),
                 # the RL environments
                 lambda: envs.SmokeRLEnv(),
                 # data parallelism: the default mesh is a CUDA one
                 lambda: make_mesh(),
                 lambda: envs.JellyfishRLEnv(None),
                 *(lambda app=app: app.main(app.build_parser().parse_args([]))
                   for app in (train_burgers_operator, eval_pid_sl_burgers,
                               train_baselines_burgers, train_sac_burgers,
                               train_baselines_smoke, train_baselines_jellyfish))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")
