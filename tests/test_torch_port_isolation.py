"""The port stands alone: it imports no JAX, flax or diffphycon_tpu module,
and its entry points run on CUDA unless told otherwise."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import diffphycon_tpu_torch
from diffphycon_tpu_torch import resolve_device
from diffphycon_tpu_torch.benchmarks import burgers as bench
from diffphycon_tpu_torch.benchmarks import smoke as smoke_bench
from diffphycon_tpu_torch.diffusion import (
    DiffusionConstants,
    GaussianDiffusion,
    make_guidance_schedule,
)
from diffphycon_tpu_torch.physics.fluids.smoke_env import SmokeSim
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
                "apps.train_burgers"):
        assert f"diffphycon_tpu_torch.{new}" in names
    code = (
        "import importlib, sys\n"
        f"for name in {['diffphycon_tpu_torch'] + names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'diffphycon_tpu', 'triton'))\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"port imported: {out.stdout.strip()}"


def test_port_cuda_request_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
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
                                 TrainerConfig(results_folder=str(tmp_path / "run")))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")
