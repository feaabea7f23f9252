"""The port's evaluation against the JAX package: ``evaluate_samples``
(ddpm_mse, J_actual, J_diffused, control energy) on the same samples, and
the port's ``apps/infer_burgers.py`` end to end at a tiny size, with
seeded weights and then through ``--checkpoint_sweep``.

Tolerance for the metrics: 1e-4 * max(1, max |jax|); the solver runs 10^4
float32 steps on both sides and differs only in rounding (see
test_torch_port_solver.py).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.benchmarks import burgers as jbench
from diffphycon_tpu.physics.burgers import burgers_solve as jax_solve
from diffphycon_tpu_torch.apps import infer_burgers
from diffphycon_tpu_torch.benchmarks import burgers as tbench
from diffphycon_tpu_torch.physics.burgers import make_burgers_data
from torch_port_helpers import assert_close, rand


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("observed", [dict(), dict(partially_observed="front_rear_quarter",
                                                  partial_control="front_rear_quarter")])
def test_port_evaluate_samples_metrics(observed):
    u0, f = make_burgers_data(2, seed=9)
    u_target = np.asarray(jax_solve(u0, f))
    x = np.clip(0.4 * rand(2, 16, 128, 2, seed=6), -1, 1)
    ref = jbench.evaluate_samples(jnp.asarray(x), jnp.asarray(u_target),
                                  jbench.BurgersConfig(**observed))
    out = tbench.evaluate_samples(_t(x), _t(u_target), tbench.BurgersConfig(**observed))
    assert_close(out.ddpm_mse, ref.ddpm_mse, 1e-4)
    assert_close(out.control_energy, ref.control_energy, 1e-4)
    for a, b in zip(out.j_actual + out.j_diffused, ref.j_actual + ref.j_diffused):
        assert_close(a, b, 1e-4)


def test_port_app_main_tiny(tmp_path):
    save = tmp_path / "result.json"
    argv = ["--init_seed", "0", "--device", "cpu", "--synthetic_data", "2",
            "--n_test_samples", "2", "--batch_size", "2", "--eval_two_models", "True",
            "--wus", "1000", "--is_condition_u0", "True", "--is_condition_uT", "True",
            "--using_ddim", "True", "--ddim_sampling_steps", "3", "--dim", "8",
            "--dim_mults", "1", "2", "--data_root", str(tmp_path), "--save_file", str(save)]
    results = infer_burgers.main(infer_burgers.build_parser().parse_args(argv))
    entry = results["wu=1000.0,wf=0.0"]
    assert set(entry) == {"J_actual_mse", "J_actual_mae", "J_actual_nmse",
                          "J_actual_nmae", "control_energy", "ddpm_mse",
                          "walltime_s", "n"}
    assert all(np.isfinite(v) for v in entry.values()) and entry["n"] == 2
    assert json.loads(save.read_text()) == results
    # --checkpoint_sweep over a checkpoint holding the same seeded weights
    # (as Trainer.save lays it out; argv[2:] drops --init_seed 0) gives the
    # same row under a ckpt= key
    for sub, seed in (("burgers", 0), ("burgers_w", 1)):
        sd = tbench.init_params(tbench.BurgersConfig(dim=8, dim_mults=(1, 2)), seed=seed,
                                device="cpu").state_dict()
        ckpt = tmp_path / "models" / sub / "tiny" / "ckpt" / "7"
        ckpt.mkdir(parents=True)
        torch.save({"step": 7, "params": sd, "ema_params": sd}, ckpt / "checkpoint.pt")
    swept = infer_burgers.main(infer_burgers.build_parser().parse_args(
        argv[2:] + ["--checkpoint_sweep", "7", "--model_root", str(tmp_path / "models"),
                      "--exp_id", "tiny"]))
    assert list(swept) == ["ckpt=7,wu=1000.0,wf=0.0"] and json.loads(save.read_text()) == swept
    row = dict(swept["ckpt=7,wu=1000.0,wf=0.0"])
    assert row.pop("walltime_s") >= 0 and entry.pop("walltime_s") >= 0
    assert row == entry


def test_port_burgers_config_dim_muls_alias():
    import dataclasses

    cfg = tbench.BurgersConfig(dim=8, dim_muls=(1, 2))
    assert cfg.dim_mults == (1, 2) and cfg.dim_muls is None
    assert dataclasses.replace(cfg, dim_mults=(1, 2, 4)).dim_mults == (1, 2, 4)
    assert tbench.BurgersConfig(dim_mults=(1, 2, 4), dim_muls=(1, 4)).dim_mults == (1, 4)
    with pytest.raises(NotImplementedError, match="bf16"):
        tbench.build_unet(tbench.BurgersConfig(bf16=True), "cpu")
