"""The port's jellyfish apps end to end on the CPU at a tiny size (port
only): ``synthetic_jellyfish`` train and test splits,
``generate_jellyfish_forces``, ``train_surrogates_jellyfish`` for the three
surrogates (shrunk to dim 8, mults (1, 2), by replacing the benchmark's
builders, which fix the published widths), ``train_jellyfish`` for the states (EBM,
with gradient accumulation over the (states, bd, thetas) tuple) and thetas
models (UNet3D dim 8, mults (1, 2), 4-frame windows), then
``infer_jellyfish`` (guided DDIM, 2 steps) with its closed-loop scoring,
``results.json``, ``pred_thetas_seed*.npy`` and ``--rescore_thetas``, then
``--inference_method MPC`` (receding-horizon MPC through the surrogates);
MPC_LBFGS raises and names its ROADMAP entry."""

import json

import numpy as np
import pytest

from diffphycon_tpu_torch.apps import (
    generate_jellyfish_forces,
    infer_jellyfish,
    train_jellyfish,
    train_surrogates_jellyfish,
)
from diffphycon_tpu_torch.benchmarks import jellyfish as tbench
from diffphycon_tpu_torch.nets.unet2dv2 import ForceUNet, UNet2Dv2
from diffphycon_tpu_torch.training.data import synthetic_jellyfish

import torch_port_helpers  # noqa: F401  (one intra-op thread per worker)

NET = ["--dim", "8", "--dim_mults", "1", "2", "--frames", "4"]
SMALL = dict(dim=8, dim_mults=(1, 2))


def _small(make):
    def build(cfg, seed=None, device=None):
        return tbench._place(make(cfg), seed, device)
    return build


@pytest.fixture(scope="module", autouse=True)
def small_surrogates():
    """The apps build their surrogates through these small builders."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbench, "build_bd_updater",
                   _small(lambda cfg: UNet2Dv2(out_dim=3, channels=3, **SMALL)))
        mp.setattr(tbench, "build_force_unet",
                   _small(lambda cfg: ForceUNet(out_dim=1, channels=4, **SMALL)))
        mp.setattr(tbench, "build_simulator_unet", _small(
            lambda cfg: UNet2Dv2(out_dim=cfg.n_state, channels=cfg.n_state + 3, **SMALL)))
        yield


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("jellyfish")
    synthetic_jellyfish(2, str(root / "train_data"), seed=0)
    synthetic_jellyfish(2, str(root / "test_data"), seed=1)
    written = generate_jellyfish_forces.main(generate_jellyfish_forces.build_parser().parse_args(
        ["--dataset_path", str(root), "--device", "cpu"]))
    losses = {}
    for model in ("force", "simulator", "boundary_updater"):
        _, losses[model] = train_surrogates_jellyfish.main(
            train_surrogates_jellyfish.build_parser().parse_args(
                ["--dataset_path", str(root), "--model", model, "--num_steps", "2",
                 "--batch_size", "2", "--log_every", "1", "--device", "cpu",
                 "--results_folder", str(root / "sur")]))
    steps = {}
    for model_type, sub in (("states", "jelly"), ("thetas", "jelly_w")):
        tr = train_jellyfish.main(train_jellyfish.build_parser().parse_args(
            ["--dataset_path", str(root), "--model_type", model_type, "--train_num_steps", "1",
             "--checkpoint_interval", "1", "--batch_size", "2", "--grad_accum", "2",
             "--device", "cpu", "--results_folder", str(root / sub)] + NET))
        steps[model_type] = tr.step
    return root, written, losses, steps


def _infer_args(root, *extra):
    return infer_jellyfish.build_parser().parse_args(
        ["--dataset_path", str(root), "--n_test_samples", "2", "--batch_size", "2",
         "--joint_folder", str(root / "jelly"), "--w_folder", str(root / "jelly_w"),
         "--surrogate_folder", str(root / "sur"), "--sampling_timesteps", "2",
         "--inference_result_path", str(root / "res"), "--device", "cpu", "--reg_ratio", "0.1"]
        + NET + list(extra))


def test_port_jellyfish_training_apps(trained):
    root, written, losses, steps = trained
    assert written == {"train_data": 2, "test_data": 2}
    forces = np.load(root / "train_data" / "forces" / "sim_000000.npy")
    assert forces.shape[0] == 40 and forces.shape[2] == 2 and np.isfinite(forces).all()
    assert all(np.isfinite(v) for v in losses.values()), losses
    for model in losses:
        assert (root / "sur" / model / "params.pt").is_file()
    assert steps == {"states": 1, "thetas": 1}
    for sub in ("jelly", "jelly_w"):
        log = [json.loads(line) for line in (root / sub / "train_log.jsonl").read_text()
               .splitlines()]
        assert log and all(np.isfinite(r["loss"]) for r in log)


def test_port_infer_jellyfish_main_tiny(trained):
    root = trained[0]
    agg = infer_jellyfish.main(_infer_args(root))
    for k in ("objective", "objective_closed_loop", "theta_mae_vs_gt"):
        assert np.isfinite(agg[k]), k
    assert agg["n"] == 2
    pred = np.load(root / "res" / "pred_thetas_seed0.npy")
    assert pred.shape == (2, 4) and np.isfinite(pred).all()
    saved = json.loads((root / "res" / "results.json").read_text().splitlines()[-1])
    assert saved["metrics"] == agg
    # rescoring the saved schedules gives the same closed-loop objective
    again = infer_jellyfish.main(_infer_args(
        root, "--rescore_thetas", str(root / "res" / "pred_thetas_seed0.npy")))
    assert again["objective"] is None
    assert again["objective_closed_loop"] == pytest.approx(agg["objective_closed_loop"],
                                                           rel=1e-6)
    # receding-horizon MPC through the surrogate pipeline (2 iterations per
    # replan over the 4 frames): the JAX app's results.json row
    mpc = infer_jellyfish.main(_infer_args(root, "--inference_method", "MPC",
                                           "--num_iters", "2", "--lamda", "1.0"))
    assert mpc["method"] == "MPC" and mpc["n"] == 2 and np.isfinite(mpc["objective"])
    saved = json.loads((root / "res" / "results.json").read_text().splitlines()[-1])
    assert saved["metrics"] == mpc and set(mpc) == {"method", "objective", "walltime_s", "n"}
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, MPC_LBFGS"):
        infer_jellyfish.main(_infer_args(root, "--inference_method", "MPC_LBFGS"))
