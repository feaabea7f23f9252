"""The port's smoke apps end to end on the CPU at a tiny size (port only):
``generate_smoke`` writes test sims in the reference layout, the smoke
loaders read them back, and ``infer_smoke`` samples with two seeded UNet3Ds,
re-simulates and reports finite metrics.

The rollouts are kept cheap with the apps' own flags: the generator caps
every CG solve at 20 iterations and accepts every scene (``--filter_rate
-1`` and open sum-rate bounds); the evaluator solves to accuracy 0.1."""

import json

import numpy as np
import pytest

from diffphycon_tpu_torch.apps import generate_smoke, infer_smoke
from diffphycon_tpu_torch.training.data import load_smoke_dataset, load_smoke_sim

import torch_port_helpers  # noqa: F401  (one intra-op thread per worker)


@pytest.fixture(scope="module")
def smoke_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("smoke")
    args = generate_smoke.build_parser().parse_args([
        "--device", "cpu", "--out", str(root), "--n_test", "2", "--n_train", "0",
        "--batch", "2", "--max_iterations", "20", "--filter_rate", "-1",
        "--min_sum_rate", "-1", "--max_sum_rate", "1e9"])
    return root, generate_smoke.main(args)


def test_port_generate_smoke_writes_reference_layout(smoke_data):
    root, stats = smoke_data
    assert stats["attempted"] == 2 and stats["accepted"] == 2
    sim = root / "test" / "control" / "sim_000001"
    shapes = {f: np.load(sim / f"{f}.npy").shape for f in
              ("Density", "Velocity", "Control", "Smoke")}
    assert shapes == {"Density": (64, 64, 1, 33), "Velocity": (64, 64, 2, 33),
                      "Control": (64, 64, 2, 33), "Smoke": (33, 8)}
    ctrl = np.load(sim / "Control.npy")
    assert np.abs(ctrl[8:56, 8:56]).max() == 0.0  # indirect control: ring only
    assert np.abs(ctrl[..., -1]).max() == 0.0     # the 33rd frame is zeros
    assert json.loads((root / "gen_stats.json").read_text())["accepted"] == 2
    state = load_smoke_sim(str(sim))
    assert state.shape == (33, 64, 64, 6) and np.isfinite(state).all()


def test_port_load_smoke_dataset_skips_incomplete_sims(smoke_data, tmp_path):
    root, _ = smoke_data
    data = load_smoke_dataset(str(root), "test")
    assert data.shape == (2, 33, 64, 64, 6)
    # a copy whose second sim has a truncated array is read as one sim
    import shutil

    copy = tmp_path / "copy"
    shutil.copytree(root, copy)
    smoke = copy / "test" / "control" / "sim_000001" / "Smoke.npy"
    smoke.write_bytes(smoke.read_bytes()[:-40])
    assert load_smoke_dataset(str(copy), "test").shape == (1, 33, 64, 64, 6)


def test_port_infer_smoke_main_tiny(smoke_data, tmp_path):
    root, _ = smoke_data
    args = infer_smoke.build_parser().parse_args([
        "--device", "cpu", "--dataset_path", str(root), "--init_seed", "0",
        "--dim", "8", "--dim_mults", "1", "2", "--ddim_sampling_steps", "2",
        "--n_test_samples", "1", "--batch_size", "1", "--solver_accuracy", "0.1",
        "--inference_result_path", str(tmp_path)])
    agg = infer_smoke.main(args)
    for k in ("J_total", "J_target", "J_energy", "mse", "n_l2", "n_l2_density",
              "n_l2_v1", "n_l2_v2", "mae_smoke", "J_target_zero_control",
              "J_target_dataset_control"):
        assert np.isfinite(agg[k]), k
    assert agg["n"] == 1
    saved = json.loads((tmp_path / "results.json").read_text().splitlines()[-1])
    assert saved["metrics"] == agg
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        infer_smoke.main(infer_smoke.build_parser().parse_args(
            ["--device", "cpu", "--dataset_path", str(root)]))
