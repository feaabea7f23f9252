"""``apps/train_smoke.py`` end to end on the CPU at a tiny size (port only):
fresh, resumed and the w model (dim 8, mults (1, 2), batch 2 of 2-frame
windows of generated 64x64 sims), finite logged losses, and
``apps/infer_smoke.py`` building its nets from the checkpoints it wrote
(the EMA weights, exactly)."""

import numpy as np
import pytest
import torch

from diffphycon_tpu_torch.apps import generate_smoke, infer_smoke, train_smoke
from diffphycon_tpu_torch.benchmarks import smoke as tbench
from diffphycon_tpu_torch.training.trainer import Trainer

import torch_port_helpers  # noqa: F401  (one intra-op thread per worker)


@pytest.fixture(scope="module")
def smoke_train_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("smoke_train")
    generate_smoke.main(generate_smoke.build_parser().parse_args([
        "--device", "cpu", "--out", str(root), "--n_test", "0", "--n_train", "2",
        "--batch", "2", "--max_iterations", "20", "--filter_rate", "-1",
        "--min_sum_rate", "-1", "--max_sum_rate", "1e9"]))
    return root


def test_port_train_smoke_main_fresh_resume_and_infer(smoke_train_data, tmp_path):
    common = ["--device", "cpu", "--dataset_path", str(smoke_train_data), "--dim", "8",
              "--dim_mults", "1", "2", "--frames", "2", "--batch_size", "2",
              "--checkpoint_interval", "2"]
    run = str(tmp_path / "smoke")
    tr = train_smoke.main(train_smoke.build_parser().parse_args(
        common + ["--train_num_steps", "2", "--results_folder", run]))
    assert tr.step == 2 and tr.model.remat_all
    tr2 = train_smoke.main(train_smoke.build_parser().parse_args(
        common + ["--train_num_steps", "3", "--results_folder", run, "--resume", "True"]))
    assert tr2.step == 3
    assert Trainer.latest_milestone(run) == 3
    tw = train_smoke.main(train_smoke.build_parser().parse_args(
        common + ["--train_num_steps", "2", "--is_w_model", "True",
                  "--results_folder", str(tmp_path / "smoke_w"), "--remat_all", "False"]))
    assert tw.model.channels == 2 and not tw.model.remat_all
    log = (tmp_path / "smoke" / "train_log.jsonl").read_text().splitlines()
    assert log and all(np.isfinite(float(line.split('"loss": ')[1].split(",")[0]))
                       for line in log)
    # infer_smoke builds its nets from these checkpoints (EMA weights)
    cfg = tbench.SmokeConfig(dim=8, dim_mults=(1, 2))
    net = infer_smoke._load_net(tbench, cfg, None, None, "cpu", run, 3, True)
    ema = Trainer.load_params(run, 3, use_ema=True)
    assert all(torch.equal(v, ema[k]) for k, v in net.state_dict().items())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        infer_smoke._load_net(tbench, cfg, None, None, "cpu", run, 7, True)
