"""``infer_burgers --checkpoint_sweep`` on the CPU: two checkpoints of the
joint and the prior UNet2D written by the port's ``train_burgers`` (dim 8,
steps 1 and 2; their raw weights, since the EMA has not started by step
2), swept in one run with two models. Each ``ckpt={k}`` row
must equal, field for field except ``walltime_s``, the row of a
``--checkpoint k --checkpoint__model_w k`` run of the same seed: the same
weights and the same draws give the same samples, so equality is exact.
"""

import json

import pytest

from diffphycon_tpu_torch.apps import infer_burgers, train_burgers

import torch_port_helpers  # noqa: F401  (one intra-op thread per worker)

NET = ["--dim", "8", "--dim_mults", "1", "2", "--is_condition_u0", "True",
       "--is_condition_uT", "True", "--device", "cpu"]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep")
    for sub, extra in (("burgers", []), ("burgers_w", ["--is_model_w", "True"])):
        train_burgers.main(train_burgers.build_parser().parse_args(
            NET + extra + ["--synthetic_data", "8", "--train_num_steps", "2",
                           "--checkpoint_interval", "1", "--batch_size", "4",
                           "--data_root", str(root / "data"), "--exp_id", "tiny",
                           "--results_folder", str(root / "models" / sub / "tiny")]))
    return root


def _infer(root, save, *extra):
    return infer_burgers.main(infer_burgers.build_parser().parse_args(
        NET + ["--model_root", str(root / "models"), "--exp_id", "tiny", "--synthetic_data", "2",
               "--n_test_samples", "2", "--batch_size", "2", "--eval_two_models", "True",
               "--wus", "1000", "--using_ddim", "True", "--ddim_sampling_steps", "3",
               "--use_ema", "False",
               "--data_root", str(root / "data"), "--save_file", str(save)] + list(extra)))


def test_port_checkpoint_sweep_rows_equal_single_checkpoint_runs(models, tmp_path):
    save = tmp_path / "sweep.json"
    rows = _infer(models, save, "--checkpoint_sweep", "1", "2")
    assert list(rows) == ["ckpt=1,wu=1000.0,wf=0.0", "ckpt=2,wu=1000.0,wf=0.0"]
    assert json.loads(save.read_text()) == rows
    for k in (1, 2):
        single = _infer(models, tmp_path / f"single{k}.json", "--checkpoint", str(k),
                        "--checkpoint__model_w", str(k))["wu=1000.0,wf=0.0"]
        swept = dict(rows[f"ckpt={k},wu=1000.0,wf=0.0"])
        swept.pop("walltime_s"), single.pop("walltime_s")
        assert swept == single, (k, swept, single)
    assert rows["ckpt=1,wu=1000.0,wf=0.0"]["J_actual_mse"] != rows[
        "ckpt=2,wu=1000.0,wf=0.0"]["J_actual_mse"]
    with pytest.raises(ValueError, match="checkpoint_sweep"):
        _infer(models, save, "--checkpoint_sweep", "1", "--init_seed", "0")


def _bf16_sweep(models, tmp_path, impl):
    mode = ("--bf16", "True", "--impl", impl)
    rows = _infer(models, tmp_path / "sweep16.json", "--checkpoint_sweep", "1", "2", *mode)
    single = _infer(models, tmp_path / "single16.json", "--checkpoint", "2",
                    "--checkpoint__model_w", "2", *mode)["wu=1000.0,wf=0.0"]
    fp32 = _infer(models, tmp_path / "single32.json", "--checkpoint", "2",
                  "--checkpoint__model_w", "2")["wu=1000.0,wf=0.0"]
    swept = dict(rows["ckpt=2,wu=1000.0,wf=0.0"])
    for r in (swept, single, fp32):
        r.pop("walltime_s")
    assert swept == single
    assert swept["J_actual_mse"] != rows["ckpt=1,wu=1000.0,wf=0.0"]["J_actual_mse"]
    assert swept != fp32


def test_port_checkpoint_sweep_bf16_repacks_each_checkpoint(models, tmp_path):
    """With ``--bf16 True --impl pallas`` (the weight-only bf16 packs) the
    sweep loads each float32 checkpoint into the bf16 nets and rebuilds
    their bf16 packs: the ``ckpt=2`` row equals a ``--checkpoint 2`` run,
    the rows differ, and neither is the float32 row."""
    _bf16_sweep(models, tmp_path, "pallas")


def test_port_checkpoint_sweep_flax_bf16_repacks_each_checkpoint(models, tmp_path):
    """The same with ``--bf16 True`` and the default ``--impl xla``: the
    flax dtype=bfloat16 nets."""
    _bf16_sweep(models, tmp_path, "xla")
