"""The port's four Burgers baseline apps end to end on the CPU at tiny
sizes, and ``eval_pid_sl_burgers`` (method sl) against the JAX app.

- ``eval_pid_sl_burgers.main(--methods sl)`` in both packages (n_test 2, 3
  Adam steps through the solver at dt 1e-3): the same row, J_actual and
  energy within 1e-5 relative (float32 solver steps in another fusion
  order; Adam's first update lr * g / (|g| + eps) is a sign, so a wrong
  gradient moves f by the lr 5e-2 and J far more);
- ``train_burgers_operator`` (s_ob 128 then 64, warm-started through
  ``--init_from``), then ``eval_pid_sl_burgers`` with all three methods,
  ``sl_surrogate`` reading the operator's file;
- ``train_baselines_burgers`` for bc, bppo and sac (full state; bppo also
  under partial control and observation);
- ``train_sac_burgers`` for 2 episodes, full and partial control.
"""

import json

import numpy as np
import pytest

from diffphycon_tpu_torch.apps import (
    eval_pid_sl_burgers,
    train_baselines_burgers,
    train_burgers_operator,
    train_sac_burgers,
)

import torch_port_helpers  # noqa: F401  (one intra-op thread per worker)


def _rows(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_port_eval_pid_sl_sl_rows_match_jax(tmp_path):
    import apps.eval_pid_sl_burgers as japp

    flags = ["--n_data", "4", "--n_test", "2", "--sl_steps", "3", "--methods", "sl"]
    ref = japp.main(japp.build_parser().parse_args(
        flags + ["--save_file", str(tmp_path / "jax.json")]))
    out = eval_pid_sl_burgers.main(eval_pid_sl_burgers.build_parser().parse_args(
        flags + ["--save_file", str(tmp_path / "port.json"), "--device", "cpu"]))
    assert [r["method"] for r in out] == ["sl"]
    for r, q in zip(out, ref):
        assert r.keys() == q.keys()
        for k in ("J_actual_mse", "control_energy"):
            assert r[k] == pytest.approx(q[k], rel=1e-5), k
    assert _rows(tmp_path / "port.json") == out


def test_port_operator_training_and_eval_apps(tmp_path):
    op_dir = tmp_path / "op"
    common = ["--synthetic_data", "4", "--batch_size", "8", "--data_root", str(tmp_path / "d"),
              "--results_folder", str(op_dir), "--device", "cpu"]
    first = train_burgers_operator.main(train_burgers_operator.build_parser().parse_args(
        common + ["--num_steps", "3"]))
    assert len(first["losses"]) == 3 and all(np.isfinite(first["losses"]))
    assert (op_dir / "params_sob128.pt").is_file()
    again = train_burgers_operator.main(train_burgers_operator.build_parser().parse_args(
        common + ["--num_steps", "2", "--init_from", str(op_dir / "params_sob128.pt")]))
    # warm-started: the first loss is the trained weights' loss, not a fresh one's
    assert again["losses"][0] != pytest.approx(first["losses"][0])
    po = train_burgers_operator.main(train_burgers_operator.build_parser().parse_args(
        common + ["--num_steps", "2", "--s_ob", "64"]))
    assert (op_dir / "params_sob64.pt").is_file() and np.isfinite(po["final_one_step_rel_l2"])

    save = tmp_path / "b.json"
    rows = eval_pid_sl_burgers.main(eval_pid_sl_burgers.build_parser().parse_args(
        ["--n_data", "4", "--n_test", "2", "--pid_steps", "2", "--sl_steps", "2",
         "--operator_folder", str(op_dir), "--save_file", str(save), "--device", "cpu",
         "--partial_control", "front_rear_quarter"]))
    assert [r["method"] for r in rows] == ["pid", "sl", "sl_surrogate"]
    assert all(np.isfinite(r["J_actual_mse"]) and np.isfinite(r["control_energy"])
               for r in rows)
    assert _rows(save) == rows


@pytest.mark.parametrize("method,extra", [
    ("bc", []), ("sac", []),
    ("bppo", ["--partial_control", "front_rear_quarter",
              "--partially_observed", "front_rear_quarter"])])
def test_port_train_baselines_burgers_app(tmp_path, method, extra):
    save = tmp_path / "b.json"
    row = train_baselines_burgers.main(train_baselines_burgers.build_parser().parse_args(
        ["--method", method, "--n_data", "6", "--n_test", "2", "--bc_steps", "3",
         "--critic_steps", "2", "--bppo_steps", "2", "--sac_steps", "3", "--hidden_dim", "32",
         "--save_file", str(save), "--device", "cpu"] + extra))
    assert _rows(save) == [row]
    assert row["updates"] == {"bc": 3, "sac": 3, "bppo": 3 + 4 + 2}[method]
    for k in ("J_actual_mse", "control_energy") + {
            "bc": ("bc_loss",), "sac": ("sac_q_loss", "sac_pi_loss"),
            "bppo": ("bc_loss", "bppo_loss")}[method]:
        assert np.isfinite(row[k]), k


@pytest.mark.parametrize("partial", [False, True])
def test_port_train_sac_burgers_app(tmp_path, partial):
    save = tmp_path / "sac.json"
    res = train_sac_burgers.main(train_sac_burgers.build_parser().parse_args(
        ["--n_data", "6", "--n_test", "2", "--num_episode", "2", "--train_batch_size", "3",
         "--updates_per_step", "2", "--batch_size", "8", "--hidden_dim", "32",
         "--replay_size", "100", "--eval_every", "1", "--save_file", str(save),
         "--device", "cpu"]
        + (["--partial_control", "front_rear_quarter",
            "--partially_observed", "front_rear_quarter"] if partial else [])))
    assert [e["episode"] for e in res["episodes"]] == [1, 2]
    assert res["updates"] == 4 and np.isfinite(res["J_actual_mse"])
    assert json.loads(save.read_text()) == res
