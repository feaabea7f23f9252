"""The port's Burgers training path against the JAX package on the CPU: the
loss weights, ``p_losses`` with the training masks, clip + Adam, the EMA,
the LR schedules and the data iterator; then the port's Trainer (loop,
gradient accumulation, checkpoints, keep_period, resume, SIGTERM) and the
train -> infer apps at a tiny size.

Tolerances (max |port - jax| <= rtol * max(1, max |jax|)):
- loss weights, stacked data and batches: exact (same numpy arithmetic);
- p_losses: 1e-6, an elementwise stand-in model makes both sides compute the
  same float32 terms (the UNet2D's gradients: test_torch_port_attention.py);
- one clip + Adam step, schedules: 1e-6 (optax and torch round the bias
  corrections in another order);
- 130 EMA steps: 1e-6;
- gradient accumulation against the full batch: 1e-5 (summation order).
"""

import json
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.benchmarks import burgers as jbench
from diffphycon_tpu.diffusion.core import DiffusionConstants as JaxConsts
from diffphycon_tpu.training import train_state as jts
from diffphycon_tpu.training.data import ArrayDataset as JaxArrayDataset
from diffphycon_tpu.training.data import stack_burgers_uf as jax_stack
from diffphycon_tpu_torch.apps import infer_burgers, train_burgers
from diffphycon_tpu_torch.benchmarks import burgers as tbench
from diffphycon_tpu_torch.diffusion import GaussianDiffusion, burgers_cond_spec
from diffphycon_tpu_torch.diffusion.conditioning import burgers_derive_cond
from diffphycon_tpu_torch.diffusion.core import DiffusionConstants
from diffphycon_tpu_torch.nets.init import seeded_init_
from diffphycon_tpu_torch.nets.unet2d import UNet2D
from diffphycon_tpu_torch.training import train_state as ts
from diffphycon_tpu_torch.training.data import ArrayDataset, stack_burgers_uf
from diffphycon_tpu_torch.training.trainer import Trainer, TrainerConfig
from torch_port_helpers import assert_close, rand


@pytest.mark.parametrize("beta_schedule", ["cosine", "linear", "sigmoid"])
def test_port_loss_weight_exact(beta_schedule):
    """pred_noise's loss weights (the only objective ported)."""
    ref = JaxConsts.create(100, beta_schedule, "pred_noise").loss_weight
    out = DiffusionConstants.create(100, beta_schedule, device="cpu").loss_weight
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _jax_model(params, x, t):
    return jnp.tanh(x * params["a"] + params["b"] * (t[:, None, None, None] / 1000.0))


def _torch_model(a, b):
    def model(x, t):
        return torch.tanh(x * a + b * (t[:, None, None, None] / 1000.0))
    return model


@pytest.mark.parametrize("is_model_w,partial,padded", [
    (False, None, True), (True, None, True), (False, "front_rear_quarter", True),
    (False, "front_rear_quarter_u_and_f", False), (True, "front_rear_quarter", False)])
def test_port_p_losses_matches_jax(is_model_w, partial, padded):
    """p_losses term for term (q_sample, pin, w_zero_input, target, the pre
    mask, zero_target, the post mask, loss_weight[t]), fed JAX's noise."""
    kw = dict(is_condition_u0=True, is_condition_uT=True, is_model_w=is_model_w,
              train_on_partially_observed=partial, train_on_padded_locations=padded)
    x = 0.3 * rand(3, 16, 32, 2, seed=1)
    t = np.array([0, 417, 999])
    params = {"a": 1 + 0.1 * rand(2, seed=2), "b": np.float32(0.7)}
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))
    jgd = jbench.build_diffusion(jbench.BurgersConfig(**kw), _jax_model)
    ref = jgd.p_losses(params, key, jnp.asarray(x), jnp.asarray(t),
                       jbench.derive_cond(jnp.asarray(x)))
    tgd = tbench.build_diffusion(
        tbench.BurgersConfig(**kw),
        _torch_model(torch.from_numpy(params["a"]), float(params["b"])), device="cpu")
    xt = torch.from_numpy(x)
    out = tgd.p_losses(xt, torch.from_numpy(t), tbench.derive_cond(xt), torch.from_numpy(noise))
    assert_close(out, ref, 1e-6)


def test_port_schedules_at_their_boundaries():
    cos, jcos = ts.torch_cosine_annealing(1e-4, 10000), jts.torch_cosine_annealing(1e-4, 10000)
    for step in (0, 1, 5000, 9999, 10000, 10001, 25000):
        assert cos(step) == pytest.approx(float(jcos(step)), rel=1e-6, abs=1e-12)
    milestones = (50, 150, 300)
    ms, jms = ts.multistep_lr(1e-4, milestones), jts.multistep_lr(1e-4, milestones)
    for m in milestones:
        for step in (m - 1, m, m + 1):
            assert ms(step) == pytest.approx(float(jms(step)), rel=1e-6), step
    assert ts.multistep_lr(1.0, (10,))(9) == 1.0 and ts.multistep_lr(1.0, (10,))(10) == 0.1


@pytest.mark.parametrize("scale", [10.0, 0.01])
def test_port_clip_and_adam_steps_match_optax(scale):
    """Three clipped Adam steps on the cosine schedule: the global norm is
    above max_norm (clipped) or below it (passed through)."""
    params = {"w": rand(5, 4, seed=1), "b": rand(4, seed=2)}
    grads = [{k: scale * rand(*v.shape, seed=10 * i + j) for j, (k, v) in enumerate(params.items())}
             for i in range(3)]
    tx = jts.make_optimizer(jts.torch_cosine_annealing(1e-2, 100))
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in ("w", "b")]
    opt = ts.make_optimizer(tp)
    for step, g in enumerate(grads):
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        for p, k in zip(tp, ("w", "b")):
            p.grad = torch.from_numpy(g[k].copy())
        ts.clip_by_global_norm_([p.grad for p in tp], 1.0)
        ts.set_lr(opt, ts.torch_cosine_annealing(1e-2, 100)(step))
        opt.step()
        for p, k in zip(tp, ("w", "b")):
            assert_close(p, jp[k], 1e-6)


class _Params(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(arrays["w"].copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(arrays["b"].copy()))


def test_port_trainer_update_and_ema_match_train_state(tmp_path):
    """130 optimizer steps of Trainer.apply_gradients (clip, Adam on
    cosine10000, EMA with its copy phase up to step 100 and its warm-up)
    against TrainState.apply_gradients."""
    arrays = {"w": rand(6, 3, seed=1), "b": rand(3, seed=2)}
    state = jts.TrainState.create(jax.tree.map(jnp.asarray, arrays),
                                  jts.make_optimizer(jts.torch_cosine_annealing(1e-4, 10000)),
                                  jts.EMAConfig())
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    model = _Params(arrays)
    tr = Trainer(None, model, iter(()), None,
                 TrainerConfig(results_folder=str(tmp_path / "run")), device="cpu")
    for i in range(130):
        g = {"w": rand(6, 3, seed=100 + i), "b": 3 * rand(3, seed=400 + i)}
        state = apply(state, jax.tree.map(jnp.asarray, g))
        model.w.grad, model.b.grad = torch.from_numpy(g["w"]), torch.from_numpy(g["b"])
        tr.apply_gradients()
    assert tr.step == int(state.step) == 130
    for k, p, e in zip(("w", "b"), tr.params, tr.ema):
        assert_close(p, state.params[k], 1e-6)
        assert_close(e, state.ema_params[k], 1e-6)
    assert not torch.equal(tr.ema[0], tr.params[0])  # past the copy phase


def test_port_stack_and_batches_bit_equal():
    u, f = rand(10, 11, 128, seed=3), rand(10, 10, 128, seed=4)
    for fill in (None, "front_rear_quarter"):
        np.testing.assert_array_equal(stack_burgers_uf(u, f, partially_observed_fill_zero=fill),
                                      jax_stack(u, f, partially_observed_fill_zero=fill))
    data = stack_burgers_uf(u, f)
    ours, theirs = ArrayDataset(data).batches(3, seed=4), JaxArrayDataset(data).batches(3, seed=4)
    for _ in range(7):  # across an epoch boundary (3 batches per epoch)
        np.testing.assert_array_equal(next(ours), next(theirs))


# -- the port's Trainer --------------------------------------------------------


def _tiny(tmp_path, batch_iter=None, seed=0, **over):
    data = stack_burgers_uf(rand(16, 11, 32, seed=7), rand(16, 10, 32, seed=8))
    net = seeded_init_(UNet2D(dim=8, dim_mults=(1, 2)), torch.Generator().manual_seed(seed))
    gd = GaussianDiffusion(net, sample_shape=(16, 32, 2), timesteps=20,
                           cond=burgers_cond_spec(is_condition_u0=True), device="cpu")
    cfg = dict(train_batch_size=4, train_num_steps=6, save_and_sample_every=100,
               results_folder=str(tmp_path / "run"), log_every=2)
    cfg.update(over)
    return Trainer(gd, net, batch_iter or ArrayDataset(data).batches(4), burgers_derive_cond,
                   TrainerConfig(**cfg), device="cpu")


def test_port_trainer_loop_logs_finite_losses(tmp_path):
    tr = _tiny(tmp_path)
    assert tr.train(progress=False) == 6
    log = [json.loads(line) for line in (tmp_path / "run" / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in log] == [2, 4, 6]
    assert all(np.isfinite(r["loss"]) for r in log)


def test_port_trainer_accumulation_equals_full_batch(tmp_path):
    batch = torch.from_numpy(stack_burgers_uf(rand(4, 11, 32, seed=9), rand(4, 10, 32, seed=10)))
    full = _tiny(tmp_path / "a")
    accum = _tiny(tmp_path / "b", gradient_accumulate_every=2)
    lf, la = full.compute_grads(batch), accum.compute_grads(batch)
    assert_close(la, lf, 1e-5)
    for pa, pf in zip(accum.params, full.params):
        assert_close(pa.grad, pf.grad, 1e-5)


def test_port_trainer_checkpoint_round_trip(tmp_path):
    tr = _tiny(tmp_path)
    tr.train(progress=False)
    tr.save(milestone=1)
    tr2 = _tiny(tmp_path, seed=1)
    tr2.load(6)
    assert tr2.step == 6
    for a, b in zip(tr.params + tr.ema, tr2.params + tr2.ema):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    legacy = Trainer.load_params(str(tmp_path / "run"), 1, use_ema=False)  # 1st saved step
    torch.testing.assert_close(legacy["init_conv.weight"], tr2.model.init_conv.weight.detach(),
                               rtol=0, atol=0)
    batch = next(ArrayDataset(stack_burgers_uf(rand(4, 11, 32), rand(4, 10, 32))).batches(4))
    tr.train_step(batch)
    tr2.train_step(batch)  # same optimizer and generator state -> same step
    for a, b in zip(tr.params, tr2.params):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    ema = Trainer.load_params(str(tmp_path / "run"), 6, use_ema=True)
    assert set(ema) == {n for n, _ in tr.model.named_parameters()}
    (tmp_path / "run" / "ckpt" / "9").mkdir()
    (tmp_path / "run" / "ckpt" / "9" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="params_npz"):
        Trainer.load_params(str(tmp_path / "run"), 9)


def test_port_trainer_keep_period_protects_lr_minima(tmp_path):
    tr = _tiny(tmp_path, ckpt_keep_period=5)
    for s in range(1, 26):
        tr.step = s
        tr.save()
    steps = {int(d.name) for d in (tmp_path / "run" / "ckpt").iterdir()}
    assert steps == set(range(6, 26)) | {5}


def test_port_trainer_kill_and_resume_continues(tmp_path):
    tr = _tiny(tmp_path, save_and_sample_every=3, train_num_steps=3)
    tr.train(progress=False)
    at_kill = [p.detach().clone() for p in tr.params]
    tr2 = _tiny(tmp_path, seed=1, save_and_sample_every=3)
    assert tr2.resume() is True and tr2.step == 3
    for a, b in zip(at_kill, tr2.params):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)
    assert tr2.train(progress=False) == 6
    log = (tmp_path / "run" / "train_log.jsonl").read_text().splitlines()
    assert all(np.isfinite(json.loads(line)["loss"]) for line in log)
    assert _tiny(tmp_path / "fresh").resume() is False


def test_port_trainer_sigterm_saves_and_restores_handler(tmp_path):
    """A SIGTERM during a step: the step finishes, a checkpoint is saved at
    the current raw step, the loop returns and the old handler is back."""
    data = ArrayDataset(stack_burgers_uf(rand(8, 11, 32), rand(8, 10, 32))).batches(4)

    def batches():
        for i, b in enumerate(data):
            if i == 2:
                signal.raise_signal(signal.SIGTERM)  # while step 3 is in flight
            yield b

    before = signal.getsignal(signal.SIGTERM)
    tr = _tiny(tmp_path, batch_iter=batches(), train_num_steps=10_000)
    assert tr.train(progress=False) == 3
    assert (tmp_path / "run" / "ckpt" / "3" / "checkpoint.pt").is_file()
    assert signal.getsignal(signal.SIGTERM) == before


def test_port_train_then_infer_from_checkpoints(tmp_path):
    """train_burgers (joint, resumed, prior) -> infer_burgers --checkpoint."""
    common = ["--synthetic_data", "4", "--batch_size", "2", "--dim", "8", "--dim_mults", "1",
              "2", "--is_condition_u0", "True", "--is_condition_uT", "True", "--exp_id", "e",
              "--data_root", str(tmp_path / "data"), "--checkpoint_interval", "2"]
    root = tmp_path / "trained_models"
    tr = train_burgers.main(train_burgers.build_parser().parse_args(
        common + ["--device", "cpu", "--train_num_steps", "2",
                  "--results_folder", str(root / "burgers" / "e")]))
    assert tr.step == 2
    tr = train_burgers.main(train_burgers.build_parser().parse_args(
        common + ["--cpu", "--train_num_steps", "4", "--resume", "True",
                  "--results_folder", str(root / "burgers" / "e")]))
    assert tr.step == 4
    train_burgers.main(train_burgers.build_parser().parse_args(
        common + ["--cpu", "--train_num_steps", "2", "--is_model_w", "True",
                  "--results_folder", str(root / "burgers_w" / "e")]))
    args = infer_burgers.build_parser().parse_args([
        "--device", "cpu", "--model_root", str(root), "--exp_id", "e", "--checkpoint", "4",
        "--checkpoint__model_w", "2", "--synthetic_data", "2", "--n_test_samples", "2",
        "--batch_size", "2", "--eval_two_models", "True", "--wus", "1000",
        "--is_condition_u0", "True", "--is_condition_uT", "True", "--using_ddim", "True",
        "--ddim_sampling_steps", "2", "--dim", "8", "--dim_mults", "1", "2",
        "--data_root", str(tmp_path / "data"), "--save_file", str(tmp_path / "r.json")])
    entry = infer_burgers.main(args)["wu=1000.0,wf=0.0"]
    assert all(np.isfinite(v) for v in entry.values())
