"""Training harness: the optimizer step, the EMA, checkpoints, resume and a
SIGTERM-safe loop.

Port of ``diffphycon_tpu/training/trainer.py`` on one device. One optimizer
step is: the loss (``GaussianDiffusion.p_losses`` at t and noise drawn from
the trainer's ``torch.Generator``), backward, the global-norm clip, Adam at
the scheduled learning rate, then the EMA. With ``gradient_accumulate_every
= k`` the batch is cut into k micro-batches and the gradient is the mean of
theirs (t and the noise are drawn for the whole batch first, so the result
equals the full-batch gradient).

Checkpoints are torch files ``<results_folder>/ckpt/<raw step>/checkpoint.pt``
holding the step, the parameters, the EMA parameters, the optimizer state and
the generator state. The id is always the raw optimizer step (the JAX trainer
explains why: mixing milestone indices with raw-step ids loses checkpoints).
The newest 20 are kept, and every step that is a multiple of
``ckpt_keep_period`` (the LR-cycle minima of cosine10000).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import time
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from diffphycon_tpu_torch.device import resolve_device
from diffphycon_tpu_torch.diffusion.core import GaussianDiffusion
from diffphycon_tpu_torch.training.train_state import (
    EMAConfig,
    clip_by_global_norm_,
    ema_update_,
    make_optimizer,
    multistep_lr,
    set_lr,
    torch_cosine_annealing,
)

CKPT_FILE = "checkpoint.pt"
MAX_TO_KEEP = 20


@dataclasses.dataclass
class TrainerConfig:
    train_batch_size: int = 16
    train_lr: float = 1e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.99
    max_grad_norm: float = 1.0
    train_num_steps: int = 100_000
    gradient_accumulate_every: int = 1
    save_and_sample_every: int = 10_000
    results_folder: str = "./results"
    lr_schedule: str = "cosine10000"  # 'cosine10000' | 'multistep' | 'constant'
    lr_milestones: tuple = (50_000, 150_000, 300_000)
    lr_gamma: float = 0.1
    ema: EMAConfig = dataclasses.field(default_factory=EMAConfig)
    seed: int = 0
    log_every: int = 100
    # keep-last-20 pruning also keeps every step that is a multiple of this
    # period (None disables)
    ckpt_keep_period: Optional[int] = 10_000


def _schedule(cfg: TrainerConfig) -> Callable[[int], float]:
    if cfg.lr_schedule == "cosine10000":
        return torch_cosine_annealing(cfg.train_lr, 10_000)
    if cfg.lr_schedule == "multistep":
        return multistep_lr(cfg.train_lr, cfg.lr_milestones, cfg.lr_gamma)
    if cfg.lr_schedule == "constant":
        return lambda _: cfg.train_lr
    raise ValueError(cfg.lr_schedule)


def _saved_steps(ckpt_dir: Path):
    if not ckpt_dir.is_dir():
        return []
    return sorted(int(d.name) for d in ckpt_dir.iterdir() if d.name.isdigit())


def _resolve_milestone(ckpt_dir: Path, milestone: int) -> Path:
    """A raw step id, or (legacy) the milestone-th saved checkpoint in step
    order when no step has that id."""
    steps = _saved_steps(ckpt_dir)
    step = milestone
    if step not in steps and 1 <= milestone <= len(steps):
        step = steps[milestone - 1]
    path = ckpt_dir / str(step)
    if not path.is_dir():
        raise FileNotFoundError(f"no checkpoint {milestone} under {ckpt_dir} "
                                f"(saved steps: {steps})")
    if not (path / CKPT_FILE).is_file():
        raise NotImplementedError(
            f"{path} holds no {CKPT_FILE}: a checkpoint written by the JAX trainer "
            "(orbax) cannot be read by the port; export its weights to a flax-path "
            "npz (utils/convert.py) and pass --params_npz")
    return path / CKPT_FILE


def _step_seed(seed: int, step: int) -> int:
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


class Trainer:
    """Train the model behind a GaussianDiffusion.

    Args:
      diffusion: the GaussianDiffusion; its ``model`` must run ``model``.
      model: the nn.Module whose parameters are trained.
      batch_iter: iterator of numpy batches (B, *spatial, C).
      derive_cond: fn(batch tensor) -> cond_vals dict for p_losses.
      config: TrainerConfig.
      device: default CUDA (see resolve_device); the model moves there.
    """

    def __init__(self, diffusion: GaussianDiffusion, model: torch.nn.Module,
                 batch_iter: Iterator[np.ndarray], derive_cond: Callable,
                 config: TrainerConfig = TrainerConfig(), device=None):
        self.gd = diffusion
        self.cfg = config
        self.device = resolve_device(device)
        self.model = model.to(self.device).train()
        self.batch_iter = batch_iter
        self.derive_cond = derive_cond
        named = [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]
        self.param_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.optimizer = make_optimizer(self.params, config.adam_b1, config.adam_b2)
        self.ema = [p.detach().clone() for p in self.params]
        self.step = 0
        self.schedule = _schedule(config)
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self.results_folder = Path(config.results_folder)
        self.results_folder.mkdir(parents=True, exist_ok=True)

    # -- one optimizer step -------------------------------------------------

    def compute_grads(self, batch: torch.Tensor) -> torch.Tensor:
        """Set every parameter's .grad to the (micro-batch mean) gradient of
        the loss of ``batch``; returns the mean loss (a device scalar)."""
        accum = self.cfg.gradient_accumulate_every
        if batch.shape[0] % accum:
            raise ValueError(f"batch {batch.shape[0]} is not a multiple of "
                             f"gradient_accumulate_every={accum}")
        t, noise = self.gd.draw_t_noise(batch, self.generator)
        for p in self.params:
            p.grad = None
        total = torch.zeros((), device=self.device)
        for xs, ts, ns in zip(batch.chunk(accum), t.chunk(accum), noise.chunk(accum)):
            loss = self.gd.p_losses(xs, ts, self.derive_cond(xs), ns) / accum
            loss.backward()
            total = total + loss.detach()
        return total

    def apply_gradients(self) -> None:
        """Clip, Adam at the scheduled rate, then the EMA."""
        grads = [p.grad for p in self.params]
        clip_by_global_norm_(grads, self.cfg.max_grad_norm)
        set_lr(self.optimizer, self.schedule(self.step))
        self.optimizer.step()
        self.step += 1
        ema_update_(self.ema, self.params, self.cfg.ema, self.step)

    def train_step(self, batch: np.ndarray) -> torch.Tensor:
        loss = self.compute_grads(torch.as_tensor(batch, device=self.device))
        self.apply_gradients()
        return loss

    # -- checkpointing ------------------------------------------------------

    @property
    def ckpt_dir(self) -> Path:
        return self.results_folder / "ckpt"

    def save(self, milestone: Optional[int] = None) -> Path:
        """Save {step, params, ema_params, opt_state, generator} under the
        raw step (``milestone`` is accepted for call-site compatibility and
        ignored, as in the JAX trainer); then prune."""
        del milestone
        payload = {"step": self.step,
                   "params": {n: p.detach().cpu() for n, p in zip(self.param_names, self.params)},
                   "ema_params": {n: e.cpu() for n, e in zip(self.param_names, self.ema)},
                   "opt_state": self.optimizer.state_dict(),
                   "generator": self.generator.get_state()}
        out = self.ckpt_dir / str(self.step)
        tmp = self.ckpt_dir / f".tmp-{self.step}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        torch.save(payload, tmp / CKPT_FILE)
        shutil.rmtree(out, ignore_errors=True)
        os.replace(tmp, out)
        self._prune()
        return out

    def _prune(self) -> None:
        steps = _saved_steps(self.ckpt_dir)
        keep = set(steps[-MAX_TO_KEEP:])
        period = self.cfg.ckpt_keep_period
        if period:
            keep |= {s for s in steps if s % period == 0}
        for s in steps:
            if s not in keep:
                shutil.rmtree(self.ckpt_dir / str(s))

    def load(self, milestone: int) -> None:
        """Restore step, parameters, EMA, optimizer and generator state."""
        payload = torch.load(_resolve_milestone(self.ckpt_dir, milestone),
                             map_location="cpu", weights_only=True)
        with torch.no_grad():
            for n, p, e in zip(self.param_names, self.params, self.ema):
                p.copy_(payload["params"][n])
                e.copy_(payload["ema_params"][n])
        self.optimizer.load_state_dict(payload["opt_state"])
        self.generator.set_state(payload["generator"])
        self.step = int(payload["step"])

    def resume(self, milestone: Optional[int] = None) -> bool:
        """Restore the latest (or given) checkpoint; False when there is none
        (a fresh run). The generator is then re-seeded from (seed, step), as
        the JAX trainer re-keys, so a resumed run does not replay step 0's
        draws."""
        if milestone is None:
            milestone = self.latest_milestone(str(self.results_folder))
        if milestone is None:
            return False
        self.load(milestone)
        self.generator.manual_seed(_step_seed(self.cfg.seed, self.step))
        return True

    @staticmethod
    def latest_milestone(results_folder: str) -> Optional[int]:
        """Largest saved step under <results_folder>/ckpt, or None."""
        steps = _saved_steps(Path(results_folder) / "ckpt")
        return steps[-1] if steps else None

    @staticmethod
    def load_params(results_folder: str, milestone: int, use_ema: bool = True) -> dict:
        """The (EMA) parameters of a checkpoint as a name -> CPU tensor dict
        for ``load_state_dict``. ``milestone`` is a raw step or (legacy) an
        index into the saved steps."""
        path = _resolve_milestone(Path(results_folder) / "ckpt", milestone)
        payload = torch.load(path, map_location="cpu", weights_only=True)
        return payload["ema_params" if use_ema else "params"]

    # -- loop ---------------------------------------------------------------

    def train(self, progress: bool = True) -> int:
        """Run to ``train_num_steps``; returns the final step. On SIGTERM the
        step in flight finishes, a checkpoint is saved at the current raw
        step and the loop returns; the previous handler is restored."""
        cfg = self.cfg
        log_path = self.results_folder / "train_log.jsonl"
        t0 = time.time()
        losses = []
        stop = {"requested": False}
        prev_handler = None
        handler_installed = False

        def _on_sigterm(signum, frame):
            stop["requested"] = True

        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
            handler_installed = True
        except ValueError:
            pass  # not in the main thread; run unguarded
        try:
            with open(log_path, "a") as logf:
                while self.step < cfg.train_num_steps and not stop["requested"]:
                    losses.append(self.train_step(next(self.batch_iter)))
                    step = self.step
                    if step % cfg.log_every == 0 or step == cfg.train_num_steps:
                        lval = float(torch.stack(losses).mean())
                        losses.clear()
                        rec = {"step": step, "loss": lval,
                               "wall_s": round(time.time() - t0, 2)}
                        logf.write(json.dumps(rec) + "\n")
                        logf.flush()
                        if progress:
                            print(f"step {step}: loss {lval:.5f}", flush=True)
                    if step % cfg.save_and_sample_every == 0:
                        self.save()
            if stop["requested"]:
                if self.step % cfg.save_and_sample_every != 0:
                    self.save()
                print(f"SIGTERM: saved checkpoint at step {self.step}, exiting", flush=True)
        finally:
            if handler_installed:
                # a None previous handler was installed outside Python
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None else signal.SIG_DFL)
        return self.step
