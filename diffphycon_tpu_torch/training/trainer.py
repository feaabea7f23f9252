"""Training harness: the optimizer step, the EMA, checkpoints, resume and a
SIGTERM-safe loop.

Port of ``diffphycon_tpu/training/trainer.py``. One optimizer step is: the
loss (``GaussianDiffusion.loss`` at t and noise drawn from the trainer's
``torch.Generator``), backward, the global-norm clip, Adam at the scheduled
learning rate, then the EMA. With ``gradient_accumulate_every = k`` the
batch is cut into k micro-batches and the gradient is the mean of theirs (t
and the noise are drawn for the whole batch first, so the result equals the
full-batch gradient).

Data parallel (``mesh=``, :mod:`diffphycon_tpu_torch.parallel`): the batch
iterator yields the global batch of ``train_batch_size`` on every rank and
each rank keeps its contiguous shard. Every rank draws t and the noise for
the whole global batch from the same seeded generator and keeps its slice,
so an N-rank step gives the one-rank full-batch step (JAX's psum over a
sharded batch). The model runs inside ``DistributedDataParallel``, which
averages the gradients; under accumulation every micro-batch but the last
runs under ``no_sync()``. Clip, Adam and the EMA then run on every rank on
the same averaged gradients. Rank 0 alone writes checkpoints and logs;
``resume`` loads on every rank.

Checkpoints are torch files ``<results_folder>/ckpt/<raw step>/checkpoint.pt``
holding the step, the parameters, the EMA parameters, the optimizer state and
the generator state. The id is always the raw optimizer step (the JAX trainer
explains why: mixing milestone indices with raw-step ids loses checkpoints).
The newest 20 are kept, and every step that is a multiple of
``ckpt_keep_period`` (the LR-cycle minima of cosine10000).
"""

from __future__ import annotations

import contextlib
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
from diffphycon_tpu_torch.parallel.mesh import Mesh, shard_batch
from diffphycon_tpu_torch.training.train_state import (
    EMAConfig,
    clip_by_global_norm_,
    ema_update_,
    make_optimizer,
    multistep_lr,
    set_lr,
    torch_cosine_annealing,
)
from diffphycon_tpu_torch.utils.profiling import span

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


def _chunks(a, k: int):
    """a tensor's k chunks along dim 0, or a tuple's, element by element."""
    if isinstance(a, tuple):
        return list(zip(*(x.chunk(k) for x in a)))
    return a.chunk(k)


class _Loss(torch.nn.Module):
    """The loss of one (micro-)batch as a module holding the trained model,
    so that ``DistributedDataParallel`` can wrap it: the diffusion calls the
    model itself, and DDP only needs its forward to lead to the model's
    parameters."""

    def __init__(self, diffusion, model: torch.nn.Module):
        super().__init__()
        self.gd = diffusion
        self.model = model

    def forward(self, batch, t, cond, noise):
        return self.gd.loss(batch, cond, t=t, noise=noise)


def _to_device(batch, device):
    if isinstance(batch, tuple):
        return tuple(torch.as_tensor(x, device=device) for x in batch)
    return torch.as_tensor(batch, device=device)


def _step_seed(seed: int, step: int) -> int:
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


class Trainer:
    """Train the model behind a GaussianDiffusion.

    Args:
      diffusion: the GaussianDiffusion (its ``model`` must run ``model``), or
        any object with its two training methods, ``draw_t_noise(batch,
        generator) -> (t, noise)`` and ``loss(batch, cond, t=, noise=)``,
        where a batch or a noise may be a tuple of tensors (each split along
        dim 0 for gradient accumulation).
      model: the nn.Module whose parameters are trained.
      batch_iter: iterator of numpy global batches (B, *spatial, C), or of
        tuples of them (the same sequence on every rank).
      derive_cond: fn(batch tensor) -> cond_vals dict for the loss.
      config: TrainerConfig.
      device: default CUDA (see resolve_device); the model moves there.
      mesh: a ``parallel.Mesh`` for data parallelism (its device is the
        trainer's; ``device`` must then be None or the same); None trains on
        one device in this process.
    """

    def __init__(self, diffusion: GaussianDiffusion, model: torch.nn.Module,
                 batch_iter: Iterator[np.ndarray], derive_cond: Callable,
                 config: TrainerConfig = TrainerConfig(), device=None,
                 mesh: Optional[Mesh] = None):
        self.gd = diffusion
        self.cfg = config
        self.mesh = mesh
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} differs from the mesh's {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.model = model.to(self.device).train()
        self.batch_iter = batch_iter
        self.derive_cond = derive_cond
        self.loss_fn = _Loss(diffusion, self.model)
        self.ddp = None
        if mesh is not None and mesh.grouped:
            # DDP's construction broadcasts rank 0's parameters and buffers
            self.ddp = torch.nn.parallel.DistributedDataParallel(
                self.loss_fn, device_ids=[self.device.index] if self.device.type == "cuda"
                else None)
        named = [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]
        self.param_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.optimizer = make_optimizer(self.params, config.adam_b1, config.adam_b2)
        self.ema = [p.detach().clone() for p in self.params]
        self.step = 0
        self.schedule = _schedule(config)
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self.results_folder = Path(config.results_folder)
        if self.is_main:
            self.results_folder.mkdir(parents=True, exist_ok=True)

    @property
    def is_main(self) -> bool:
        """This process writes checkpoints and logs (rank 0, or no mesh)."""
        return self.mesh is None or self.mesh.is_main

    # -- one optimizer step -------------------------------------------------

    def compute_grads(self, batch) -> torch.Tensor:
        """Set every parameter's .grad to the (micro-batch mean) gradient of
        the loss of ``batch`` (a tensor, or a tuple of tensors for a
        diffusion whose loss takes one, as the jellyfish loss does), averaged
        over the ranks under a mesh (each rank keeps its shard of the global
        batch); returns this rank's mean loss (a device scalar). Each
        micro-batch's loss runs in the span ``trainer.forward``, its backward
        in ``trainer.backward``."""
        accum = self.cfg.gradient_accumulate_every
        world = 1 if self.mesh is None else self.mesh.world_size
        n = (batch[0] if isinstance(batch, tuple) else batch).shape[0]
        if n % (accum * world):
            raise ValueError(f"batch {n} is not a multiple of gradient_accumulate_every="
                             f"{accum} x {world} ranks")
        t, noise = self.gd.draw_t_noise(batch, self.generator)
        if world > 1:
            batch, t, noise = shard_batch(self.mesh, (batch, t, noise))
        for p in self.params:
            p.grad = None
        total = torch.zeros((), device=self.device)
        micro = list(zip(_chunks(batch, accum), t.chunk(accum), _chunks(noise, accum)))
        for i, (xs, ts, ns) in enumerate(micro):
            no_sync = self.ddp is not None and i < accum - 1
            with self.ddp.no_sync() if no_sync else contextlib.nullcontext():
                with span("trainer.forward"):
                    loss = (self.ddp or self.loss_fn)(xs, ts, self.derive_cond(xs), ns) / accum
                with span("trainer.backward"):
                    loss.backward()
            total = total + loss.detach()
        return total

    def apply_gradients(self) -> None:
        """Clip, Adam at the scheduled rate, then the EMA (in the span
        ``trainer.optimizer``)."""
        with span("trainer.optimizer"):
            grads = [p.grad for p in self.params]
            clip_by_global_norm_(grads, self.cfg.max_grad_norm)
            set_lr(self.optimizer, self.schedule(self.step))
            self.optimizer.step()
            self.step += 1
            ema_update_(self.ema, self.params, self.cfg.ema, self.step)

    def train_step(self, batch) -> torch.Tensor:
        loss = self.compute_grads(_to_device(batch, self.device))
        self.apply_gradients()
        return loss

    # -- checkpointing ------------------------------------------------------

    @property
    def ckpt_dir(self) -> Path:
        return self.results_folder / "ckpt"

    def save(self, milestone: Optional[int] = None) -> Path:
        """Save {step, params, ema_params, opt_state, generator} under the
        raw step (``milestone`` is accepted for call-site compatibility and
        ignored, as in the JAX trainer); then prune. Only rank 0 writes."""
        del milestone
        out = self.ckpt_dir / str(self.step)
        if not self.is_main:
            return out
        payload = {"step": self.step,
                   "params": {n: p.detach().cpu() for n, p in zip(self.param_names, self.params)},
                   "ema_params": {n: e.cpu() for n, e in zip(self.param_names, self.ema)},
                   "opt_state": self.optimizer.state_dict(),
                   "generator": self.generator.get_state()}
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
        step and the loop returns; the previous handler is restored. Under a
        mesh of several ranks the ranks agree on the flag on the host, one
        step late: all stop after the step that follows the first SIGTERM."""
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
        distributed = self.mesh is not None and self.mesh.world_size > 1
        stopping = False
        vote = None  # the ranks' OR of their SIGTERM flags, started a step ago
        try:
            with open(log_path, "a") if self.is_main else contextlib.nullcontext() as logf:
                while self.step < cfg.train_num_steps and not stopping:
                    losses.append(self.train_step(next(self.batch_iter)))
                    step = self.step
                    if not distributed:
                        stopping = stop["requested"]
                    else:
                        # every rank stops at the same step: each reads the
                        # OR of the flags of one step earlier, which the host
                        # computed while this step ran (no device sync)
                        if vote is not None:
                            stopping = vote()
                        vote = self.mesh.any_async(stop["requested"])
                    if step % cfg.log_every == 0 or step == cfg.train_num_steps:
                        mean = torch.stack(losses).mean()
                        losses.clear()
                        if distributed:
                            torch.distributed.all_reduce(mean)
                            mean = mean / self.mesh.world_size
                        if self.is_main:
                            lval = float(mean)
                            rec = {"step": step, "loss": lval,
                                   "wall_s": round(time.time() - t0, 2)}
                            logf.write(json.dumps(rec) + "\n")
                            logf.flush()
                            if progress:
                                print(f"step {step}: loss {lval:.5f}", flush=True)
                    if step % cfg.save_and_sample_every == 0:
                        self.save()
            if vote is not None:
                stopping = vote() or stopping
            if stopping:
                if self.step % cfg.save_and_sample_every != 0:
                    self.save()
                if self.is_main:
                    print(f"SIGTERM: saved checkpoint at step {self.step}, exiting",
                          flush=True)
        finally:
            if handler_installed:
                # a None previous handler was installed outside Python
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None else signal.SIG_DFL)
        return self.step
