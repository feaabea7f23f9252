"""Training of the jellyfish surrogates: the force readout, the neural
simulator and the boundary updater.

Port of ``diffphycon_tpu/training/surrogates.py`` on one device: plain MSE
regression with the global-norm clip 1.0, Adam(0.9, 0.99) at a MultiStepLR
rate and the EMA of the trainer (``training/train_state.py``). The pairs
are built on the host exactly as the JAX package builds them:

- force: (pressure_t, bd_t) (N, H, W, 4) -> force_t (N, 1);
- simulator: (state_t, bd_t) and theta_{t+1} - theta_t -> state_{t+1};
- boundary_updater: bd_0 and theta_t - theta_0 -> bd_t.

Surrogates are torch files: ``<folder>/<name>/params.pt`` holds the EMA
weights. ``load_surrogate`` also reads ``<folder>/<name>.npz``, a JAX
parameter tree flattened by ``utils/convert.py: save_flax_npz``; a
directory written by the JAX package (orbax) raises and names that route.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from diffphycon_tpu_torch.device import resolve_device
from diffphycon_tpu_torch.training.train_state import (
    EMAConfig,
    clip_by_global_norm_,
    ema_update_,
    make_optimizer,
    multistep_lr,
    set_lr,
)

PARAMS_FILE = "params.pt"
RESUME_FILE = "resume_state.pt"
OUTLIER = 50.0  # |raw pressure| above this is replaced by the frame's inlier mean


def make_surrogate_pairs(data: dict, kind: str, force_labels=None):
    """(inputs tuple, target) numpy arrays of one surrogate from a loaded
    jellyfish dataset (states (N, T, H, W, ns), bd (N, T, H, W, 3), thetas
    (N, T), optional p_nan and norm)."""
    states, bd, thetas = data["states"], data["bd"], data["thetas"]
    n, t = thetas.shape
    if kind == "force":
        # the reference ForceData: RAW pressure, |p| > 50 replaced by the
        # frame's inlier mean, raw-NaN cells (solid) excluded from the mean,
        # skipped by the outlier rule and finally set to 0
        norm = data.get("norm")
        pressure = states[..., -1]
        if norm is not None:
            pressure = (0.5 * pressure + 0.5) * (norm["p_max"] - norm["p_min"]) + norm["p_min"]
        flat = pressure.reshape(n * t, -1)
        p_nan = data.get("p_nan")
        nan_mask = (p_nan.reshape(n * t, -1) if p_nan is not None
                    else np.zeros_like(flat, bool))
        inlier = (np.abs(flat) <= OUTLIER) & ~nan_mask
        means = np.where(inlier.any(1),
                         (flat * inlier).sum(1) / np.maximum(inlier.sum(1), 1), 0.0)
        flat = np.where((np.abs(flat) > OUTLIER) & ~nan_mask, means[:, None], flat)
        flat = np.where(nan_mask, 0.0, flat)
        pressure = flat.reshape(n, t, *bd.shape[2:4], 1).astype(np.float32)
        x = np.concatenate([pressure, bd], axis=-1).reshape(n * t, *bd.shape[2:4], 4)
        if force_labels is None:
            raise ValueError("force training requires force labels")
        y = np.nan_to_num(force_labels.reshape(n * t, 1)).astype(np.float32)
        return (x,), y
    if kind == "simulator":
        x = np.concatenate([states[:, :-1], bd[:, :-1]], axis=-1)
        x = x.reshape(n * (t - 1), *bd.shape[2:4], x.shape[-1])
        delta = (thetas[:, 1:] - thetas[:, :-1]).reshape(n * (t - 1))
        y = states[:, 1:].reshape(n * (t - 1), *states.shape[2:])
        return (x, delta), y
    if kind == "boundary_updater":
        bd0 = np.repeat(bd[:, :1], t, 1).reshape(n * t, *bd.shape[2:])
        delta = (thetas - thetas[:, :1]).reshape(n * t)
        return (bd0, delta), bd.reshape(n * t, *bd.shape[2:])
    raise ValueError(kind)


@dataclasses.dataclass
class SurrogateTrainConfig:
    lr: float = 1e-4
    batch_size: int = 16
    num_steps: int = 10_000
    lr_milestones: tuple = (5_000, 8_000)
    lr_gamma: float = 0.1
    log_every: int = 100
    save_every: int = 0  # 0 = no periodic full-state checkpoints
    results_folder: str = "./trained_models/surrogate"
    seed: int = 0


@dataclasses.dataclass
class SurrogateState:
    """The trained model (its online weights), the EMA copies of its
    parameters, the optimizer and the number of steps taken."""

    model: torch.nn.Module
    ema: List[torch.Tensor]
    optimizer: torch.optim.Optimizer
    step: int = 0

    def ema_state_dict(self) -> dict:
        names = [n for n, _ in self.model.named_parameters()]
        return {n: e.detach().cpu() for n, e in zip(names, self.ema)}


def _save_resume(state: SurrogateState, out_dir: Path) -> None:
    torch.save({"step": state.step,
                "params": {n: p.detach().cpu() for n, p in state.model.named_parameters()},
                "ema_params": state.ema_state_dict(),
                "opt_state": state.optimizer.state_dict()}, out_dir / RESUME_FILE)


def _load_resume(state: SurrogateState, out_dir: Path) -> bool:
    path = out_dir / RESUME_FILE
    if not path.is_file():
        return False
    payload = torch.load(path, map_location="cpu", weights_only=True)
    with torch.no_grad():
        for (n, p), e in zip(state.model.named_parameters(), state.ema):
            p.copy_(payload["params"][n])
            e.copy_(payload["ema_params"][n])
    state.optimizer.load_state_dict(payload["opt_state"])
    state.step = int(payload["step"])
    return True


def train_surrogate(model: torch.nn.Module, inputs: tuple, targets: np.ndarray,
                    cfg: SurrogateTrainConfig, resume: bool = False, device=None):
    """MSE regression of ``model(*inputs[idx]) -> targets[idx]`` on random
    batches (numpy's generator seeded with seed + the first step, as the
    JAX loop draws them); returns (SurrogateState, the last logged loss or
    None). ``resume`` restores <results_folder>/resume_state.pt."""
    dev = resolve_device(device)
    model = model.to(dev).train()
    params = list(model.parameters())
    state = SurrogateState(model, [p.detach().clone() for p in params], make_optimizer(params))
    schedule = multistep_lr(cfg.lr, cfg.lr_milestones, cfg.lr_gamma)
    ema_cfg = EMAConfig()
    out_dir = Path(cfg.results_folder)
    out_dir.mkdir(parents=True, exist_ok=True)
    if resume:
        _load_resume(state, out_dir)
    n = targets.shape[0]
    rng = np.random.default_rng(cfg.seed + state.step)
    t0 = time.time()
    last = None
    with open(out_dir / "train_log.jsonl", "a") as logf:
        while state.step < cfg.num_steps:
            idx = rng.integers(0, n, cfg.batch_size)
            xs = [torch.as_tensor(x[idx], device=dev) for x in inputs]
            y = torch.as_tensor(targets[idx], device=dev)
            for p in params:
                p.grad = None
            loss = ((model(*xs) - y) ** 2).mean()
            loss.backward()
            clip_by_global_norm_([p.grad for p in params], 1.0)
            set_lr(state.optimizer, schedule(state.step))
            state.optimizer.step()
            state.step += 1
            ema_update_(state.ema, params, ema_cfg, state.step)
            if state.step % cfg.log_every == 0:
                last = float(loss.detach())
                logf.write(json.dumps({"step": state.step, "loss": last,
                                       "wall_s": round(time.time() - t0, 2)}) + "\n")
                logf.flush()
            if cfg.save_every and state.step % cfg.save_every == 0:
                _save_resume(state, out_dir)
    return state, last


def save_surrogate(state: SurrogateState, results_folder: str, name: str) -> Path:
    """Write the EMA weights to <results_folder>/<name>/params.pt."""
    out = Path(results_folder) / name
    out.mkdir(parents=True, exist_ok=True)
    torch.save(state.ema_state_dict(), out / PARAMS_FILE)
    return out / PARAMS_FILE


def load_surrogate(results_folder: str, name: str, module: torch.nn.Module,
                   device: Optional[torch.device] = None) -> torch.nn.Module:
    """Load surrogate ``name`` into ``module`` (strict) and return it in eval
    mode on ``device`` (default CUDA, see resolve_device): the port's
    <folder>/<name>/params.pt, else a flax-path npz <folder>/<name>.npz of a
    JAX ``UNet2Dv2`` (or ``ForceUNet`` for "force") tree."""
    dev = resolve_device(device)
    base = Path(results_folder)
    path, npz = base / name / PARAMS_FILE, base / f"{name}.npz"
    if path.is_file():
        module.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    elif npz.is_file():
        from diffphycon_tpu_torch.utils import convert

        tree = convert.load_flax_npz(npz)
        (convert.load_flax_force_unet if name == "force" else convert.load_flax_unet2dv2)(
            module, tree)
    elif (base / name).is_dir():
        raise NotImplementedError(
            f"{base / name} holds no {PARAMS_FILE}: a surrogate written by the JAX package "
            "(orbax) cannot be read by the port; export its parameter tree with "
            f"utils/convert.py: save_flax_npz to {npz}")
    else:
        raise FileNotFoundError(f"no surrogate {name!r} under {base}")
    return module.to(dev).eval()
