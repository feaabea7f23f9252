"""RL environments for the smoke and jellyfish baselines.

Port of ``diffphycon_tpu/baselines/envs.py``:

  SmokeRLEnv      the real 128^2 bucket scenario (``physics.fluids.smoke_env``),
                  batched on one device; the policy sees 64^2 observations
                  and emits control fields that only act on the peripheral
                  ring (indirect control). Every physical sub-step makes one
                  pressure solve: K4 on CUDA, the plain CG on the CPU.
  JellyfishRLEnv  the neural ``SurrogatePipeline`` (force readout,
                  simulator, boundary updater); the action is the per-step
                  theta increment.

Both expose ``reset(...) -> obs``, ``step(action) -> (obs, reward, done)``
and ``metrics()``, the episode J values the inference apps report. The
episode state is a dict of tensors on the env's device; the JAX ``lax.scan``
over sub-steps is a Python loop, and every step runs without autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from diffphycon_tpu_torch.control.metrics import jellyfish_objective
from diffphycon_tpu_torch.device import resolve_device
from diffphycon_tpu_torch.physics.fluids.grids import advect_centered
from diffphycon_tpu_torch.physics.fluids.smoke_env import (
    SmokeSim,
    _bucket_accounting,
    _pad128,
    _smoke_rate,
    control_step_velocity,
)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """(B, 2H, 2W) -> (B, H, W) average pooling."""
    b, h, w = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


def _advect(vel, field):
    return advect_centered(vel, field[..., None])[..., 0]


class SmokeRLEnv:
    """Batched smoke-control episode on the real 128^2 scenario.

    An episode is ``frames`` control decisions, each held for ``sub_steps``
    physical steps. Observations are (B, 64, 64, 4): density, vx, vy (2x
    average-pooled) and the time plane t / frames. Actions are (B, 64, 64,
    2) in [-1, 1], scaled by ``act_scale`` and repeated to 128^2; the
    solver keeps only their peripheral ring.

    The reward of a control frame is the rise of the target bucket's
    smoke-out fraction minus ``w_energy`` x the mean control energy, the
    J_target / J_energy split of the smoke inference."""

    obs_shape = (64, 64, 4)
    action_shape = (64, 64, 2)

    def __init__(self, frames: int = 32, sub_steps: int = 8, act_scale: float = 2.0,
                 w_energy: float = 0.0, accuracy: float = 1e-6, max_iterations: int = 200,
                 device=None):
        self.device = resolve_device(device)
        self.sim = SmokeSim.create(accuracy=accuracy, max_iterations=max_iterations,
                                   device=self.device)
        self.frames = frames
        self.sub_steps = sub_steps
        self.act_scale = act_scale
        self.w_energy = w_energy
        self.state = None

    def _obs(self, density, vel, t: int):
        d = _avg_pool2(_pad128(density))
        tt = torch.full_like(d, t / self.frames)
        return torch.stack([d, _avg_pool2(vel[..., 0]), _avg_pool2(vel[..., 1]), tt], dim=-1)

    def _rate(self, st):
        return _smoke_rate(st["smoke_outs"], _pad128(st["density_zero"]))

    @torch.no_grad()
    def reset(self, batch: int, rng: np.random.Generator,
              density0: Optional[np.ndarray] = None):
        """A 10x10 start box at a random place per element (the draws of the
        JAX env from the same ``rng``) and the uniform 0.8 updraft.
        ``density0`` (B, 128, 128) replaces the boxes (e.g. a dataset's
        initial densities)."""
        if density0 is None:
            d0 = np.zeros((batch, 128, 128), np.float32)
            for i in range(batch):
                sx = int(rng.integers(22, 98))
                sy = int(rng.integers(22, 26))
                d0[i, sy : sy + 10, sx : sx + 10] = 1.0
        else:
            d0 = np.asarray(density0, np.float32)
        density = torch.as_tensor(d0, device=self.device)[:, :-1, :-1]
        vel = torch.zeros(batch, 128, 128, 2, device=self.device)
        vel[..., 1] = 0.8
        dz, outs = _bucket_accounting(self.sim, density,
                                      torch.zeros(batch, 7, device=self.device))
        self.state = {"density": density, "density_zero": dz, "vel": vel, "smoke_outs": outs,
                      "t": 0, "energy": torch.zeros(batch, device=self.device)}
        return self._obs(density, vel, 0)

    @torch.no_grad()
    def step(self, action):
        """action (B, 64, 64, 2) -> (obs, reward (B,), done)."""
        st = self.state
        a = torch.as_tensor(action, dtype=torch.float32, device=self.device)
        a = a.clamp(-1.0, 1.0) * self.act_scale
        c = a.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)  # 64 -> 128
        rate0 = self._rate(st)
        density, dz, vel, outs = st["density"], st["density_zero"], st["vel"], st["smoke_outs"]
        for _ in range(self.sub_steps):
            vel = control_step_velocity(self.sim, vel, c[..., 0], c[..., 1])
            density = _advect(vel, density)
            dz, outs = _bucket_accounting(self.sim, _advect(vel, dz), outs)
        sq = a ** 2
        self.state = {"density": density, "density_zero": dz, "vel": vel, "smoke_outs": outs,
                      "t": st["t"] + 1, "energy": st["energy"] + sq.sum(dim=(1, 2, 3))}
        reward = (self._rate(self.state) - rate0) - self.w_energy * sq.mean(dim=(1, 2, 3))
        done = self.state["t"] >= self.frames
        return self._obs(density, vel, self.state["t"]), reward, done

    def metrics(self):
        """J_target (minus the target bucket's smoke-out fraction),
        smoke_out and J_energy (the summed squared control), batch means."""
        rate = self._rate(self.state)
        return {"J_target": float((-rate).mean()), "smoke_out": float(rate.mean()),
                "J_energy": float(self.state["energy"].mean())}


@dataclasses.dataclass
class JellyfishRLEnv:
    """Jellyfish flapping episode through the neural surrogate pipeline.

    Observation: the (64, 64) state channels, the 3 boundary channels and a
    theta plane, flattened channels-last as the JAX env flattens them (so
    MLP weights carried over from JAX see the same input); with
    ``partially_observed`` the pressure channel alone stands for the state.
    Action: delta theta in [-1, 1] x ``act_scale``, shape (B, 1). Reward:
    the ForceUNet thrust - reg * delta^2."""

    pipeline: object  # benchmarks.jellyfish.SurrogatePipeline
    frames: int = 20
    act_scale: float = 0.1
    reg: float = 1000.0
    partially_observed: bool = False
    device: Optional[object] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.state = None

    def obs_dim(self, n_state: int) -> int:
        ch = (1 if self.partially_observed else n_state) + 3 + 1
        return 64 * 64 * ch

    def _obs(self, state, bd, theta):
        tplane = theta[:, None, None, None].expand_as(state[..., :1])
        fields = state[..., -1:] if self.partially_observed else state
        return torch.cat([fields, bd, tplane], dim=-1).reshape(state.shape[0], -1)

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def reset(self, state0, bd0, theta0):
        """state0 (B, H, W, ns), bd0 (B, H, W, 3), theta0 (B,)."""
        self.state = tuple(self._tensor(a) for a in (state0, bd0, theta0))
        self._t = 0
        self._forces, self._deltas = [], []
        return self._obs(*self.state)

    @torch.no_grad()
    def step(self, action):
        state, bd, theta = self.state
        delta = self._tensor(action)[:, 0].clamp(-1.0, 1.0) * self.act_scale
        state_next, force = self.pipeline.step(state, bd, delta)
        self.state = (state_next, self.pipeline.bd_updater(bd, delta), theta + delta)
        self._t += 1
        self._forces.append(force)
        self._deltas.append(self.state[2] - theta)
        return self._obs(*self.state), force - self.reg * delta ** 2, self._t >= self.frames

    def metrics(self):
        """avg_force, theta_reg (sum of dtheta^2) and J_jellyfish, the
        ``jellyfish_objective`` of the episode, batch means."""
        f = torch.stack(self._forces, 1)  # (B, T)
        d = torch.stack(self._deltas, 1)
        score = jellyfish_objective(f, d, self.reg)
        return {"avg_force": float(f.mean()), "theta_reg": float((d ** 2).sum(1).mean()),
                "J_jellyfish": float(score.mean())}
