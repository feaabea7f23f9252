"""Faults planted under the timed path, to show that the correctness check
fails them (the CPU tests at a tiny size; ``control.py --fault`` on the
card at the cell's size). Each patches the port for the duration of a
``with`` block:

- ``unchanged``: a step returns its state unchanged;
- ``half_batch``: half of the batch left out (a sampler or solver step
  leaves the second half of its batch as it was; the training loss is the
  mean over the first half only);
- ``altered``: one value of a step's answer altered where it is produced.

A cell on one chip has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = {"guided_sampling": ("unchanged", "half_batch", "altered"),
          "train": ("unchanged", "half_batch"),
          "rollout": ("unchanged", "half_batch", "altered")}


def _half(new, old):
    h = new.shape[0] // 2
    return torch.cat([new[:h], old[h:].to(new.dtype)], dim=0)


def _altered(out):
    out = out.clone()
    out.view(-1)[0] += 1.0
    return out


@contextlib.contextmanager
def planted(kind: str, fault: str):
    if fault not in FAULTS[kind]:
        raise ValueError(f"no fault {fault!r} for {kind}; one of {FAULTS[kind]}")
    with contextlib.ExitStack() as stack:
        patch = stack.enter_context(_patcher())
        if kind == "guided_sampling":
            from diffphycon_tpu_torch.diffusion.core import GaussianDiffusion as G

            for name in ("ddpm_step", "ddim_step"):
                orig = getattr(G, name)

                def step(self, x, *a, _orig=orig, **k):
                    if fault == "unchanged":
                        return x
                    out = _orig(self, x, *a, **k)
                    return _half(out, x) if fault == "half_batch" else _altered(out)

                patch(G, name, step)
        elif kind == "train":
            from diffphycon_tpu_torch.diffusion.core import GaussianDiffusion as G
            from diffphycon_tpu_torch.training.trainer import Trainer

            if fault == "unchanged":
                patch(Trainer, "apply_gradients", lambda self: None)
            else:
                orig = G.p_losses

                def p_losses(self, x_start, t, cond_vals, noise):
                    h = x_start.shape[0] // 2
                    return orig(self, x_start[:h], t[:h], {k: v[:h] for k, v in cond_vals.items()},
                                noise[:h])

                patch(G, "p_losses", p_losses)
        else:
            from diffphycon_tpu_torch.physics.fluids import smoke_env

            vel, adv = smoke_env.control_step_velocity, smoke_env._advect
            if fault == "unchanged":
                patch(smoke_env, "control_step_velocity", lambda sim, prev, c1, c2: prev)
                patch(smoke_env, "_advect", lambda v, d: d)
            elif fault == "half_batch":
                patch(smoke_env, "control_step_velocity",
                      lambda sim, prev, c1, c2: _half(vel(sim, prev, c1, c2), prev))
                patch(smoke_env, "_advect", lambda v, d: _half(adv(v, d), d))
            else:
                patch(smoke_env, "_advect", lambda v, d: _altered(adv(v, d)))
        yield


@contextlib.contextmanager
def _patcher():
    saved = []

    def patch(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    try:
        yield patch
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)
