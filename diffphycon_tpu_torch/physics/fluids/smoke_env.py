"""The 2D smoke indirect-control scenario, batched on one device.

Port of ``diffphycon_tpu/physics/fluids/smoke_env.py``: a 127x127-cell
domain (staggered velocity 128x128) with the pi-maze obstacle walls and 7
exit buckets. Each frame the control (c1, c2) is written into the
peripheral ring only (indirect control), the velocity is projected
divergence-free (one K4 solve per frame), the densities are advected
semi-Lagrangian, and the per-bucket smoke-out mass is accumulated and those
cells zeroed. The JAX ``lax.scan`` is a Python loop here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from diffphycon_tpu_torch.device import resolve_device
from diffphycon_tpu_torch.physics.fluids.grids import advect_centered
from diffphycon_tpu_torch.physics.fluids.pressure import FluidDomain, divergence_free
from diffphycon_tpu_torch.utils.profiling import span


def obstacles_128():
    """(y, x, size_y, size_x) rectangles of the 128 scenario."""
    return [
        (16, 16, 1, 96),          # bottom
        (16, 16, 8, 1),           # left down
        (40, 16, 16, 1),          # left medium
        (72, 16, 40, 1),          # left up
        (16, 112, 8, 1),          # right down
        (40, 112, 16, 1),         # right medium
        (72, 112, 40, 1),         # right up
        (112, 16, 1, 8),          # buckets
        (112, 40, 1, 16),
        (112, 72, 1, 16),
        (112, 104, 1, 8),
        (64, 48, 16, 1),          # y-axis obstacles
        (96, 48, 16, 1),
        (64, 80, 16, 1),
        (96, 80, 16, 1),
        (40, 40, 1, 128 - 80),    # x-axis
    ]


def smoke_domain_128() -> FluidDomain:
    """127x127 open-boundary domain with the pi-maze obstacles."""
    return FluidDomain.from_obstacles((127, 127), obstacles_128(), open_boundary=True)


def obstacles_64():
    """The half-resolution scenario."""
    return [
        (8, 8, 1, 48),
        (8, 8, 4, 1),
        (20, 8, 8, 1),
        (36, 8, 20, 1),
        (8, 56, 4, 1),
        (20, 56, 8, 1),
        (36, 56, 20, 1),
        (56, 8, 1, 4),
        (56, 20, 1, 8),
        (56, 36, 1, 8),
        (56, 52, 1, 4),
        (32, 24, 8, 1),
        (48, 24, 8, 1),
        (32, 40, 8, 1),
        (48, 40, 8, 1),
        (20, 20, 1, 64 - 40),
    ]


def smoke_domain_64() -> FluidDomain:
    return FluidDomain.from_obstacles((63, 63), obstacles_64(), open_boundary=True)


def bucket_masks() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """7 bucket masks, their union and the keep-mask: (cal_smoke (7, 128,
    128), concat (128, 128), keep (128, 128)). Bucket 1 (top middle exit) is
    the control target."""
    bucket_pos = [(112, 22, 15, 20), (112, 54, 15, 20), (112, 86, 15, 20)]
    bucket_pos_y = [(22, 0, 20, 16), (54, 0, 20, 16),
                    (22, 112, 20, 15), (54, 112, 20, 15)]
    cal_list = []
    keep = np.ones((128, 128), np.float32)
    concat = np.zeros((128, 128), np.float32)
    for y, x, ly, lx in bucket_pos + bucket_pos_y:
        m = np.zeros((128, 128), np.float32)
        m[y : y + ly, x : x + lx] = 1
        concat[y : y + ly, x : x + lx] = 1
        keep[y : y + ly, x : x + lx] = 0
        cal_list.append(m)
    return np.stack(cal_list), concat, keep


@dataclasses.dataclass(frozen=True)
class SmokeSim:
    """Static data of the 128^2 smoke simulation, as tensors on one device."""

    coeffs: tuple
    velocity_mask: torch.Tensor  # (128, 128, 2)
    cal_smoke: torch.Tensor      # (7, 128, 128)
    keep: torch.Tensor           # (128, 128)
    accuracy: float = 1e-8
    max_iterations: int = 500

    @classmethod
    def create(cls, accuracy: float = 1e-8, max_iterations: int = 500, device=None):
        dev = resolve_device(device)
        dom = smoke_domain_128()
        cal, _, keep = bucket_masks()
        return cls(coeffs=dom.laplacian_coeffs(dev), velocity_mask=dom.velocity_mask(dev),
                   cal_smoke=torch.as_tensor(cal, device=dev),
                   keep=torch.as_tensor(keep, device=dev),
                   accuracy=accuracy, max_iterations=max_iterations)


def controlled_velocity(prev_stag: torch.Tensor, c1: torch.Tensor,
                        c2: torch.Tensor) -> torch.Tensor:
    """The velocity before projection: the control on the peripheral ring,
    the previous velocity in the interior [16:112)^2 (indirect control).

    prev_stag: (B, 128, 128, 2); c1, c2: (B, 128, 128)."""
    cur = torch.stack([c1, c2], dim=-1).clone()
    cur[:, 16:112, 16:112, :] = prev_stag[:, 16:112, 16:112, :]
    return cur


def control_step_velocity(sim: SmokeSim, prev_stag: torch.Tensor, c1: torch.Tensor,
                          c2: torch.Tensor) -> torch.Tensor:
    """One control + projection step (one pressure solve)."""
    vel = divergence_free(controlled_velocity(prev_stag, c1, c2), None,
                          coeffs=sim.coeffs, velocity_mask=sim.velocity_mask,
                          accuracy=sim.accuracy, max_iterations=sim.max_iterations)
    return vel * sim.velocity_mask[None]


def _bucket_accounting(sim: SmokeSim, density127: torch.Tensor, smoke_outs: torch.Tensor):
    """Add each bucket's mass to smoke_outs (B, 7) and zero those cells.
    density127: (B, 127, 127)."""
    d128 = F.pad(density127, (0, 1, 0, 1))
    smoke_outs = smoke_outs + torch.einsum("byx,kyx->bk", d128, sim.cal_smoke)
    return density127 * sim.keep[None, :-1, :-1], smoke_outs


def _pad128(d):
    return F.pad(d, (0, 1, 0, 1))


def _smoke_rate(smoke_outs, dz128):
    return smoke_outs[:, 1] / (smoke_outs.sum(-1) + dz128.sum((-1, -2)))


def _advect(vel, density):
    with span("solver.advect"):
        return advect_centered(vel, density[..., None])[..., 0]


def smoke_solver(sim: SmokeSim, init_velocity: torch.Tensor, init_density: torch.Tensor,
                 c1: torch.Tensor, c2: torch.Tensor, num_t: int = 256) -> dict:
    """Full scenario rollout: num_t - 1 control steps.

    init_velocity: (B, 128, 128, 2) staggered; init_density: (B, nx, nx)
    (upsampled to 128); c1, c2: (B, nt, nx, nx), repeated to (num_t, 128,
    128). Returns densitys, zero_densitys (B, num_t, 128, 128), velocitys
    (B, num_t, 128, 128, 2), smoke_out_record (B, num_t), bucket_mass
    (B, num_t, 7) and smoke_outs (B, 7)."""
    b, nt, nx, _ = c1.shape
    t_rep, s_rep = num_t // nt, 128 // nx

    def up_s(a):
        return a.repeat_interleave(s_rep, -2).repeat_interleave(s_rep, -1)

    density = up_s(init_density)[:, :-1, :-1]
    c1 = up_s(c1).repeat_interleave(t_rep, dim=1)
    c2 = up_s(c2).repeat_interleave(t_rep, dim=1)
    smoke_outs = torch.zeros(b, 7, dtype=torch.float32, device=density.device)
    vel = init_velocity
    density_zero, smoke_outs = _bucket_accounting(sim, density, smoke_outs)

    def record(density, density_zero, vel, smoke_outs):
        dz = _pad128(density_zero)
        return (_pad128(density), dz, vel, _smoke_rate(smoke_outs, dz), smoke_outs)

    recs = [record(density, density_zero, vel, smoke_outs)]
    for t in range(num_t - 1):
        with span("solver.frame"):
            vel = control_step_velocity(sim, vel, c1[:, t], c2[:, t])
            density = _advect(vel, density)
            density_zero, smoke_outs = _bucket_accounting(sim, _advect(vel, density_zero),
                                                          smoke_outs)
            recs.append(record(density, density_zero, vel, smoke_outs))

    def stack(i):
        return torch.stack([r[i] for r in recs], dim=1)

    return {"densitys": stack(0), "zero_densitys": stack(1), "velocitys": stack(2),
            "smoke_out_record": stack(3), "bucket_mass": stack(4),
            "smoke_outs": smoke_outs}


NoiseFn = Callable[[int], Tuple[torch.Tensor, torch.Tensor]]


def generator_rollout(sim: SmokeSim, init_density: torch.Tensor, seg_v: torch.Tensor,
                      seg_starts: torch.Tensor, initial_vy: float = 0.8,
                      num_steps: int = 256, generator: Optional[torch.Generator] = None,
                      noise: Optional[NoiseFn] = None) -> dict:
    """Data-generation rollout with the reference generator's control
    semantics:

    - at a segment-start frame t in seg_starts the control is a fresh
      per-cell draw N(v_seg, |v_seg|/10) over the whole 128^2 field;
    - at every other frame it is the previous projected velocity plus
      per-cell N(0, 0.1) noise;
    - either way only the peripheral ring is kept; the initial velocity is
      the uniform updraft (0, initial_vy).

    init_density: (B, 128, 128); seg_v: (B, 4, 2) per-segment (vx, vy);
    seg_starts: (B, 4) int frame indices. The two standard-normal draws of
    frame t, each (B, 128, 128, 2), come from ``noise(t)`` when given
    (the tests feed JAX's draws), else from ``generator``.

    Returns the smoke_solver dict (without smoke_out_record) plus controls
    (B, num_steps, 128, 128, 2), the ring controls that were applied."""
    if (generator is None) == (noise is None):
        raise ValueError("generator_rollout: pass exactly one of generator / noise")
    dev = init_density.device
    b = init_density.shape[0]
    density = init_density[:, :-1, :-1]
    smoke_outs = torch.zeros(b, 7, dtype=torch.float32, device=dev)
    vel = torch.zeros(b, 128, 128, 2, dtype=torch.float32, device=dev)
    vel[..., 1] = initial_vy
    density_zero, smoke_outs = _bucket_accounting(sim, density, smoke_outs)
    ring = torch.zeros(128, 128, 1, dtype=torch.float32, device=dev)
    ring[:, :16] = 1.0
    ring[:, 112:] = 1.0
    ring[112:, :] = 1.0
    ring[:16, :] = 1.0
    seg_starts = seg_starts.to(dev)
    seg_v = seg_v.to(dev)

    def draws(t):
        if noise is not None:
            return noise(t)
        shape = (b, 128, 128, 2)
        return (torch.randn(shape, generator=generator, device=dev),
                torch.randn(shape, generator=generator, device=dev))

    recs = [(_pad128(density), _pad128(density_zero), vel, smoke_outs)]
    controls = []
    for t in range(num_steps):
        seg_idx = ((t >= seg_starts).sum(-1) - 1).clamp(0, 3)              # (B,)
        v_seg = torch.gather(seg_v, 1, seg_idx[:, None, None].expand(b, 1, 2))[:, 0]
        fresh_noise, carry_noise = draws(t)
        v4 = v_seg[:, None, None, :]
        fresh = v4 + fresh_noise * v4.abs() / 10.0
        carried = vel + carry_noise * 0.1
        is_fresh = (seg_starts == t).any(-1)[:, None, None, None]
        ctrl = torch.where(is_fresh, fresh, carried) * ring[None]
        vel = control_step_velocity(sim, vel, ctrl[..., 0], ctrl[..., 1])
        density = _advect(vel, density)
        density_zero, smoke_outs = _bucket_accounting(sim, _advect(vel, density_zero),
                                                      smoke_outs)
        recs.append((_pad128(density), _pad128(density_zero), vel, smoke_outs))
        controls.append(ctrl)

    def stack(i):
        return torch.stack([r[i] for r in recs], dim=1)

    return {"densitys": stack(0), "zero_densitys": stack(1), "velocitys": stack(2),
            "bucket_mass": stack(3), "controls": torch.stack(controls, dim=1),
            "smoke_outs": smoke_outs}
