"""Obstacle-aware pressure projection: matrix-free Laplacian + CG.

Port of ``diffphycon_tpu/physics/fluids/pressure.py``. The Laplacian is a
masked 5-point stencil over (B, H, W) pressure fields; the solve is K4
(:func:`kernels.cg_pressure.cg_pressure`: the CUDA kernel for a CUDA tensor,
its plain version for a CPU one, in place of ``default_use_pallas``). The
backward of :func:`solve_pressure_cg` is the same solve on the incoming
gradient, because A is symmetric (the JAX ``custom_vjp``).

Stencil (sparse_pressure_matrix of the reference):
  coeff_upper[i] = active[i+1] * active[i], coeff_lower[i] = active[i-1] *
  active[i] (dropped out of range), centre = min(-sum of the four fluid
  neighbours, -1), with active padded by 0 and fluid by 1 (open) or 0
  (closed) at the domain boundary.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from diffphycon_tpu_torch.device import resolve_device
from diffphycon_tpu_torch.kernels.cg_pressure import (
    LaplacianCoeffs,
    cg_pressure,
    masked_laplacian,
    pack_coeffs,
)
from diffphycon_tpu_torch.physics.fluids.grids import (
    staggered_divergence,
    staggered_gradient,
)
from diffphycon_tpu_torch.utils.profiling import span

__all__ = ["FluidDomain", "LaplacianCoeffs", "divergence_free", "masked_laplacian",
           "solve_pressure_cg"]


@dataclasses.dataclass(frozen=True)
class FluidDomain:
    """Static masks of a simulation domain: active / fluid (H, W) float
    arrays (1 = fluid cell, 0 = obstacle); open_boundary pads fluid with 1
    (open) or 0 (closed)."""

    active: np.ndarray
    fluid: np.ndarray
    open_boundary: bool = True

    @classmethod
    def from_obstacles(cls, shape: Tuple[int, int],
                       obstacles: Sequence[Tuple[int, int, int, int]],
                       open_boundary: bool = True) -> "FluidDomain":
        """obstacles: (y, x, size_y, size_x) rectangles."""
        mask = np.ones(shape, np.float32)
        for y, x, sy, sx in obstacles:
            mask[y : y + sy, x : x + sx] = 0.0
        return cls(active=mask.copy(), fluid=mask.copy(), open_boundary=open_boundary)

    def _pad_val(self) -> float:
        return 1.0 if self.open_boundary else 0.0

    def laplacian_coeffs(self, device=None) -> LaplacianCoeffs:
        """The five stencil fields (center, up_y, lo_y, up_x, lo_x), (H, W)
        float32 on ``device``, packed for K4 once here."""
        act = np.pad(self.active, 1, constant_values=0.0)
        fld = np.pad(self.fluid, 1, constant_values=self._pad_val())
        c = act[1:-1, 1:-1]
        up_y = act[2:, 1:-1] * c
        lo_y = act[:-2, 1:-1] * c
        up_x = act[1:-1, 2:] * c
        lo_x = act[1:-1, :-2] * c
        center = -(fld[2:, 1:-1] + fld[:-2, 1:-1] + fld[1:-1, 2:] + fld[1:-1, :-2])
        center = np.minimum(center, -1.0)
        up_y[-1, :] = 0.0
        lo_y[0, :] = 0.0
        up_x[:, -1] = 0.0
        lo_x[:, 0] = 0.0
        dev = resolve_device(device)
        fields = [torch.as_tensor(np.asarray(a, np.float32), device=dev)
                  for a in (center, up_y, lo_y, up_x, lo_x)]
        coeffs = LaplacianCoeffs(fields)
        pack_coeffs(coeffs)
        return coeffs

    def velocity_mask(self, device=None) -> torch.Tensor:
        """Staggered velocity mask (H+1, W+1, 2): a face is open iff both
        adjacent cells are fluid (channel 0 = x, 1 = y)."""
        fld = np.pad(self.fluid, 1, constant_values=self._pad_val())
        upper = fld[1:, 1:]
        mask_y = np.minimum(upper, fld[:-1, 1:])
        mask_x = np.minimum(upper, fld[1:, :-1])
        stag = np.stack([mask_x, mask_y], axis=-1).astype(np.float32)
        return torch.as_tensor(stag, device=resolve_device(device))


class _SolvePressure(torch.autograd.Function):
    @staticmethod
    def forward(ctx, div, coeffs, accuracy, max_iterations):
        ctx.coeffs, ctx.accuracy, ctx.max_iterations = coeffs, accuracy, max_iterations
        p, _ = cg_pressure(div.contiguous(), coeffs, accuracy, max_iterations)
        return p

    @staticmethod
    def backward(ctx, g):
        gp, _ = cg_pressure(g.contiguous(), ctx.coeffs, ctx.accuracy, ctx.max_iterations)
        return gp, None, None, None


def solve_pressure_cg(div: torch.Tensor, coeffs, accuracy: float = 1e-8,
                      max_iterations: int = 500) -> torch.Tensor:
    """Solve A p = div for pressure: (B, H, W) -> (B, H, W). Differentiable
    in div; the gradient is the CG solve of the adjoint (= the same) system."""
    with span("solver.pressure"):
        return _SolvePressure.apply(div, coeffs, accuracy, max_iterations)


def divergence_free(stag: torch.Tensor, domain: Optional[FluidDomain], coeffs=None,
                    velocity_mask: Optional[torch.Tensor] = None,
                    accuracy: float = 1e-8, max_iterations: int = 500) -> torch.Tensor:
    """Project a staggered velocity (B, H+1, W+1, 2) to its divergence-free
    part: v <- mask(v); p = CG(div v); v <- v - mask(grad p)."""
    if coeffs is None:
        coeffs = domain.laplacian_coeffs(stag.device)
    if velocity_mask is None:
        velocity_mask = domain.velocity_mask(stag.device)
    stag = stag * velocity_mask[None]
    div = staggered_divergence(stag)[..., 0]
    p = solve_pressure_cg(div, coeffs, accuracy, max_iterations)
    return stag - staggered_gradient(p[..., None]) * velocity_mask[None]
