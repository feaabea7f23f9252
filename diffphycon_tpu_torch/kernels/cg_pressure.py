"""K4: the whole conjugate-gradient pressure solve, and its plain version.

The port of ``diffphycon_tpu/physics/fluids/pallas_cg.py`` (``_cg_kernel``
:30, launched by ``pallas_solve_pressure`` :81). Solves A p = div for a
batch of (H, W) fields, A the masked 5-point Laplacian given by five
coefficient fields ``(center, up_y, lo_y, up_x, lo_x)``
(``physics/fluids/pressure.py: FluidDomain.laplacian_coeffs``), with the
reference's CG variant: ``b = -sum(r_new * Ap) / sum(p * Ap)``, and the
loop condition ``max|r| >= accuracy and i < max_iterations`` tested before
each body.

Termination is per batch element, as in the Pallas kernel (one grid program
per element); the JAX ``_cg`` while_loop stops on the batch-wide max|r|
instead. Both routes here return each element's iteration count.

:func:`cg_pressure` dispatches on the device of ``div``: a CPU tensor goes to
:func:`cg_pressure_plain`, a CUDA tensor to the kernel
(``csrc/cg_pressure.cu``), which raises on what it cannot take. The kernel
reads the coefficients packed one byte per cell (:func:`pack_coeffs`), so it
takes only the integer coefficients a FluidDomain produces (centre -1..-4,
neighbours 0 or 1). ``cg_pressure.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from diffphycon_tpu_torch.kernels import _build

_THREADS = 1024
_MAX_CELLS = _THREADS * 16  # cells per block the kernel's registers hold


class LaplacianCoeffs(tuple):
    """The five stencil fields ``(center, up_y, lo_y, up_x, lo_x)``, (H, W)
    float32 each, with their one-byte packing for K4 in ``packed`` (None
    until :func:`pack_coeffs` makes it)."""

    def __new__(cls, fields, packed=None):
        obj = super().__new__(cls, tuple(fields))
        obj.packed = packed
        return obj


def masked_laplacian(p: torch.Tensor, coeffs) -> torch.Tensor:
    """A @ p for (B, H, W) fields as a masked 5-point stencil."""
    center, up_y, lo_y, up_x, lo_x = coeffs
    out = center * p
    out[:, :-1, :] += up_y[:-1, :] * p[:, 1:, :]
    out[:, 1:, :] += lo_y[1:, :] * p[:, :-1, :]
    out[:, :, :-1] += up_x[:, :-1] * p[:, :, 1:]
    out[:, :, 1:] += lo_x[:, 1:] * p[:, :, :-1]
    return out


def cg_pressure_plain(div: torch.Tensor, coeffs, accuracy: float,
                      max_iterations: int):
    """The same per-element CG in torch ops: (p (B, H, W), iterations (B,)
    int32). An element that has met its condition keeps its state while the
    others iterate. One host sync per iteration (the loop test)."""
    def bsum(a):
        return a.sum(dim=(1, 2), keepdim=True)

    x = torch.zeros_like(div)
    p = div.clone()
    r = div.clone()
    ap = masked_laplacian(p, coeffs)
    iters = torch.zeros(div.shape[0], dtype=torch.int32, device=div.device)
    zero = torch.zeros((), dtype=div.dtype, device=div.device)
    for _ in range(max_iterations):
        active = r.abs().amax(dim=(1, 2)) >= accuracy
        if not bool(active.any()):
            break
        act = active[:, None, None]
        tmp = bsum(p * ap)
        a = torch.where(act, bsum(p * r) / tmp, zero)
        x = x + a * p
        r = r - a * ap
        b = -bsum(r * ap) / tmp
        p = torch.where(act, r + b * p, p)
        ap = masked_laplacian(p, coeffs)
        iters += active.to(torch.int32)
    return x, iters


def pack_coeffs(coeffs) -> torch.Tensor:
    """(H, W) uint8 of the stencil: bit 0 up_y (y+1), bit 1 lo_y (y-1),
    bit 2 up_x (x+1), bit 3 lo_x (x-1), bits 4-6 the negated centre. The
    neighbours that fall outside the grid are dropped, as in
    :func:`masked_laplacian`. Raises unless every neighbour coefficient is 0
    or 1 and every centre -1, -2, -3 or -4."""
    if getattr(coeffs, "packed", None) is not None:
        return coeffs.packed
    center, up_y, lo_y, up_x, lo_x = (c.detach().to(torch.float32) for c in coeffs)
    up_y, lo_y, up_x, lo_x = (c.clone() for c in (up_y, lo_y, up_x, lo_x))
    up_y[-1, :] = 0.0
    lo_y[0, :] = 0.0
    up_x[:, -1] = 0.0
    lo_x[:, 0] = 0.0
    nbrs = torch.stack([up_y, lo_y, up_x, lo_x])
    if not bool(((nbrs == 0) | (nbrs == 1)).all()):
        raise ValueError("cg_pressure: the kernel takes neighbour coefficients "
                         "of 0 or 1 only")
    if not bool(((center == -1) | (center == -2) | (center == -3)
                 | (center == -4)).all()):
        raise ValueError("cg_pressure: the kernel takes centre coefficients "
                         "of -1, -2, -3 or -4 only")
    code = (up_y + 2 * lo_y + 4 * up_x + 8 * lo_x - 16 * center)
    packed = code.to(torch.uint8).contiguous()
    if isinstance(coeffs, LaplacianCoeffs):
        coeffs.packed = packed
    return packed


def cg_pressure(div: torch.Tensor, coeffs, accuracy: float = 1e-8,
                max_iterations: int = 500):
    """K4. div: (B, H, W) float32; coeffs: five (H, W) fields. Returns
    (p (B, H, W), iterations (B,) int32)."""
    if div.device.type == "cpu":
        return cg_pressure_plain(div, coeffs, accuracy, max_iterations)
    if div.device.type != "cuda":
        raise ValueError(f"cg_pressure: no kernel or plain path for device {div.device}")
    if div.dtype != torch.float32:
        raise TypeError(f"cg_pressure: div has dtype {div.dtype}; the kernel takes float32")
    if div.dim() != 3 or not div.is_contiguous():
        raise ValueError(f"cg_pressure: div must be a contiguous (B, H, W) tensor, "
                         f"got {tuple(div.shape)}")
    B, H, W = div.shape
    if H * W > _MAX_CELLS:
        raise ValueError(f"cg_pressure: {H}x{W} cells exceed the kernel's "
                         f"{_MAX_CELLS} per block")
    if any(c.shape != (H, W) for c in coeffs):
        raise ValueError(f"cg_pressure: coefficient fields must be ({H}, {W})")
    packed = pack_coeffs(coeffs)
    if packed.device != div.device:
        raise ValueError(f"cg_pressure: coefficients on {packed.device}, div on {div.device}")
    out = torch.empty_like(div)
    iters = torch.empty(B, dtype=torch.int32, device=div.device)
    if B == 0:
        return out, iters
    lib = _build.load_library()
    err = lib.cg_pressure_f32(div.data_ptr(), packed.data_ptr(), out.data_ptr(),
                              iters.data_ptr(), B, H, W, float(accuracy),
                              int(max_iterations),
                              torch.cuda.current_stream(div.device).cuda_stream)
    _build.check(err, "cg_pressure")
    cg_pressure.launches += 1
    return out, iters


cg_pressure.launches = 0
