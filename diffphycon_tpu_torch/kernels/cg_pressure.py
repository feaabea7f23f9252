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
neighbours 0 or 1). ``cg_pressure.launches`` counts kernel launches (one
per solve). On both routes it adds to the work counters
``solver.cg_iterations`` (the returned iterations) and ``solver.cg_solves``
(the elements solved) while a profiler records (``kernels.count``).

The kernel runs one thread-block cluster of S CTAs per batch element, each
CTA on a band of rows (:func:`cg_cluster_plan` picks S and the bands);
:func:`cg_pressure_cluster_emulated` is its split arithmetic in plain
PyTorch, for the tests.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, NamedTuple

import torch

from diffphycon_tpu_torch.kernels import _build, count

CG_THREADS = 256  # threads per CTA (csrc/cg_pressure.cu: kThreads)
CG_BAND_CELLS = CG_THREADS * 32  # cells a CTA's registers hold (kBandCells)
CG_CLUSTERS = (16, 8, 4)  # CTAs per cluster, largest first (16 is non-portable)


class CgPlan(NamedTuple):
    """K4's launch: S CTAs per batch element, rank q on rows
    ``bands[q] = (q H // S, (q + 1) H // S)``; ``waves`` of resident
    clusters the B elements take."""
    cluster: int
    bands: tuple
    waves: int


def cg_bands(H: int, S: int) -> tuple:
    """Rank q's rows [q H // S, (q + 1) H // S), as the kernel cuts them."""
    return tuple((q * H // S, (q + 1) * H // S) for q in range(S))


def cg_cluster_plan(B: int, H: int, W: int, resident: Callable[[int], int]) -> CgPlan:
    """S for B elements of an (H, W) domain: the largest of CG_CLUSTERS
    whose bands (ceil(H / S) rows of W cells at most) fit a CTA and for which
    all B clusters are resident at once (one wave); where none is, the
    smallest S the card can hold (the most clusters per wave), in more
    waves. ``resident(S)``: clusters of S CTAs the card holds at once
    (``cudaOccupancyMaxActiveClusters``, queried once per shape and S on
    the card; the tests pass their own numbers)."""
    fits = [S for S in CG_CLUSTERS if S <= H and math.ceil(H / S) * W <= CG_BAND_CELLS]
    if not fits:
        raise ValueError(f"cg_pressure: a {H}x{W} domain does not fit the kernel: it takes "
                         f"at least {min(CG_CLUSTERS)} rows and bands of ceil(H / S) rows "
                         f"of at most {CG_BAND_CELLS} cells, S in {CG_CLUSTERS}")
    held = {S: resident(S) for S in fits}
    usable = [S for S in fits if held[S] > 0]
    if not usable:
        raise ValueError(f"cg_pressure: the card holds no cluster of {fits} CTAs")
    S = next((S for S in usable if B <= held[S]), usable[-1])
    return CgPlan(S, cg_bands(H, S), math.ceil(B / held[S]))


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


def cg_pressure_cluster_emulated(div: torch.Tensor, coeffs, accuracy: float,
                                 max_iterations: int, ranks: int):
    """The per-element CG as K4 splits it, in plain PyTorch: each element's
    rows cut into the `ranks` bands of :func:`cg_cluster_plan`, every dot
    product and max|r| taken per band and the band partials then summed in
    rank order (the kernel's halo rows, r + b p of the neighbour band's
    edge, are the values the neighbour computes, so the field is updated
    whole here). (p, iterations (B,) int32). For the tests."""
    bands = cg_bands(div.shape[1], ranks)

    def split(v, maximum=False):  # (B, H, W) -> (B,): per band, then the bands in order
        total = None
        for r0, r1 in bands:
            part = v[:, r0:r1].amax(dim=(1, 2)) if maximum else v[:, r0:r1].sum(dim=(1, 2))
            total = part if total is None else (torch.maximum(total, part) if maximum
                                                else total + part)
        return total

    def dot(a, b):
        return split(a * b)

    x = torch.zeros_like(div)
    r = div.clone()
    p = div.clone()
    ap = masked_laplacian(p, coeffs)
    pap, pr = dot(p, ap), dot(p, r)
    rmax = split(r.abs(), maximum=True)
    iters = torch.zeros(div.shape[0], dtype=torch.int32, device=div.device)
    for _ in range(max_iterations):
        active = rmax >= accuracy
        if not bool(active.any()):
            break
        act = active[:, None, None]
        a = pr / pap
        x = torch.where(act, x + a[:, None, None] * p, x)
        r = torch.where(act, r - a[:, None, None] * ap, r)
        rmax = torch.where(active, split(r.abs(), maximum=True), rmax)
        b = -dot(r, ap) / pap
        p = torch.where(act, torch.addcmul(r, b[:, None, None], p), p)
        ap = masked_laplacian(p, coeffs)
        pap = torch.where(active, dot(p, ap), pap)
        pr = torch.where(active, dot(p, r), pr)
        iters += active.to(torch.int32)
    return x, iters


@functools.lru_cache(maxsize=None)
def _resident(H: int, W: int, S: int) -> int:
    """Clusters of S CTAs of an (H, W) solve the card holds at once."""
    n = ctypes.c_int(0)
    err = _build.load_library().cg_cluster_occupancy(H, W, S, ctypes.byref(n))
    _build.check(err, "cg_pressure (cudaOccupancyMaxActiveClusters)")
    return n.value


@functools.lru_cache(maxsize=None)
def _plan(B: int, H: int, W: int) -> CgPlan:
    return cg_cluster_plan(B, H, W, functools.partial(_resident, H, W))


def cg_launch(div: torch.Tensor, packed: torch.Tensor, accuracy: float, max_iterations: int,
              cluster: int):
    """One K4 launch with clusters of `cluster` CTAs, on checked inputs;
    counts nothing (``tools/sweep_cg_cluster.py`` forces S through it)."""
    B, H, W = div.shape
    out = torch.empty_like(div)
    iters = torch.empty(B, dtype=torch.int32, device=div.device)
    err = _build.load_library().cg_pressure_f32(
        div.data_ptr(), packed.data_ptr(), out.data_ptr(), iters.data_ptr(), B, H, W,
        float(accuracy), int(max_iterations), cluster,
        torch.cuda.current_stream(div.device).cuda_stream)
    _build.check(err, "cg_pressure")
    return out, iters


def cg_pressure(div: torch.Tensor, coeffs, accuracy: float = 1e-8,
                max_iterations: int = 500):
    """K4. div: (B, H, W) float32; coeffs: five (H, W) fields. Returns
    (p (B, H, W), iterations (B,) int32). On CUDA the domain needs at least
    4 rows and bands of ceil(H / S) rows of at most 8192 cells for some S
    in (4, 8, 16): every domain of up to 16384 cells with 4 rows or more,
    and up to 131072 cells in 16 bands."""
    if div.device.type == "cpu":
        out, iters = cg_pressure_plain(div, coeffs, accuracy, max_iterations)
    else:
        out, iters = _cg_cuda(div, coeffs, accuracy, max_iterations)
    count("solver.cg_iterations", iters)
    count("solver.cg_solves", div.shape[0])
    return out, iters


def _cg_cuda(div, coeffs, accuracy, max_iterations):
    """cg_pressure's CUDA route: the checks, then one K4 launch."""
    if div.device.type != "cuda":
        raise ValueError(f"cg_pressure: no kernel or plain path for device {div.device}")
    if div.dtype != torch.float32:
        raise TypeError(f"cg_pressure: div has dtype {div.dtype}; the kernel takes float32")
    if div.dim() != 3 or not div.is_contiguous():
        raise ValueError(f"cg_pressure: div must be a contiguous (B, H, W) tensor, "
                         f"got {tuple(div.shape)}")
    B, H, W = div.shape
    if any(c.shape != (H, W) for c in coeffs):
        raise ValueError(f"cg_pressure: coefficient fields must be ({H}, {W})")
    packed = pack_coeffs(coeffs)
    if packed.device != div.device:
        raise ValueError(f"cg_pressure: coefficients on {packed.device}, div on {div.device}")
    if B == 0:
        return torch.empty_like(div), torch.empty(0, dtype=torch.int32, device=div.device)
    out, iters = cg_launch(div, packed, accuracy, max_iterations, _plan(B, H, W).cluster)
    cg_pressure.launches += 1
    return out, iters


cg_pressure.launches = 0
