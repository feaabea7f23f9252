"""Plain reference of one frame of the 2D smoke solver (128^2, pi-maze).

A frame, as DiffPhyCon's smoke scenario defines it (phiflow's indirect
control): the control written into the peripheral ring of the staggered
velocity (the interior [16, 112)^2 keeps the previous velocity), the
velocity masked by the obstacles and projected divergence-free (pressure
from conjugate gradients on the obstacle-masked 5-point Laplacian, until
the largest residual is under the configuration's accuracy), the density
and the zero-density advected semi-Lagrangian (bilinear, zero outside),
and the smoke that reaches each of the 7 exit buckets counted and removed.
Plain torch in the dtype of its inputs (float32 as configured; the
control runs it in bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

OBSTACLES_128 = [  # (y, x, size_y, size_x)
    (16, 16, 1, 96), (16, 16, 8, 1), (40, 16, 16, 1), (72, 16, 40, 1),
    (16, 112, 8, 1), (40, 112, 16, 1), (72, 112, 40, 1),
    (112, 16, 1, 8), (112, 40, 1, 16), (112, 72, 1, 16), (112, 104, 1, 8),
    (64, 48, 16, 1), (96, 48, 16, 1), (64, 80, 16, 1), (96, 80, 16, 1),
    (40, 40, 1, 48),
]
BUCKETS = [(112, 22, 15, 20), (112, 54, 15, 20), (112, 86, 15, 20),
           (22, 0, 20, 16), (54, 0, 20, 16), (22, 112, 20, 15), (54, 112, 20, 15)]


class Domain:
    """Masks and stencil of the 127^2-cell open-boundary domain."""

    def __init__(self, device, dtype=torch.float32):
        fluid = np.ones((127, 127), np.float32)
        for y, x, sy, sx in OBSTACLES_128:
            fluid[y:y + sy, x:x + sx] = 0.0
        act = np.pad(fluid, 1, constant_values=0.0)
        fld = np.pad(fluid, 1, constant_values=1.0)  # open boundary
        c = act[1:-1, 1:-1]
        up_y, lo_y = act[2:, 1:-1] * c, act[:-2, 1:-1] * c
        up_x, lo_x = act[1:-1, 2:] * c, act[1:-1, :-2] * c
        center = np.minimum(-(fld[2:, 1:-1] + fld[:-2, 1:-1] + fld[1:-1, 2:] + fld[1:-1, :-2]),
                            -1.0)
        up_y[-1, :] = 0.0
        lo_y[0, :] = 0.0
        up_x[:, -1] = 0.0
        lo_x[:, 0] = 0.0

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device).to(dtype)

        self.stencil = [t(a) for a in (center, up_y, lo_y, up_x, lo_x)]
        upper = fld[1:, 1:]
        self.vmask = t(np.stack([np.minimum(upper, fld[1:, :-1]),
                                 np.minimum(upper, fld[:-1, 1:])], axis=-1))
        cal = np.zeros((7, 128, 128), np.float32)
        keep = np.ones((128, 128), np.float32)
        for k, (y, x, ly, lx) in enumerate(BUCKETS):
            cal[k, y:y + ly, x:x + lx] = 1.0
            keep[y:y + ly, x:x + lx] = 0.0
        self.cal, self.keep = t(cal), t(keep)

    def laplacian(self, p):
        center, up_y, lo_y, up_x, lo_x = self.stencil
        out = center * p
        out[:, :-1, :] += up_y[:-1, :] * p[:, 1:, :]
        out[:, 1:, :] += lo_y[1:, :] * p[:, :-1, :]
        out[:, :, :-1] += up_x[:, :-1] * p[:, :, 1:]
        out[:, :, 1:] += lo_x[:, 1:] * p[:, :, :-1]
        return out


def conjugate_gradient(dom: Domain, rhs, accuracy: float, max_iterations: int):
    """Solve A p = rhs per batch element until max |r| < accuracy."""
    def dot(a, b):
        return (a * b).sum(dim=(1, 2), keepdim=True)

    x = torch.zeros_like(rhs)
    r = rhs.clone()
    d = rhs.clone()
    for _ in range(max_iterations):
        live = (r.abs().amax(dim=(1, 2), keepdim=True) >= accuracy)
        if not bool(live.any()):
            break
        ad = dom.laplacian(d)
        dad = dot(d, ad)
        alpha = torch.where(live, dot(d, r) / dad, torch.zeros_like(dad))
        x = x + alpha * d
        r = r - alpha * ad
        beta = -dot(r, ad) / dad
        d = torch.where(live, r + beta * d, d)
    return x


def project(dom: Domain, stag, accuracy, max_iterations):
    """Divergence-free part of a staggered velocity (B, 128, 128, 2)."""
    v = stag * dom.vmask
    div = (v[:, 1:, :-1, 1] - v[:, :-1, :-1, 1]) + (v[:, :-1, 1:, 0] - v[:, :-1, :-1, 0])
    p = conjugate_gradient(dom, div, accuracy, max_iterations)
    f = torch.cat([p[:, :1], p, p[:, -1:]], dim=1)  # symmetric padding by one
    f = torch.cat([f[:, :, :1], f, f[:, :, -1:]], dim=2)
    grad = torch.stack([f[:, 1:, 1:] - f[:, 1:, :-1], f[:, 1:, 1:] - f[:, :-1, 1:]], dim=-1)
    return (v - grad * dom.vmask) * dom.vmask


def advect(stag, field):
    """Semi-Lagrangian advection of a centred field (B, 127, 127) by the
    velocity at the cell centres, bilinear, 0 outside the domain."""
    b, h, w = field.shape
    vy = (stag[:, 1:, :-1, 1] + stag[:, :-1, :-1, 1]) / 2.0
    vx = (stag[:, :-1, 1:, 0] + stag[:, :-1, :-1, 0]) / 2.0
    yy = torch.arange(h, device=field.device, dtype=field.dtype)[:, None] - vy
    xx = torch.arange(w, device=field.device, dtype=field.dtype)[None, :] - vx
    y, x = yy.clamp(0.0, float(h)), xx.clamp(0.0, float(w))
    inside = (y <= h - 1) & (x <= w - 1)
    y0, x0 = torch.floor(y), torch.floor(x)
    fy, fx = y - y0, x - x0
    y0i, x0i = y0.long().clamp(0, h - 1), x0.long().clamp(0, w - 1)
    y1i, x1i = (y0i + 1).clamp(0, h - 1), (x0i + 1).clamp(0, w - 1)
    bi = torch.arange(b, device=field.device)[:, None, None]
    out = (field[bi, y0i, x0i] * (1 - fy) * (1 - fx) + field[bi, y0i, x1i] * (1 - fy) * fx
           + field[bi, y1i, x0i] * fy * (1 - fx) + field[bi, y1i, x1i] * fy * fx)
    return torch.where(inside, out, torch.zeros_like(out))


def frame(dom: Domain, vel, density, zero_density, bucket_mass, c1, c2, solver):
    """One frame from (vel (B, 128, 128, 2), density and zero_density (B,
    127, 127), bucket_mass (B, 7)) under the ring control c1, c2 (B, 128,
    128): the next (vel, density, zero_density, bucket_mass)."""
    cur = torch.stack([c1, c2], dim=-1).clone()
    cur[:, 16:112, 16:112, :] = vel[:, 16:112, 16:112, :]
    vel = project(dom, cur, solver["accuracy"], solver["max_iterations"])
    density = advect(vel, density)
    zd = F.pad(advect(vel, zero_density), (0, 1, 0, 1))
    bucket_mass = bucket_mass + torch.einsum("byx,kyx->bk", zd, dom.cal)
    zero_density = (zd * dom.keep)[:, :-1, :-1]
    return vel, density, zero_density, bucket_mass
