"""Staggered (MAC) grid operators, channels-last.

Port of ``diffphycon_tpu/physics/fluids/grids.py``: fields are (B, H, W, C)
with spatial dims in (y, x) order; staggered velocities are (B, H+1, W+1, 2)
with channel 0 = x-component, 1 = y-component. Plain tensor slicing and
padding, differentiable by construction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def staggered_divergence(stag: torch.Tensor) -> torch.Tensor:
    """Forward-difference divergence: (B, H+1, W+1, 2) -> (B, H, W, 1)."""
    dy = stag[:, 1:, :-1, 1] - stag[:, :-1, :-1, 1]
    dx = stag[:, :-1, 1:, 0] - stag[:, :-1, :-1, 0]
    return (dy + dx)[..., None]


def staggered_gradient(scalar: torch.Tensor) -> torch.Tensor:
    """Staggered gradient of a centred scalar with symmetric padding:
    (B, H, W, 1) -> (B, H+1, W+1, 2)."""
    s = scalar[..., 0]
    # numpy "symmetric" padding by one repeats the edge row / column
    f = torch.cat([s[:, :1], s, s[:, -1:]], dim=1)
    f = torch.cat([f[:, :, :1], f, f[:, :, -1:]], dim=2)
    gy = f[:, 1:, 1:] - f[:, :-1, 1:]
    gx = f[:, 1:, 1:] - f[:, 1:, :-1]
    return torch.stack([gx, gy], dim=-1)


def staggered_at_centers(stag: torch.Tensor) -> torch.Tensor:
    """Average face samples to cell centres: (B, H+1, W+1, 2) -> (B, H, W, 2)
    (channel 0 = x, 1 = y)."""
    vy = (stag[:, 1:, :-1, 1] + stag[:, :-1, :-1, 1]) / 2.0
    vx = (stag[:, :-1, 1:, 0] + stag[:, :-1, :-1, 0]) / 2.0
    return torch.stack([vx, vy], dim=-1)


def staggered_at_faces(stag: torch.Tensor, face_dim_xyz: int) -> torch.Tensor:
    """Interpolate all components to the faces of dimension ``face_dim_xyz``
    (0 = x, 1 = y): (B, H+1, W+1, 2) -> (B, H+1, W+1, 2)."""
    rank = 2
    face_dim_zyx = rank - face_dim_xyz - 1
    components = []
    for d in range(rank):  # y, x
        comp = rank - d - 1
        t = stag[..., comp]
        if d != face_dim_zyx:
            for d2 in range(rank):
                ax = 1 + d2
                n = t.shape[ax]
                t = t.narrow(ax, 1, n - 1) + t.narrow(ax, 0, n - 1)
                # F.pad lists the last axis first: (x_lo, x_hi, y_lo, y_hi)
                lo_hi = (0, 1) if d2 == d else (1, 0)
                pad = lo_hi + (0, 0) if ax == 2 else (0, 0) + lo_hi
                t = F.pad(t, pad) / 2.0
        components.append(t)
    return torch.stack(components[::-1], dim=-1)


def resample_linear(field: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear resample with replicate-boundary semantics: coordinates are
    clamped to [0, dim] (one past the last index), and samples outside
    [0, dim-1] are 0.

    field: (B, H, W, C); coords: (B, H', W', 2) in (y, x) index order.
    Returns (B, H', W', C)."""
    b, h, w, _ = field.shape
    y = coords[..., 0].clamp(0.0, float(h))
    x = coords[..., 1].clamp(0.0, float(w))
    in_range = (y <= h - 1) & (x <= w - 1)

    y0 = torch.floor(y)
    x0 = torch.floor(x)
    fy = (y - y0)[..., None]
    fx = (x - x0)[..., None]
    y0i = y0.long().clamp(0, h - 1)
    x0i = x0.long().clamp(0, w - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    bi = torch.arange(b, device=field.device)[:, None, None]

    out = (field[bi, y0i, x0i] * (1 - fy) * (1 - fx)
           + field[bi, y0i, x1i] * (1 - fy) * fx
           + field[bi, y1i, x0i] * fy * (1 - fx)
           + field[bi, y1i, x1i] * fy * fx)
    return torch.where(in_range[..., None], out, torch.zeros((), dtype=out.dtype,
                                                              device=out.device))


def _index_grid(h: int, w: int, device=None) -> torch.Tensor:
    """(1, H, W, 2) index tensor in (y, x) order."""
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return torch.stack([yy, xx], dim=-1)[None]


def advect_centered(stag: torch.Tensor, field: torch.Tensor, dt: float = 1.0
                    ) -> torch.Tensor:
    """Semi-Lagrangian advection of a centred field by a staggered velocity.

    stag: (B, H+1, W+1, 2); field: (B, H, W, C) -> (B, H, W, C)."""
    _, h, w, _ = field.shape
    vel_yx = staggered_at_centers(stag).flip(-1)  # (x, y) -> (y, x)
    coords = _index_grid(h, w, field.device) - vel_yx * dt
    return resample_linear(field, coords)


def advect_staggered(stag: torch.Tensor, field_stag: torch.Tensor, dt: float = 1.0
                     ) -> torch.Tensor:
    """Semi-Lagrangian advection of a staggered field by a staggered
    velocity: each component is resampled at its own faces, displaced by the
    velocity interpolated to those faces.

    stag, field_stag: (B, H+1, W+1, 2) -> (B, H+1, W+1, 2)."""
    _, hp, wp, _ = field_stag.shape
    idx = _index_grid(hp, wp, field_stag.device)
    comps = []
    for comp in (0, 1):  # x, y
        vel_faces = staggered_at_faces(stag, comp).flip(-1)  # (x, y) -> (y, x)
        comps.append(resample_linear(field_stag[..., comp:comp + 1], idx - vel_faces * dt))
    return torch.cat(comps, dim=-1)
