"""Jellyfish boundary geometry: boundary reconstruction and the
pressure-force integral.

Port of ``diffphycon_tpu/control/geometry.py``. The force integral
(``compute_orthonormal``, ``linear_transform``, ``compute_pressforce``) is
torch and differentiable, on the device of its inputs. The reconstruction
of the wing outlines from a binary mask and subpixel offsets (clustering,
BFS boundary walk, Pareto-frontier ordering) is the JAX package's host
numpy, copied: it prepares data and is not on a hot path.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from diffphycon_tpu_torch.device import resolve_device


# ---------------------------------------------------------------------------
# differentiable force integration (reference utils.py:119-208)
# ---------------------------------------------------------------------------


def compute_orthonormal(boundary: torch.Tensor):
    """boundary: (N, 2) closed polyline. Returns (length, nx, ny, center)
    of each segment to the next point."""
    rolled = torch.roll(boundary, -1, dims=0)
    length = torch.linalg.vector_norm(boundary - rolled, dim=1)
    tx = (boundary[:, 0] - rolled[:, 0]) / length
    ty = (boundary[:, 1] - rolled[:, 1]) / length
    return length, ty, -tx, (boundary + rolled) / 2.0


def linear_transform(pressure: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """Bilinear pressure at the segment midpoints with the reference's
    clamping and index convention. pressure: (H, W); center: (N, 2) in
    (x, y) order. Returns (N,)."""
    n, m = pressure.shape
    x = torch.clamp(center[:, 0], 0.5, n - 1.5)
    x_inds = torch.clamp(x.long(), max=n - 2)
    fs = x - x_inds
    y = torch.clamp(center[:, 1], 0.5, m - 1.5)
    y_inds = torch.clamp(y.long(), max=m - 2)
    ft = y - y_inds
    row_p1 = ft * pressure[y_inds + 1, x_inds + 1] + (1 - ft) * pressure[y_inds, x_inds + 1]
    row = ft * pressure[y_inds + 1, x_inds] + (1 - ft) * pressure[y_inds, x_inds]
    return fs * row_p1 + (1 - fs) * row


def compute_pressforce(pressure: torch.Tensor, boundary: torch.Tensor):
    """(Fx, Fy): p * n_hat * dl summed along the boundary polyline."""
    length, nx, ny, cen = compute_orthonormal(boundary)
    pdl = linear_transform(pressure, cen) * length
    return (pdl * nx).sum(), (pdl * ny).sum()


# ---------------------------------------------------------------------------
# host-side boundary reconstruction (reference utils.py:282-640)
# ---------------------------------------------------------------------------

_NEIGHBORS = [(-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (1, -1),
              (1, 1)]


def find_isolated_points(grid: np.ndarray):
    """(reference utils.py:282-329): points whose neighborhood is almost
    entirely different-valued."""
    rows, cols = grid.shape
    out = []
    for r in range(rows):
        for c in range(cols):
            if grid[r, c] != 1:
                continue
            on_r = r in (0, rows - 1)
            on_c = c in (0, cols - 1)
            n = 3 if (on_r and on_c) else (5 if (on_r or on_c) else 8)
            j = 0
            for dr, dc in _NEIGHBORS:
                nr, nc = r + dr, c + dc
                if 0 <= nr < rows and 0 <= nc < cols:
                    if grid[nr, nc] != grid[r, c]:
                        j += 1
                    if (n == 8 and j >= 7) or (n == 5 and j >= 4) or (
                            n == 3 and j >= 2):
                        out.append((r, c))
                        break
    return out


def filter_isolated_points(grid: np.ndarray) -> np.ndarray:
    grid = grid.copy()
    iso = find_isolated_points(grid)
    while iso:
        for r, c in iso:
            grid[r, c] = 0
        iso = find_isolated_points(grid)
    return grid


def find_clusters(grid: np.ndarray) -> np.ndarray:
    """DBSCAN(eps=1.5, min_samples=2) over nonzero cells
    (reference utils.py:347-362)."""
    from sklearn.cluster import DBSCAN

    nz = np.argwhere(grid != 0)
    out = np.zeros_like(grid, dtype=np.int64)
    if len(nz) == 0:
        return out
    labels = DBSCAN(eps=1.5, min_samples=2).fit_predict(nz)
    for cell, lab in zip(nz, labels):
        out[tuple(cell)] = lab + 1
    return out


def find_filtered_clusters(grid: np.ndarray) -> np.ndarray:
    """(reference find_filtered_clusteres, utils.py:400-434)."""
    filtered = filter_isolated_points(np.asarray(grid, dtype=float))
    return find_clusters(filtered)


def _bfs_boundary(start, grid):
    """(reference bfs_boundary_detection_without_intersection,
    utils.py:456-476)."""
    rows, cols = len(grid), len(grid[0])
    visited = [[False] * cols for _ in range(rows)]
    boundary = []
    queue = deque([start])

    def valid(x, y):
        return 0 <= x < rows and 0 <= y < cols and grid[x][y] == 1

    while queue:
        x, y = queue.popleft()
        if visited[x][y]:
            continue
        visited[x][y] = True
        if any(not valid(x + dx, y + dy) for dx, dy in _NEIGHBORS):
            boundary.append((x, y))
        for dx, dy in _NEIGHBORS:
            nx, ny = x + dx, y + dy
            if valid(nx, ny) and not visited[nx][ny]:
                queue.append((nx, ny))
    return boundary


def find_pareto_frontier(points: np.ndarray) -> np.ndarray:
    """Order the boundary point cloud into a closed outline by stitching the
    four Pareto frontiers and densifying straight gaps
    (reference find_pareto_frontier, utils.py:479-580)."""
    pts = np.asarray(points)

    def frontier(vals, flip0, reverse, dominate_ge):
        v = vals.copy().astype(float)
        if flip0:
            v[:, 0] = -v[:, 0]
        keep = []
        for i, a in enumerate(v):
            dominated = False
            for j, b in enumerate(v):
                if dominate_ge:
                    if all(a <= b) and any(a < b):
                        dominated = True
                        break
                else:
                    if all(b <= a) and any(b < a):
                        dominated = True
                        break
            if not dominated:
                c = a.copy()
                if flip0:
                    c[0] = -c[0]
                keep.append(c)
        arr = np.array(keep)
        order = arr[:, 0].argsort()
        if reverse:
            order = np.flip(order)
        return arr[order]

    f1 = frontier(pts, False, False, True)
    f2 = frontier(pts, True, True, False)
    f3 = frontier(pts, False, True, False)
    f4 = frontier(pts, True, False, True)
    org = np.concatenate([f1, f2, f3, f4], axis=0)
    idx_hash = 100 * org[:, 0] + org[:, 1]
    uniq = np.unique(idx_hash, return_index=True)[1]
    frontier_pts = [org[i] for i in sorted(uniq)]

    put_values, put_indices = [], []
    n = len(frontier_pts)
    for i in range(n):
        dx = frontier_pts[i % n][0] - frontier_pts[(i + 1) % n][0]
        dy = frontier_pts[i % n][1] - frontier_pts[(i + 1) % n][1]
        if dy == 0 and abs(dx) > 1:
            sgn = -1 if dx > 1 else 1
            for k in range(1, int(abs(dx))):
                put_values.append([frontier_pts[i % n][0] + sgn * k,
                                   frontier_pts[i % n][1]])
                put_indices.append(i + 1)
        elif dx == 0 and abs(dy) > 1:
            sgn = -1 if dy > 1 else 1
            for k in range(1, int(abs(dy))):
                put_values.append([frontier_pts[i % n][0],
                                   frontier_pts[i % n][1] + sgn * k])
                put_indices.append(i + 1)
    if put_indices:
        return np.insert(np.array(frontier_pts), put_indices, put_values,
                         axis=0)
    return np.array(frontier_pts)


def find_cluster_boundary(clustered_grid: np.ndarray):
    """Per-cluster ordered boundary outlines (reference utils.py:583-622)."""
    boundaries = []
    for i in range(int(clustered_grid.max())):
        single = np.where(clustered_grid == i + 1, 1, 0).tolist()
        start = next(
            ((r, c) for r, row in enumerate(single)
             for c, v in enumerate(row) if v == 1), None)
        if start is None:
            continue
        bfs = np.array(_bfs_boundary(start, single))
        outline = find_pareto_frontier(bfs)
        outline = np.fliplr(outline)[::-1]
        boundaries.append(outline)
    return boundaries


def reconstruct_boundary(binary_mask: np.ndarray, bd_offset: np.ndarray):
    """Restore subpixel boundary points from mask + offsets
    (reference utils.py:640-659)."""
    boundary_bd = find_cluster_boundary(
        find_clusters(np.asarray(binary_mask)))[0]
    off = np.asarray(bd_offset)
    new_off = off[boundary_bd[:, 1].astype(int),
                  boundary_bd[:, 0].astype(int), :]
    return (boundary_bd + 0.5) + new_off


def find_clusters_fast(grid: np.ndarray) -> np.ndarray:
    """C-speed equivalent of find_clusters: DBSCAN with eps=1.5 over occupied
    grid cells is exactly 8-connected components (sqrt(2) <= 1.5 < 2), so
    scipy.ndimage.label with a 3x3 structure reproduces the reference
    clustering (verified identical on dataset masks), ~5000x faster.
    min_samples=2 semantics: singleton cells are noise, and surviving
    clusters are renumbered in raster first-encounter order like DBSCAN."""
    from scipy import ndimage

    labels, k = ndimage.label(np.asarray(grid),
                              structure=np.ones((3, 3), int))
    out = np.zeros_like(labels)
    nxt = 1
    for i in range(1, k + 1):
        cells = labels == i
        if cells.sum() >= 2:
            out[cells] = nxt
            nxt += 1
    return out


def compute_binary_pressforce(pressure, clustered_grid: np.ndarray, device=None):
    """{cluster id: (Fx, Fy)} for every solid of a multi-solid mask
    (reference compute_binary_pressForce, utils.py:624-640)."""
    dev = resolve_device(device)
    p = torch.as_tensor(np.asarray(pressure), dtype=torch.float32, device=dev)
    return {i + 1: compute_pressforce(p, torch.as_tensor(boundary + 0.5, dtype=torch.float32,
                                                         device=dev))
            for i, boundary in enumerate(find_cluster_boundary(clustered_grid))}


def compute_pressforce_from_mask(pressure, mask_offsets, pad_shift: float = 1.0,
                                 device=None) -> np.ndarray:
    """Per-cluster pressure-force labels from one (H, W, 3) boundary mask +
    offsets frame: the label recipe of the reference's ForceData (solver
    forces summed over boundaries), through the differentiable integral.

    pressure: (Hp, Wp) raw (unnormalised) pressure on the padded grid;
    mask_offsets: (H, W, 3), channel 0 the binary mask, 1:3 the offsets;
    pad_shift: the shift from the mask grid into the pressure grid (the
    reference zero-pads 62 -> 64, i.e. +1); device: where the integral runs
    (default CUDA, see resolve_device). Returns (n_clusters, 2) float32
    (Fx, Fy)."""
    dev = resolve_device(device)
    mask = np.round(np.nan_to_num(np.asarray(mask_offsets[..., 0]))).astype(int)
    off = np.nan_to_num(np.asarray(mask_offsets[..., 1:3]))
    # strip isolated speckles, then cluster (find_filtered_clusteres)
    clustered = find_clusters_fast(filter_isolated_points(mask.astype(float)))
    p = torch.as_tensor(np.asarray(pressure), dtype=torch.float32, device=dev)
    forces = []
    for outline in find_cluster_boundary(clustered):
        if outline.shape[0] < 3:
            continue  # degenerate sliver: no closed polyline to integrate
        off_sel = off[outline[:, 1].astype(int), outline[:, 0].astype(int)]
        boundary = (outline + 0.5) + off_sel + pad_shift
        # drop consecutive duplicates (zero-length segments -> NaN normals)
        keep = np.concatenate([[True], np.any(np.diff(boundary, axis=0) != 0, axis=1)])
        boundary = boundary[keep]
        if np.all(boundary[0] == boundary[-1]):
            boundary = boundary[:-1]  # the polyline closes itself via roll
        if boundary.shape[0] < 3:
            continue
        forces.append(torch.stack(compute_pressforce(
            p, torch.as_tensor(boundary, dtype=torch.float32, device=dev))))
    if not forces:
        return np.zeros((0, 2), np.float32)
    return torch.stack(forces).cpu().numpy().astype(np.float32)
