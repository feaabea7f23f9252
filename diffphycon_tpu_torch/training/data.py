"""Burgers, smoke and jellyfish data for the port (the Burgers synthetic
generator, h5 layout, training stack, graph view and batch iterator; the
smoke sim directories; the jellyfish sim files and their synthetic
stand-in); port of ``diffphycon_tpu/training/data.py``. Everything here is
numpy on the host, so it writes and reads the same arrays as the JAX
package."""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from diffphycon_tpu_torch.device import resolve_device
from diffphycon_tpu_torch.physics.burgers import burgers_solve, make_burgers_data


def stack_burgers_uf(u: np.ndarray, f: np.ndarray, rescaler: float = 10.0,
                     partially_observed_fill_zero: Optional[str] = None) -> np.ndarray:
    """(N, 11, 128) u and (N, 10, 128) f -> (N, 16, 128, 2) float32: u in
    channel 0, f in channel 1, zero-padded to 16 rows, divided by
    ``rescaler``; with "front_rear_quarter" the unobserved middle half of u
    is zeroed first."""
    n, nt_u, nx = u.shape
    out = np.zeros((n, 16, nx, 2), np.float32)
    if partially_observed_fill_zero == "front_rear_quarter":
        u = u.copy()
        u[:, :, nx // 4 : (3 * nx) // 4] = 0.0
    elif partially_observed_fill_zero is not None:
        raise ValueError(partially_observed_fill_zero)
    out[:, :nt_u, :, 0] = u
    out[:, : f.shape[1], :, 1] = f
    return out / rescaler


def burgers_graph_edges(n_nodes: int = 128):
    """1D chain graph over the spatial nodes: (edge_index (2, E) int64 with
    the neighbour pairs [i, i+1], [i+1, i] interleaved per i, edge_attr (E,
    1) float32 of -1/(n+1) on forward and +1/(n+1) on backward edges), as
    the reference's torch-geometric Burgers dataset builds them."""
    i = np.arange(n_nodes - 1)
    edge_index = np.empty((2, 2 * (n_nodes - 1)), np.int64)
    edge_index[:, 0::2] = np.stack([i, i + 1])
    edge_index[:, 1::2] = np.stack([i + 1, i])
    step = 1.0 / (n_nodes + 1)
    edge_attr = np.where(edge_index[0] < edge_index[1], -step, step)
    return edge_index, edge_attr[:, None].astype(np.float32)


@dataclasses.dataclass
class BurgersGraphDataset:
    """Graph view of Burgers trajectories for operator-style training: one
    item per (sim, effective time stamp), a dict of numpy arrays (the
    reference's ``Data(x, y, f, edge_index, x_pos, x_bdd, edge_attr)``).
    x is the ``input_steps``-long history per node, y the
    ``output_steps``-long future, f the force (a per-step force takes the
    window start's frame)."""

    u: np.ndarray            # (N, T, nx)
    f: np.ndarray            # (N, nx) or (N, T-1, nx)
    input_steps: int = 1
    output_steps: int = 10
    time_interval: int = 1

    def __post_init__(self):
        t = self.u.shape[1]
        ti = self.time_interval
        self._cushion_in = max(self.input_steps * ti, 1)
        cushion_out = max(self.output_steps * ti, 1)
        self.time_stamps_effective = (t - self._cushion_in - cushion_out + ti) // ti
        nx = self.u.shape[-1]
        self.edge_index, self.edge_attr = burgers_graph_edges(nx)
        self.x_pos = np.linspace(1, nx, nx, dtype=np.float32)[:, None] / (nx + 1)
        self.x_bdd = np.ones((nx, 1), np.float32)
        self.x_bdd[0] = self.x_bdd[-1] = 0.0

    def __len__(self):
        return self.time_stamps_effective * self.u.shape[0]

    def get(self, idx: int) -> dict:
        sim_id, time_id = divmod(idx, self.time_stamps_effective)
        ti = self.time_interval
        start = time_id * ti + self._cushion_in
        traj = self.u[sim_id]
        xs = np.stack([traj[start + j] for j in range(-self.input_steps * ti, 0, ti)], -1)
        ys = np.stack([traj[start + j] for j in range(0, self.output_steps * ti, ti)], -1)
        force = self.f[sim_id]
        if force.ndim > 1:
            force = force[min(time_id, force.shape[0] - 1)]
        return {"x": xs[..., None].astype(np.float32),   # (nx, input_steps, 1)
                "y": ys[..., None].astype(np.float32),   # (nx, output_steps, 1)
                "f": force[:, None].astype(np.float32),  # (nx, 1)
                "x_pos": self.x_pos, "x_bdd": self.x_bdd,
                "edge_index": self.edge_index, "edge_attr": self.edge_attr}


@dataclasses.dataclass
class ArrayDataset:
    """In-memory dataset with an endless shuffled batch iterator (numpy's
    generator, so the batches equal the JAX package's)."""

    data: np.ndarray  # (N, ...)

    def __len__(self):
        return self.data.shape[0]

    def batches(self, batch_size: int, seed: int = 0,
                drop_last: bool = True) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(seed)
        n = len(self)
        if batch_size > n:
            raise ValueError(f"batch {batch_size} larger than the dataset ({n})")
        while True:
            perm = rng.permutation(n)
            end = n - (n % batch_size) if drop_last else n
            for i in range(0, end, batch_size):
                yield self.data[perm[i : i + batch_size]]


def load_burgers_h5(path, split: str = "train", nt: int = 11, nx: int = 128):
    """(u (N, nt, nx), f (N, nt-1, nx)) float32 from the reference h5."""
    import h5py

    key = f"pde_{nt}-{nx}"
    with h5py.File(str(path), "r") as h5:
        grp = h5[split]
        return (np.asarray(grp[key], np.float32),
                np.asarray(grp[key + "_f"], np.float32))


def synthetic_burgers(n: int, seed: int = 0, partial_control=None, dt: float = 1e-4,
                      chunk: int = 4096, cache_dir=None, device=None):
    """(u (n, 11, 128), f (n, 10, 128)) float32 numpy: the JAX package's
    synthetic distribution, solved by the port's solver on ``device``.

    ``cache_dir`` memoises the result under a tag of the port's own, so it
    never reads a cache that the JAX package wrote."""
    tag = f"torch_burgers_n{n}_s{seed}_pc{partial_control or 'full'}_dt{dt}"
    path = Path(cache_dir) / (tag + ".npz") if cache_dir else None
    if path is not None and path.is_file():
        with np.load(path) as z:
            return z["u"], z["f"]
    dev = resolve_device(device)
    u0, f = make_burgers_data(n, s=128, t=10, seed=seed, partial_control=partial_control)
    parts = []
    with torch.no_grad():
        for i in range(0, n, chunk):
            parts.append(burgers_solve(
                torch.from_numpy(u0[i : i + chunk]).to(dev),
                torch.from_numpy(f[i : i + chunk]).to(dev),
                visc=0.01, T=1.0, dt=dt, num_t=10).cpu().numpy())
    u = np.concatenate(parts, axis=0).astype(np.float32)
    if path is not None:
        os.makedirs(path.parent, exist_ok=True)
        np.savez_compressed(path, u=u, f=f)
    return u, f


# ---------------------------------------------------------------------------
# smoke (the reference on-disk layout: <root>/train/sim_%06d/ and
# <root>/test/control/sim_%06d/, four .npy arrays each)
# ---------------------------------------------------------------------------

SMOKE_ARRAYS = ("Density", "Velocity", "Control", "Smoke")


def load_smoke_sim(sim_dir) -> np.ndarray:
    """One sim directory -> (T, H, W, 6) unscaled float32: density, vx, vy,
    c1, c2 and the target bucket's share of the smoke, broadcast over
    space. The arrays are (H, W, C, T), Smoke.npy (T, 8)."""
    d, v, c, s = (np.load(os.path.join(sim_dir, f + ".npy")) for f in SMOKE_ARRAYS)
    t, h = d.shape[-1], d.shape[0]
    rate = s[:, 1] / s.sum(-1)
    sp = np.broadcast_to(rate[:, None, None], (t, h, h))
    return np.concatenate([np.transpose(d, (3, 0, 1, 2)), np.transpose(v, (3, 0, 1, 2)),
                           np.transpose(c, (3, 0, 1, 2)), sp[..., None]],
                          axis=-1).astype(np.float32)


def _complete_sim(sim_dir) -> bool:
    """All four arrays present and as long as their headers say (a writer
    cut short leaves a directory without them, or with a truncated one)."""
    for f in SMOKE_ARRAYS:
        try:
            np.load(os.path.join(sim_dir, f + ".npy"), mmap_mode="r")
        except (OSError, ValueError):
            return False
    return True


def load_smoke_dataset(root, split: str = "train", n=None, frames: int = 32,
                       rescale: bool = True) -> np.ndarray:
    """(N, T, H, W, 6) from <root>/train (the first ``frames`` frames,
    divided by RESCALER when ``rescale``) or <root>/test/control (all frames,
    unscaled). Incomplete sim directories are skipped. The arrays are read
    by the native threaded loader (``utils/native_io.py``), each converted
    to float32 as it is read, as the JAX loader reads them when its library
    is built."""
    from diffphycon_tpu_torch.utils.native_io import load_npy_batch, npy_info

    base = os.path.join(root, split) if split == "train" else os.path.join(
        root, "test", "control")
    sims = sorted(d for d in os.listdir(base)
                  if d.startswith("sim_") and _complete_sim(os.path.join(base, d)))
    if n is not None:
        sims = sims[:n]
    if not sims:
        raise FileNotFoundError(f"no complete sim directories under {base}")
    arrays = {}
    for f in SMOKE_ARRAYS:
        paths = [os.path.join(base, s, f + ".npy") for s in sims]
        arrays[f] = load_npy_batch(paths, npy_info(paths[0])[0])
    d, s = arrays["Density"], arrays["Smoke"]  # (N, H, W, 1, T), (N, T, 8)
    t, h = d.shape[-1], d.shape[1]
    rate = s[:, :, 1] / s.sum(-1)
    sp = np.broadcast_to(rate[:, :, None, None], (len(sims), t, h, h))
    states = np.concatenate([np.transpose(arrays[f], (0, 4, 1, 2, 3))
                             for f in ("Density", "Velocity", "Control")] + [sp[..., None]],
                            axis=-1).astype(np.float32)
    if split == "train":
        states = states[:, :frames]
        if rescale:
            from diffphycon_tpu_torch.benchmarks.smoke import RESCALER

            states = states / RESCALER
    return states


# ---------------------------------------------------------------------------
# jellyfish (the reference on-disk layout: <root>/{train_data,test_data}/
# {states,bdry_merged_mask_offsets,bdry_head_thetas}/sim_%06d.npz and
# normalization_max_min.pkl)
# ---------------------------------------------------------------------------


def _minmax_norm(a, lo, hi):
    return (np.clip((a - lo) / (hi - lo), 0, 1) - 0.5) * 2


def load_jellyfish_dataset(root, split: str = "train", n=None, frames: int = 20,
                           only_vis_pressure: bool = False, offset: int = 0) -> dict:
    """The sims of <root>/train_data or <root>/test_data (from the
    ``offset``-th, at most ``n``) as a dict:

    - states: (N, T, 64, 64, n_state) min-max normalised to [-1, 1], NaN -> 0;
    - bd: (N, T, 64, 64, 3) mask and offsets, zero-padded 62 -> 64;
    - thetas: (N, T);
    - p_nan: (N, T, 64, 64) where the raw pressure is NaN (solid cells; the
      force surrogate's labels need them as raw 0, not the normalised
      midpoint);
    - norm: the normalisation dict.

    ``frames`` is accepted as the JAX loader accepts it; whole sims are
    returned and the callers cut windows."""
    import pickle

    del frames
    base = os.path.join(root, "train_data" if split == "train" else "test_data")
    with open(os.path.join(base, "normalization_max_min.pkl"), "rb") as fh:
        norm = pickle.load(fh)
    sims = sorted(f for f in os.listdir(os.path.join(base, "states"))
                  if f.startswith("sim_"))[offset:]
    if n is not None:
        sims = sims[:n]
    states, bds, thetas, p_nans = [], [], [], []
    for f in sims:
        st = np.load(os.path.join(base, "states", f))["a"]  # (T, 3, 64, 64)
        p = _minmax_norm(st[:, 2], norm["p_min"], norm["p_max"])[..., None]
        if only_vis_pressure:
            s = p
        else:
            vx = _minmax_norm(st[:, 0], norm["vx_min"], norm["vx_max"])[..., None]
            vy = _minmax_norm(st[:, 1], norm["vy_min"], norm["vy_max"])[..., None]
            s = np.concatenate([vx, vy, p], -1)
        bd62 = np.load(os.path.join(base, "bdry_merged_mask_offsets", f))["a"]
        bd = np.zeros((bd62.shape[0], 64, 64, 3), np.float32)
        bd[:, 1:-1, 1:-1, :] = np.nan_to_num(bd62)
        th = np.load(os.path.join(base, "bdry_head_thetas", f))["thetas"]
        states.append(np.nan_to_num(s).astype(np.float32))
        bds.append(bd)
        thetas.append(th.astype(np.float32))
        p_nans.append(np.isnan(st[:, 2]))
    return {"states": np.stack(states), "bd": np.stack(bds), "thetas": np.stack(thetas),
            "p_nan": np.stack(p_nans), "norm": norm}


def synthetic_jellyfish(n: int, out_dir, frames_total: int = 40, seed: int = 0) -> None:
    """Write ``n`` synthetic sims in the reference layout under ``out_dir``
    (the JAX generator's arrays for the same seed): two elliptic wing rings
    hinged at the head, flapping sinusoidally; states are smooth random
    fields scaled by the flap phase. A structural stand-in for the CFD data,
    which the reference downloads."""
    import pickle

    rng = np.random.default_rng(seed)
    for sub in ("states", "bdry_merged_mask_offsets", "bdry_head_thetas"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    with open(os.path.join(out_dir, "normalization_max_min.pkl"), "wb") as fh:
        pickle.dump({"vx_max": 1.0, "vx_min": -1.0, "vy_max": 1.0,
                     "vy_min": -1.0, "p_max": 1.0, "p_min": -1.0}, fh)
    yy, xx = np.mgrid[0:62, 0:62]
    head = np.array([20.0, 31.0])
    for i in range(n):
        amp = rng.uniform(0.2, 0.6)
        phase = rng.uniform(0, 2 * np.pi)
        thetas = (0.8 + amp * np.sin(np.linspace(0, 2 * np.pi, frames_total) + phase)
                  ).astype(np.float32)
        bd = np.zeros((frames_total, 62, 62, 3), np.float32)
        states = np.zeros((frames_total, 3, 64, 64), np.float32)
        for t in range(frames_total):
            th = thetas[t]
            for sgn in (+1, -1):  # wing centre along the angle sgn * theta
                cx = head[1] + 12 * np.cos(sgn * th)
                cy = head[0] + 12 * np.sin(sgn * th)
                d = ((xx - cx) / 12.0) ** 2 + ((yy - cy) / 3.0) ** 2
                ring = np.abs(d - 1.0) < 0.25
                bd[t, :, :, 0][ring] = 1.0
                bd[t, :, :, 1][ring] = (xx[ring] - cx) / 62.0
                bd[t, :, :, 2][ring] = (yy[ring] - cy) / 62.0
            up = np.kron(rng.normal(size=(3, 8, 8)).astype(np.float32),
                         np.ones((8, 8), np.float32))
            states[t] = np.tanh(up * 0.5) * (0.5 + 0.5 * np.sin(th))
        name = f"sim_{i:06d}.npz"
        np.savez_compressed(os.path.join(out_dir, "states", name), a=states)
        np.savez_compressed(os.path.join(out_dir, "bdry_merged_mask_offsets", name), a=bd)
        np.savez_compressed(os.path.join(out_dir, "bdry_head_thetas", name), thetas=thetas)
