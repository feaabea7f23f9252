"""Burgers and smoke data for the port (the Burgers synthetic generator, h5
layout, training stack and batch iterator; the smoke sim directories); port
of those parts of ``diffphycon_tpu/training/data.py``."""

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
    unscaled). Incomplete sim directories are skipped."""
    base = os.path.join(root, split) if split == "train" else os.path.join(
        root, "test", "control")
    sims = sorted(d for d in os.listdir(base)
                  if d.startswith("sim_") and _complete_sim(os.path.join(base, d)))
    if n is not None:
        sims = sims[:n]
    states = np.stack([load_smoke_sim(os.path.join(base, s)) for s in sims])
    if split == "train":
        states = states[:, :frames]
        if rescale:
            from diffphycon_tpu_torch.benchmarks.smoke import RESCALER

            states = states / RESCALER
    return states
