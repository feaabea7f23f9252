"""Result plots for the three benchmarks (the port's copy of
``diffphycon_tpu/utils/viz.py``): per-batch per-frame field PNGs, the
Burgers state / control panel, smoke frame grids, the jellyfish theta and
objective curves, and named metric curves.

All functions take numpy arrays or tensors, write PNG files and return the
written paths. matplotlib is imported at the first plot, with the Agg
backend, so importing this module needs no matplotlib and plots work
headless.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _np(a) -> np.ndarray:
    """A numpy array of a tensor (on any device) or array-like."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def save_field_png(field, path: str, title: str = "", cmap: str = "viridis",
                   vmin: Optional[float] = None, vmax: Optional[float] = None
                   ) -> str:
    """Save a single 2D field as a PNG heatmap."""
    plt = _plt()
    field = _np(field)
    if field.ndim == 3 and field.shape[-1] == 1:
        field = field[..., 0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(4, 4))
    im = ax.imshow(field, origin="lower", cmap=cmap, vmin=vmin, vmax=vmax)
    fig.colorbar(im, ax=ax)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def save_field_sequence(data, directory: str, fieldname: str,
                        batches: Optional[Sequence[int]] = None,
                        cmap: str = "viridis") -> list:
    """Per-batch per-frame field PNGs named like the reference's scene
    dumps ('%s_batch%04d_%04d.png').

    data: (B, T, H, W) or (B, T, H, W, 1)."""
    data = _np(data)
    if data.ndim == 5 and data.shape[-1] == 1:
        data = data[..., 0]
    vmin, vmax = float(data.min()), float(data.max())
    paths = []
    for b in batches if batches is not None else range(data.shape[0]):
        for t in range(data.shape[1]):
            p = os.path.join(directory, f"{fieldname}_batch{b:04d}_{t:04d}.png")
            paths.append(save_field_png(data[b, t], p, cmap=cmap,
                                        vmin=vmin, vmax=vmax))
    return paths


def plot_burgers_control(u_traj, f, path: str, u_target: Optional[np.ndarray]
                         = None, sample: int = 0) -> str:
    """Burgers result panel: u(t, x) and f(t, x) heatmaps plus the final
    state against the target.

    u_traj: (B, Nt, Nx); f: (B, Nt-1|Nt, Nx)."""
    plt = _plt()
    u = _np(u_traj)[sample]
    fc = _np(f)[sample]
    ncols = 3 if u_target is not None else 2
    fig, axes = plt.subplots(1, ncols, figsize=(4 * ncols, 3.2))
    im0 = axes[0].imshow(u, aspect="auto", origin="lower", cmap="RdBu_r")
    axes[0].set(title="state u(t, x)", xlabel="x", ylabel="t")
    fig.colorbar(im0, ax=axes[0])
    im1 = axes[1].imshow(fc, aspect="auto", origin="lower", cmap="RdBu_r")
    axes[1].set(title="control f(t, x)", xlabel="x", ylabel="t")
    fig.colorbar(im1, ax=axes[1])
    if u_target is not None:
        tgt = _np(u_target)
        tgt = tgt[sample] if tgt.ndim == 2 else tgt
        axes[2].plot(u[-1], label="u(T)")
        axes[2].plot(tgt, "--", label="target")
        axes[2].set(title="final state vs target", xlabel="x")
        axes[2].legend()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def plot_smoke_frames(traj, path: str, channel: int = 0, sample: int = 0,
                      num_frames: int = 8, cmap: str = "inferno") -> str:
    """Grid of smoke trajectory frames for one channel (density by default).

    traj: (B, T, H, W, C) in the 6-channel benchmark layout."""
    plt = _plt()
    t = _np(traj)[sample, ..., channel]  # (T, H, W)
    idx = np.linspace(0, t.shape[0] - 1, num_frames).round().astype(int)
    fig, axes = plt.subplots(1, num_frames, figsize=(2 * num_frames, 2.3))
    vmin, vmax = float(t.min()), float(t.max())
    for ax, i in zip(np.atleast_1d(axes), idx):
        ax.imshow(t[i], origin="lower", cmap=cmap, vmin=vmin, vmax=vmax)
        ax.set_title(f"t={i}", fontsize=8)
        ax.axis("off")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def plot_jellyfish_result(thetas, path: str, J_list=None, boundary=None,
                          sample: int = 0) -> str:
    """Jellyfish result panel: opening-angle curve theta(t), optional J
    optimization curve, optional boundary-mask frame."""
    plt = _plt()
    th = _np(thetas)
    th = th[sample] if th.ndim == 2 else th
    npanels = 1 + (J_list is not None) + (boundary is not None)
    fig, axes = plt.subplots(1, npanels, figsize=(4.5 * npanels, 3.2))
    axes = np.atleast_1d(axes)
    axes[0].plot(th)
    axes[0].set(title="theta(t)", xlabel="frame", ylabel="opening angle")
    k = 1
    if J_list is not None:
        axes[k].plot(_np(J_list))
        axes[k].set(title="objective J", xlabel="iteration")
        k += 1
    if boundary is not None:
        bd = _np(boundary)
        bd = bd[sample] if bd.ndim == 4 else bd
        axes[k].imshow(bd[..., 0] if bd.ndim == 3 else bd, origin="lower",
                       cmap="gray")
        axes[k].set_title("boundary mask")
        axes[k].axis("off")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def plot_metric_curves(curves: dict, path: str, xlabel: str = "step",
                       logy: bool = False) -> str:
    """Overlaid named scalar curves (training loss, guidance objective)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 3.5))
    for name, ys in curves.items():
        ax.plot(_np(ys), label=name)
    if logy:
        ax.set_yscale("log")
    ax.set_xlabel(xlabel)
    ax.legend()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path
