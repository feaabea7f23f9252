#!/usr/bin/env python
"""Write pressure-force labels for a jellyfish dataset.

Port of ``apps/generate_jellyfish_forces.py``. For every frame of every sim
of each split, the boundary mask is clustered, each wing's subpixel outline
is rebuilt from the stored offsets (host numpy), and the RAW pressure is
integrated along it (``control/geometry.compute_pressforce_from_mask``, on
``--device``, default cuda). The labels go to
``<root>/<split>/forces/sim_%06d.npy`` as (T, n_bd, 2), the layout the
reference's ForceData reads (the label is the x-force summed over the
boundaries).

Example:
  python -m diffphycon_tpu_torch.apps.generate_jellyfish_forces \\
      --dataset_path data/jellyfish
"""

from __future__ import annotations

import argparse
import os


def build_parser():
    p = argparse.ArgumentParser(description="Jellyfish pressure-force labels")
    p.add_argument("--dataset_path", default="data/jellyfish", type=str)
    p.add_argument("--splits", nargs="+", default=["train_data", "test_data"])
    p.add_argument("--device", default=None, type=str,
                   help="where the force integral runs; default cuda, cpu explicitly")
    return p


def main(args):
    """Write the labels; returns {split: number of sims written}."""
    import numpy as np

    from diffphycon_tpu_torch.control.geometry import compute_pressforce_from_mask
    from diffphycon_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    written = {}
    for split in args.splits:
        base = os.path.join(args.dataset_path, split)
        states_dir = os.path.join(base, "states")
        if not os.path.isdir(states_dir):
            print(f"skip {split}: no states dir", flush=True)
            continue
        out_dir = os.path.join(base, "forces")
        os.makedirs(out_dir, exist_ok=True)
        sims = sorted(f for f in os.listdir(states_dir) if f.startswith("sim_"))
        for f in sims:
            st = np.load(os.path.join(states_dir, f))["a"]  # (T, 3, H, W)
            bd = np.load(os.path.join(base, "bdry_merged_mask_offsets", f))["a"]
            frames = [compute_pressforce_from_mask(
                np.nan_to_num(st[t, 2]), bd[t], pad_shift=(st.shape[-1] - bd.shape[1]) / 2.0,
                device=device) for t in range(st.shape[0])]
            n_bd = max(max(ft.shape[0] for ft in frames), 1)
            # (T, n_bd, 2); ragged cluster counts padded with 0
            out = np.zeros((st.shape[0], n_bd, 2), np.float32)
            for t, ft in enumerate(frames):
                out[t, : ft.shape[0]] = ft
            np.save(os.path.join(out_dir, f.replace(".npz", ".npy")), out)
            print(f"{split}/{f}: n_bd={n_bd} Fx mean {out[..., 0].sum(1).mean():+.3f}",
                  flush=True)
        written[split] = len(sims)
    return written


if __name__ == "__main__":
    main(build_parser().parse_args())
