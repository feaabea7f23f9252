"""The port's jellyfish data and surrogate training against the JAX package
on the CPU: ``synthetic_jellyfish`` and ``load_jellyfish_dataset`` (with a
raw-NaN pressure cell), ``make_surrogate_pairs`` for each kind (raw
pressures beyond the +-50 outlier bound, a NaN label), and one
``train_surrogate`` step of a small UNet2Dv2 (dim 8, mults (1, 2), 16x16
frames).

Tolerances (max |port - jax| <= rtol * max(1, max |jax|)):
- data, pairs and the written files: exact (the same numpy arithmetic);
- one train_surrogate step: the loss 1e-5, the updated weights 1e-6 (Adam's
  first step moves each weight by ~lr * sign(g)), but the conv biases before
  a GroupNorm, whose gradient is rounding noise: 2 * lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.nets import unet2dv2 as jnets
from diffphycon_tpu.training import data as jdata
from diffphycon_tpu.training import surrogates as jsur
from diffphycon_tpu_torch.nets.unet2dv2 import UNet2Dv2
from diffphycon_tpu_torch.training import data as tdata
from diffphycon_tpu_torch.training import surrogates as tsur
from diffphycon_tpu_torch.utils import convert
from torch_port_helpers import assert_close, flax_tree, rand

SMALL = dict(dim=8, dim_mults=(1, 2))


@pytest.fixture(scope="module")
def jelly_root(tmp_path_factory):
    """Synthetic sims written by both packages from one seed."""
    root = tmp_path_factory.mktemp("jelly")
    jdata.synthetic_jellyfish(3, str(root / "jax" / "train_data"), frames_total=6, seed=4)
    tdata.synthetic_jellyfish(3, str(root / "port" / "train_data"), frames_total=6, seed=4)
    return root


def test_port_synthetic_jellyfish_and_loader_exact(jelly_root):
    for sub in ("states", "bdry_merged_mask_offsets", "bdry_head_thetas"):
        for i in range(3):
            name = f"sim_{i:06d}.npz"
            with np.load(jelly_root / "jax" / "train_data" / sub / name) as a, \
                    np.load(jelly_root / "port" / "train_data" / sub / name) as b:
                assert a.files == b.files
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k])
    # a NaN pressure cell (a solid interior) flows into p_nan, raw
    st_path = jelly_root / "port" / "train_data" / "states" / "sim_000001.npz"
    st = np.load(st_path)["a"]
    st[2, 2, 10:12, 20:23] = np.nan
    np.savez_compressed(st_path, a=st)
    np.savez_compressed(jelly_root / "jax" / "train_data" / "states" / "sim_000001.npz", a=st)
    for kw in ({}, {"only_vis_pressure": True}, {"offset": 1, "n": 1}):
        ref = jdata.load_jellyfish_dataset(str(jelly_root / "jax"), "train", **kw)
        out = tdata.load_jellyfish_dataset(str(jelly_root / "port"), "train", **kw)
        assert ref.keys() == out.keys()
        for k in ("states", "bd", "thetas", "p_nan"):
            assert out[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(out[k], ref[k])
        assert out["norm"] == ref["norm"]
    assert out["bd"].shape == (1, 6, 64, 64, 3)
    assert tdata.load_jellyfish_dataset(str(jelly_root / "port"), "train")["p_nan"].sum() == 6


@pytest.mark.parametrize("kind", ["force", "simulator", "boundary_updater"])
def test_port_make_surrogate_pairs_exact(jelly_root, kind):
    data = tdata.load_jellyfish_dataset(str(jelly_root / "port"), "train")
    # raw pressures beyond the +-50 outlier bound and raw-NaN cells
    data["norm"] = dict(data["norm"], p_min=-80.0, p_max=60.0)
    labels = rand(3, 6, seed=9)
    labels[0, 1] = np.nan
    ref_in, ref_y = jsur.make_surrogate_pairs(data, kind, labels)
    out_in, out_y = tsur.make_surrogate_pairs(data, kind, labels)
    assert len(ref_in) == len(out_in)
    for a, b in zip(ref_in + (ref_y,), out_in + (out_y,)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_port_train_surrogate_step_matches_jax(tmp_path):
    net = jnets.UNet2Dv2(out_dim=3, channels=3, **SMALL)
    params = flax_tree(net, jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,)), seed=11)
    x, d, y = rand(16, 16, 16, 3, seed=12), rand(16, seed=13), rand(16, 16, 16, 3, seed=14)
    jcfg = jsur.SurrogateTrainConfig(batch_size=8, num_steps=1, log_every=1,
                                     results_folder=str(tmp_path / "jax"))
    jstate, jlast = jsur.train_surrogate(net.apply, params, (x, d), y, jcfg)
    port = convert.load_flax_unet2dv2(UNet2Dv2(out_dim=3, channels=3, **SMALL), params)
    tcfg = tsur.SurrogateTrainConfig(batch_size=8, num_steps=1, log_every=1,
                                     results_folder=str(tmp_path / "port"))
    state, last = tsur.train_surrogate(port, (x, d), y, tcfg, device="cpu")
    assert state.step == 1
    assert abs(last - jlast) <= 1e-5 * max(1.0, abs(jlast))
    ref = convert.flax_unet2dv2_to_state_dict(jax.device_get(jstate.params))
    bad = {}
    for k, v in port.state_dict().items():
        err = float((v - torch.from_numpy(np.array(ref[k]))).abs().max())
        # a conv bias right before a GroupNorm has a zero gradient but for
        # rounding noise, which Adam's first step scales up to ~lr in either
        # direction: those agree to 2 * lr; every other weight to 1e-6
        tol = 2 * jcfg.lr if k.endswith("proj.bias") else 1e-6 * max(
            1.0, float(np.abs(ref[k]).max()))
        if err > tol:
            bad[k] = err
    assert not bad, bad
    # the saved EMA weights equal JAX's ema_params (a copy before step 10)
    path = tsur.save_surrogate(state, str(tmp_path / "sur"), "boundary_updater")
    saved = torch.load(path, weights_only=True)
    ema = convert.flax_unet2dv2_to_state_dict(jax.device_get(jstate.ema_params))
    for k, v in saved.items():
        assert_close(v, ema[k], 1e-6)
