"""The port's jellyfish thetas loss, guidance and geometry against the JAX
package on the CPU, at a small size (UNet3D dim 8, mults (1, 2), 4 frames
of 16x16; UNet2Dv2 / ForceUNet dim 8, mults (1, 2)): the thetas loss with
JAX's t and noise fed in (cond_steps 1 and 0); ``make_force_design_fn``
against ``jax.grad``; ``reg_theta`` and ``jellyfish_objective``; the force
integral ``compute_pressforce`` and ``compute_pressforce_from_mask`` on a
synthetic frame. The EBM loss is in test_torch_port_jellyfish_ebm.py.

Tolerances (max |port - jax| <= rtol * max(1, max |jax|)):
- the thetas loss: 1e-5, the net's float32 sums in another order;
- the guidance gradient: 1e-5 (one backward through two nets);
- objective, reg_theta: 1e-6; the force integral: 1e-5 (float32 sums of
  ~100 segment terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.benchmarks import jellyfish as jbench
from diffphycon_tpu.control import geometry as jgeo
from diffphycon_tpu.control.metrics import jellyfish_objective as jax_objective
from diffphycon_tpu.nets.unet2dv2 import ForceUNet as JaxForceUNet
from diffphycon_tpu.nets.unet2dv2 import UNet2Dv2 as JaxUNet2Dv2
from diffphycon_tpu.nets.unet3d import UNet3D as JaxUNet3D
from diffphycon_tpu.training.data import synthetic_jellyfish
from diffphycon_tpu_torch.benchmarks import jellyfish as tbench
from diffphycon_tpu_torch.control import geometry as tgeo
from diffphycon_tpu_torch.control.metrics import jellyfish_objective
from diffphycon_tpu_torch.nets.unet2dv2 import ForceUNet, UNet2Dv2
from diffphycon_tpu_torch.nets.unet3d import UNet3D
from diffphycon_tpu_torch.utils import convert
from torch_port_helpers import assert_close, flax_tree, rand

F, H, B = 4, 16, 2
CFG = dict(dim=8, dim_mults=(1, 2), frames=F, image_size=H, timesteps=20,
           beta_schedule="cosine")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def nets():
    """JAX trees of the thetas (7 -> 1) UNet3D, the bd-updater and the
    ForceUNet."""
    out = {}
    net = JaxUNet3D(dim=8, dim_mults=(1, 2), channels=7, out_dim=1)
    out["thetas"] = (net, flax_tree(net, jnp.zeros((1, F, H, H, 7)), jnp.zeros((1,)), seed=1))
    bd = JaxUNet2Dv2(dim=8, dim_mults=(1, 2), channels=3, out_dim=3)
    out["bd"] = (bd, flax_tree(bd, jnp.zeros((1, H, H, 3)), jnp.zeros((1,)), seed=2))
    force = JaxForceUNet(dim=8, dim_mults=(1, 2), channels=4)
    out["force"] = (force, flax_tree(force, jnp.zeros((1, H, H, 4)), seed=3))
    return out


def _port_unet3d(nets, name, **kw):
    net, p = nets[name]
    return convert.load_flax_unet3d(
        UNet3D(dim=8, dim_mults=(1, 2), channels=7, out_dim=net.out_dim, **kw), p)


def _batch(seed):
    rng = np.random.default_rng(seed)
    state0 = rng.uniform(-1, 1, size=(B, F, H, H, 3)).astype(np.float32)
    bd0 = rng.normal(size=(B, F, H, H, 3)).astype(np.float32)
    thetas0 = rng.normal(size=(B, F)).astype(np.float32)
    return state0, bd0, thetas0


def test_port_p_losses_thetas_matches_jax(nets):
    net, p = nets["thetas"]
    jgd = jbench.JellyfishDiffusion(jbench.JellyfishConfig(**CFG), None, thetas_apply=net.apply)
    state0, bd0, thetas0 = _batch(1)
    t = np.array([0, 12])
    key = jax.random.PRNGKey(8)
    k_bd, k_th = jax.random.split(key)
    noise_bd = np.asarray(jax.random.normal(k_bd, bd0.shape))
    noise_th = np.asarray(jax.random.normal(k_th, (B, F, H, H, 1)))
    gd = tbench.JellyfishDiffusion(tbench.JellyfishConfig(**CFG), None,
                                   thetas_model=_port_unet3d(nets, "thetas").eval(),
                                   device="cpu")
    for cs in (1, 0):
        jgd.cfg.cond_steps = gd.cfg.cond_steps = cs
        ref = float(jax.jit(jgd.p_losses_thetas)(p, key, jnp.asarray(state0),
                                                 jnp.asarray(bd0), jnp.asarray(thetas0),
                                                 jnp.asarray(t)))
        with torch.no_grad():
            out = float(gd.p_losses_thetas(_t(state0), _t(bd0), _t(thetas0), _t(t),
                                           _t(noise_bd), _t(noise_th)))
        assert abs(out - ref) <= 1e-5 * max(1.0, abs(ref)), (cs, out, ref)


def test_port_force_design_fn_matches_jax_grad(nets):
    (bd_net, pb), (f_net, pf) = nets["bd"], nets["force"]
    cfg = dict(CFG, reg_ratio=0.1)
    jfn = jbench.make_force_design_fn(jbench.JellyfishConfig(**cfg), f_net.apply, pf,
                                      bd_net.apply, pb, p_min=-2.0, p_max=3.0)
    bd_port = convert.load_flax_unet2dv2(UNet2Dv2(dim=8, dim_mults=(1, 2), channels=3), pb)
    f_port = convert.load_flax_force_unet(ForceUNet(dim=8, dim_mults=(1, 2), channels=4), pf)
    fn = tbench.make_force_design_fn(tbench.JellyfishConfig(**cfg), f_port.eval(),
                                     bd_port.eval(), p_min=-2.0, p_max=3.0)
    x4 = np.random.default_rng(4).uniform(-1, 1, size=(B, F, H, H, 4)).astype(np.float32)
    bd0e = np.broadcast_to(rand(B, 1, H, H, 3, seed=5), (B, F, H, H, 3)).copy()
    ref = jax.jit(jfn)(jnp.asarray(x4), jnp.asarray(bd0e))
    with torch.no_grad():  # the sampler calls it without autograd
        out = fn(_t(x4), _t(bd0e))
    assert not out.requires_grad
    assert float(np.abs(np.asarray(ref)).max()) > 0
    assert_close(out, ref, 1e-5)
    assert all(p.grad is None for p in list(bd_port.parameters()) + list(f_port.parameters()))


def test_port_reg_theta_and_objective_match_jax():
    th = rand(3, F, seed=6)
    forces = rand(3, F, seed=7)
    assert_close(tbench.reg_theta(_t(th)), jbench.reg_theta(jnp.asarray(th)), 1e-6)
    d = th[:, 1:] - th[:, :-1]
    for reg in (0.0, 0.3):
        assert_close(jellyfish_objective(_t(forces), _t(d), reg),
                     jax_objective(forces, d, reg), 1e-6)


@pytest.fixture(scope="module")
def frame(tmp_path_factory):
    """One synthetic frame: raw pressure (64, 64) and mask+offsets (62, 62, 3)."""
    root = tmp_path_factory.mktemp("jf")
    synthetic_jellyfish(1, str(root), frames_total=3, seed=2)
    st = np.load(root / "states" / "sim_000000.npz")["a"]
    bd = np.load(root / "bdry_merged_mask_offsets" / "sim_000000.npz")["a"]
    pressure = st[1, 2] * 7.0 + rand(64, 64, seed=8)
    return pressure.astype(np.float32), bd[1]


def test_port_compute_pressforce_matches_jax(frame):
    pressure, _ = frame
    ang = np.linspace(0, 2 * np.pi, 57, endpoint=False)
    boundary = np.stack([31.3 + 9.5 * np.cos(ang), 20.2 + 4.1 * np.sin(ang)], 1)
    ref = jgeo.compute_pressforce(jnp.asarray(pressure), jnp.asarray(boundary))
    out = tgeo.compute_pressforce(_t(pressure), torch.as_tensor(boundary, dtype=torch.float32))
    assert_close(torch.stack(out), np.stack([np.asarray(r) for r in ref]), 1e-5)
    # differentiable in the pressure, as the guidance needs
    p = _t(pressure).requires_grad_(True)
    tgeo.compute_pressforce(p, torch.as_tensor(boundary, dtype=torch.float32))[0].backward()
    assert p.grad.abs().sum() > 0


def test_port_compute_pressforce_from_mask_matches_jax(frame):
    pressure, mask_offsets = frame
    ref = jgeo.compute_pressforce_from_mask(pressure, mask_offsets, pad_shift=1.0)
    out = tgeo.compute_pressforce_from_mask(pressure, mask_offsets, pad_shift=1.0, device="cpu")
    assert out.shape == ref.shape and out.shape[0] >= 2  # two wings
    assert out.dtype == np.float32
    assert_close(_t(out), ref, 1e-5)
    np.testing.assert_array_equal(tgeo.find_clusters_fast(mask_offsets[..., 0] > 0.5),
                                  jgeo.find_clusters_fast(mask_offsets[..., 0] > 0.5))
