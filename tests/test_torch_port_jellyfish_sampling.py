"""The port's jellyfish sampler and closed-loop pipeline against the JAX
package on the CPU.

The sampler's machinery is held with elementwise stand-in nets (the same
functions on both sides, as the JAX package's own sampler tests use them;
the nets themselves are held in test_torch_port_jellyfish*.py): JAX's x_T
and its per-step draws (``fold_in(key, t)``) are fed to the port's
``step``, over every DDPM step and over DDIM at eta 0, with cond_steps 1 and
0 (repaint), the force guidance through ``make_force_design_fn`` in both
forms ("standard" after the update or inside the model prediction, and
"standard-alpha"). ``sample_chunk`` in two chunks equals ``sample``.
``SurrogatePipeline.rollout`` runs small real nets (UNet2Dv2 simulator and
bd-updater, ForceUNet; dim 8, mults (1, 2), 16x16).

Tolerances (max |port - jax| <= rtol * max(1, max |jax|)):
- the sampler: 1e-5 (float32 elementwise arithmetic in another order,
  carried over up to 20 steps);
- sample_chunk against sample: exact;
- the rollout: 1e-4 (3 frames of net forwards compounding ~1e-6 gaps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.benchmarks import jellyfish as jbench
from diffphycon_tpu.nets.unet2dv2 import ForceUNet as JaxForceUNet
from diffphycon_tpu.nets.unet2dv2 import UNet2Dv2 as JaxUNet2Dv2
from diffphycon_tpu_torch.benchmarks import jellyfish as tbench
from diffphycon_tpu_torch.nets.unet2dv2 import ForceUNet, UNet2Dv2
from diffphycon_tpu_torch.utils import convert
from torch_port_helpers import assert_close, flax_tree

F, H, B = 4, 16, 2


def _cfg(mod, **kw):
    d = dict(dim=8, dim_mults=(1, 2), frames=F, image_size=H, cond_steps=1, timesteps=20,
             sampling_timesteps=20, beta_schedule="cosine", standard_fixed_ratio=0.05)
    d.update(kw)
    return mod.JellyfishConfig(**d)


def _t(a):
    return torch.from_numpy(np.array(a))


# stand-in nets: the same arithmetic in both packages
def _jax_joint(params, x, t):
    w = jnp.arange(1, x.shape[-1] + 1, dtype=x.dtype) / x.shape[-1]
    s = (x * w).sum(-1, keepdims=True)
    return jnp.concatenate([0.1 * s] * 4, axis=-1)


def _torch_joint(x, t):
    w = torch.arange(1, x.shape[-1] + 1, dtype=x.dtype) / x.shape[-1]
    s = (x * w).sum(-1, keepdim=True)
    return torch.cat([0.1 * s] * 4, dim=-1)


def _jax_thetas(params, x, t):
    return 0.2 * x.sum(-1, keepdims=True) / x.shape[-1]


def _torch_thetas(x, t):
    return 0.2 * x.sum(-1, keepdim=True) / x.shape[-1]


def _jax_bd(params, bd, delta):
    return bd * 0.9 + jnp.tanh(delta).reshape(-1, 1, 1, 1) * 0.01


def _torch_bd(bd, delta):
    return bd * 0.9 + torch.tanh(delta).reshape(-1, 1, 1, 1) * 0.01


def _jax_force(params, x):
    return (x[..., :1] * x[..., 1:2] + 0.3 * x[..., :1]).mean(axis=(1, 2))


def _torch_force(x):
    return (x[..., :1] * x[..., 1:2] + 0.3 * x[..., :1]).mean(dim=(1, 2))


def _conds(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, size=(B, H, H, 3)).astype(np.float32),
            rng.normal(size=(B, H, H, 3)).astype(np.float32),
            rng.normal(size=(B,)).astype(np.float32))


def _jax_draws(key, t, x4_shape, conds):
    """JAX's (posterior / eta noise, repaint noises) of step t."""
    k_noise, k_rp = jax.random.split(jax.random.fold_in(key, t))
    krs, krb, krt = jax.random.split(k_rp, 3)
    s0, b0, _ = conds
    rp = (jax.random.normal(krs, s0.shape), jax.random.normal(krb, b0.shape),
          jax.random.normal(krt, (B, 1, H, H, 1)))
    return _t(jax.random.normal(k_noise, x4_shape)), tuple(_t(a) for a in rp)


CASES = {
    "ddpm-cs1-standard": dict(),
    "ddpm-cs0-repaint": dict(cond_steps=0),
    "ddpm-cs1-inside-alpha": dict(use_guidance_in_model_predictions=True,
                                  design_guidance="standard-alpha", w_prob_exp=0.8),
    "ddim-cs1": dict(sampling_timesteps=5),
    "ddim-cs0-repaint": dict(sampling_timesteps=5, cond_steps=0, w_prob_exp=1.3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_guided_sampling_matches_jax_with_fed_draws(case):
    kw = dict(CASES[case], reg_ratio=0.2)
    jcfg, tcfg = _cfg(jbench, **kw), _cfg(tbench, **kw)
    jgd = jbench.JellyfishDiffusion(jcfg, _jax_joint, thetas_apply=_jax_thetas,
                                    bd_updater_apply=_jax_bd)
    gd = tbench.JellyfishDiffusion(tcfg, _torch_joint, thetas_model=_torch_thetas,
                                   bd_updater=_torch_bd, device="cpu")
    jfn = jbench.make_force_design_fn(jcfg, _jax_force, None, _jax_bd, None, -2.0, 3.0)
    fn = tbench.make_force_design_fn(tcfg, _torch_force, _torch_bd, -2.0, 3.0)
    conds = _conds(1)
    s0, b0, th0 = (jnp.asarray(a) for a in conds)
    k0, key = jax.random.split(jax.random.PRNGKey(7))
    x = jgd.sample_init(k0, s0, b0, th0)
    body, _ = jgd._make_body((None, None, None), key, s0, b0, th0, jfn)
    xt = _t(x)
    cond = gd._cond(*(_t(a) for a in conds))
    ts_port = gd.sample_ts()
    for ts in ts_port:
        t = ts[0] if isinstance(ts, tuple) else ts
        noise, rp = _jax_draws(key, t, (B, F, H, H, 4), conds)
        x, _ = body(x, tuple(jnp.int32(v) for v in ts) if isinstance(ts, tuple)
                    else jnp.int32(t))
        xt = gd.step(xt, ts, cond, fn, noise=noise, repaint_noise=rp)
        assert_close(xt, x, 1e-5)
    ref_states, ref_theta = jgd.sample_finalize(x)
    states, theta = gd.sample_finalize(xt)
    assert_close(states, ref_states, 1e-5)
    assert_close(theta, ref_theta, 1e-5)
    if tcfg.cond_steps:  # the conditions stay pinned
        assert torch.equal(states[:, 0], cond.state_0)
        assert_close(theta[:, -1], cond.thetas_0, 1e-6)


@pytest.mark.parametrize("kw", [dict(cond_steps=0), dict(sampling_timesteps=6, ddim_eta=0.5)])
def test_port_sample_chunk_equals_sample(kw):
    gd = tbench.JellyfishDiffusion(_cfg(tbench, **kw), _torch_joint, thetas_model=_torch_thetas,
                                   bd_updater=_torch_bd, device="cpu")
    fn = tbench.make_force_design_fn(gd.cfg, _torch_force, _torch_bd, -2.0, 3.0)
    conds = tuple(_t(a) for a in _conds(2))
    ref_states, ref_theta = gd.sample(*conds, design_fn=fn,
                                      generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    x = gd.sample_init(*conds, generator=gen)
    ts = gd.sample_ts()
    half = len(ts) // 2
    for part in (ts[:half], ts[half:]):
        x = gd.sample_chunk(x, part, *conds, design_fn=fn, generator=gen)
    states, theta = gd.sample_finalize(x)
    assert torch.equal(states, ref_states) and torch.equal(theta, ref_theta)
    assert torch.isfinite(states).all()


def test_port_surrogate_pipeline_rollout_matches_jax():
    sim = JaxUNet2Dv2(dim=8, dim_mults=(1, 2), channels=6, out_dim=3)
    bd = JaxUNet2Dv2(dim=8, dim_mults=(1, 2), channels=3, out_dim=3)
    force = JaxForceUNet(dim=8, dim_mults=(1, 2), channels=4)
    ps = flax_tree(sim, jnp.zeros((1, H, H, 6)), jnp.zeros((1,)), seed=1)
    pb = flax_tree(bd, jnp.zeros((1, H, H, 3)), jnp.zeros((1,)), seed=2)
    pf = flax_tree(force, jnp.zeros((1, H, H, 4)), seed=3)
    s0, b0, _ = _conds(4)
    thetas = np.random.default_rng(5).normal(size=(B, 3)).astype(np.float32)
    jppl = jbench.SurrogatePipeline(_cfg(jbench), sim.apply, ps, force.apply, pf, bd.apply, pb,
                                    p_min=-3.0, p_max=2.0)
    ref_states, ref_forces = jppl.rollout(jnp.asarray(s0), jnp.asarray(b0), jnp.asarray(thetas))
    ppl = tbench.SurrogatePipeline(
        _cfg(tbench),
        convert.load_flax_unet2dv2(UNet2Dv2(dim=8, dim_mults=(1, 2), channels=6, out_dim=3),
                                   ps).eval(),
        convert.load_flax_force_unet(ForceUNet(dim=8, dim_mults=(1, 2), channels=4), pf).eval(),
        convert.load_flax_unet2dv2(UNet2Dv2(dim=8, dim_mults=(1, 2), channels=3, out_dim=3),
                                   pb).eval(),
        p_min=-3.0, p_max=2.0)
    states, forces = ppl.rollout(_t(s0), _t(b0), _t(thetas))
    assert states.shape == (B, 3, H, H, 3) and forces.shape == (B, 3)
    assert torch.equal(states[:, 0], _t(s0))
    assert_close(states, ref_states, 1e-4)
    assert_close(forces, ref_forces, 1e-4)
