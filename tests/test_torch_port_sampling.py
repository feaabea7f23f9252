"""The port's sampling path against the JAX package at a small size: schedule
constants, the guidance gradient, two-model prior reweighting, one DDPM
step fed JAX's noise and 5 DDIM steps from a shared x_T
(``evaluate_samples`` and the app: ``test_torch_port_eval.py``).

Tolerances (max |port - jax| <= rtol * max(1, max |jax|)):
- constants: exact (same float64 numpy build, same float32 cast);
- guidance gradient: 1e-5, elementwise float32 arithmetic;
- model outputs and one DDPM step at t=500: 1e-4, the UNet2D forwards differ
  by summation order only (~1e-6);
- 5 DDIM steps from x_T: 2e-3. At t=999, x_start = x/sqrt(a) - sqrt(1/a-1)
  eps with a ~ 1e-8, so the forwards' ~1e-6 gap grows ~1e4-fold in x_start
  before sqrt(alphas_cumprod[t_next]) ~ 0.02 scales it back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.benchmarks import burgers as jbench
from diffphycon_tpu.control.guidance import burgers_guidance_from_x as jax_loss
from diffphycon_tpu.control.guidance import make_nabla_j as jax_nabla
from diffphycon_tpu.diffusion.conditioning import burgers_cond_spec as jax_cond
from diffphycon_tpu.diffusion.conditioning import get_proj_ep_orthogonal as jax_proj
from diffphycon_tpu.diffusion.core import DiffusionConstants as JaxConsts
from diffphycon_tpu.diffusion.schedules import make_guidance_schedule as jax_sched
from diffphycon_tpu.nets.unet2d import UNet2D as JaxUNet2D
from diffphycon_tpu_torch.benchmarks import burgers as tbench
from diffphycon_tpu_torch.control.guidance import burgers_guidance_from_x, make_nabla_j
from diffphycon_tpu_torch.diffusion.conditioning import burgers_cond_spec, get_proj_ep_orthogonal
from diffphycon_tpu_torch.diffusion.core import DiffusionConstants
from diffphycon_tpu_torch.diffusion.schedules import make_guidance_schedule
from diffphycon_tpu_torch.physics.burgers import make_burgers_data
from diffphycon_tpu_torch.utils.convert import load_flax_unet2d
from torch_port_helpers import assert_close, flax_tree, rand


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("schedule", ["cosine", "linear", "sigmoid"])
def test_port_diffusion_constants_exact(schedule):
    ref = JaxConsts.create(100, schedule)
    out = DiffusionConstants.create(100, schedule, device="cpu")
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev",
                 "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
                 "posterior_log_variance_clipped", "posterior_mean_coef1",
                 "posterior_mean_coef2"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    for name in (None, "cosine", "plain_cosine", "sigmoid", "sigmoid_flip"):
        np.testing.assert_array_equal(make_guidance_schedule(name, 100, "cpu").numpy(),
                                      np.asarray(jax_sched(name, 100)))


def test_port_q_and_predict_helpers_with_batched_t():
    jgd = jbench.build_diffusion(jbench.BurgersConfig(), None)
    tgd = tbench.build_diffusion(tbench.BurgersConfig(), None, device="cpu")
    x, eps = rand(3, 16, 128, 2), rand(3, 16, 128, 2, seed=1)
    t = np.array([0, 500, 999], np.int32)
    jx, jeps, jt = jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t)
    tx, teps, tt = _t(x), _t(eps), torch.from_numpy(t.astype(np.int64))
    for name in ("q_sample", "predict_start_from_noise", "predict_noise_from_start",
                 "predict_v", "predict_start_from_v"):
        ref = getattr(jgd, name)(jx, jt, jeps)
        assert_close(getattr(tgd, name)(tx, tt, teps), ref, 1e-5)
    for out, ref in zip(tgd.q_posterior(tx, teps, tt), jgd.q_posterior(jx, jeps, jt)):
        assert_close(out, ref, 1e-5)


@pytest.mark.parametrize("wu,wf,wreg,po", [(1000.0, 0.0, 0.0, None),
                                           (0.0, 10.0, 0.0, None),
                                           (50.0, 1.0, 2.0, None),
                                           (1000.0, 0.5, 0.0, "front_rear_quarter")])
def test_port_guidance_gradient(wu, wf, wreg, po):
    target, x = rand(3, 11, 128), 0.3 * rand(3, 16, 128, 2, seed=1)
    kw = dict(wu=wu, wf=wf, wreg=wreg, use_dist_reg=wreg != 0, partially_observed=po)
    ref = jax_nabla(jax_loss(jnp.asarray(target), **kw))(jnp.asarray(x))
    out = make_nabla_j(burgers_guidance_from_x(_t(target), **kw))(_t(x))
    assert_close(out, ref, 1e-5)


@pytest.mark.parametrize("unobserved_zero", [False, True])
def test_port_burgers_cond_spec(unobserved_zero):
    kw = dict(is_condition_u0=True, is_condition_uT=True,
              set_unobserved_to_zero_during_sampling=unobserved_zero)
    jc, tc = jax_cond(**kw), burgers_cond_spec(**kw)
    x, u0, uT = rand(2, 16, 128, 2), rand(2, 128, seed=1), rand(2, 128, seed=2)
    jv, tv = {"u0": jnp.asarray(u0), "uT": jnp.asarray(uT)}, {"u0": _t(u0), "uT": _t(uT)}
    for name in ("pin", "w_zero_input", "w_zero_output", "sampling_mask"):
        ref = getattr(jc, name)(jnp.asarray(x), jv)
        np.testing.assert_array_equal(getattr(tc, name)(_t(x), tv).numpy(), np.asarray(ref))


@pytest.mark.parametrize("norm", ["F", "1D_x", "1D_t"])
def test_port_orthogonal_projection(norm):
    ep, g = rand(2, 16, 128, 2), 0.1 * rand(2, 16, 128, 2, seed=1)
    ref = jax_proj(norm)(jnp.asarray(ep), jnp.asarray(g))
    assert_close(get_proj_ep_orthogonal(norm)(_t(ep), _t(g)), ref, 1e-5)


CFG = dict(dim=8, dim_mults=(1, 2), is_condition_u0=True, is_condition_uT=True,
           prior_beta=0.5)


@pytest.fixture(scope="module")
def two_models():
    """JAX joint/prior UNet2D trees, their jitted apply and port copies."""
    net = JaxUNet2D(dim=8, dim_mults=(1, 2), channels=2, out_dim=2, resnet_block_groups=1)
    x0, t0 = jnp.zeros((2, 16, 128, 2)), jnp.zeros((2,))
    params = (flax_tree(net, x0, t0, seed=0), flax_tree(net, x0, t0, seed=1))
    cfg = tbench.BurgersConfig(**CFG)
    ports = [load_flax_unet2d(tbench.build_unet(cfg, "cpu"), p) for p in params]
    target = make_burgers_data(2, seed=7)[0]
    u_target = np.repeat(target[:, None, :], 11, axis=1) * np.linspace(1, 0.5, 11)[None, :, None]
    u_target = u_target.astype(np.float32)
    return jax.jit(net.apply), params, ports, u_target


def _pair(two_models, w_scheduler=None, **cfg_kw):
    apply, params, ports, u_target = two_models
    jcfg = jbench.BurgersConfig(**CFG, **cfg_kw)
    tcfg = tbench.BurgersConfig(**CFG, **cfg_kw)
    jgd = jbench.build_diffusion(jcfg, apply, model_w_apply=apply)
    tgd = tbench.build_diffusion(tcfg, ports[0], model_w=ports[1], device="cpu")
    jg = jbench.build_guidance(jcfg, u_target, wu=1000.0, wf=0.1, w_scheduler=w_scheduler)
    tg = tbench.build_guidance(tcfg, _t(u_target), wu=1000.0, wf=0.1,
                               w_scheduler=w_scheduler)
    cond = {"u0": u_target[:, 0] / 10.0, "uT": u_target[:, 10] / 10.0}
    return (jgd, jg, {k: jnp.asarray(v) for k, v in cond.items()},
            tgd, tg, {k: _t(v) for k, v in cond.items()}, params)


@pytest.mark.parametrize("w_scheduler,normalize_beta", [(None, False), ("cosine", False),
                                                        (None, True)])
def test_port_two_model_raw_eps(two_models, w_scheduler, normalize_beta):
    jgd, jg, jc, tgd, tg, tc, params = _pair(two_models, w_scheduler,
                                             normalize_beta=normalize_beta)
    x = rand(2, 16, 128, 2, seed=3)
    ref, _ = jgd._raw_eps(params, jnp.asarray(x), 400, jc, jg)
    out, eps_w = tgd._raw_eps(_t(x), 400, tc, tg)
    assert eps_w is None
    assert_close(out, ref, 1e-4)


def test_port_prior_model_alone(two_models):
    apply, params, ports, u_target = two_models
    jgd = jbench.build_diffusion(jbench.BurgersConfig(**CFG, is_model_w=True), apply)
    tgd = tbench.build_diffusion(tbench.BurgersConfig(**CFG, is_model_w=True), ports[1],
                                 device="cpu")
    x = rand(2, 16, 128, 2, seed=8)
    ref, _ = jgd._raw_eps(params[1], jnp.asarray(x), 300, {}, jbench.GuidanceSpec())
    out, _ = tgd._raw_eps(_t(x), 300, {}, tbench.GuidanceSpec())
    assert_close(out, ref, 1e-4)
    assert float(out[..., 0].abs().max()) == 0.0  # p(w) never outputs u


def test_port_one_ddpm_step_with_jax_noise(two_models):
    jgd, jg, jc, tgd, tg, tc, params = _pair(two_models)
    x, t = rand(2, 16, 128, 2, seed=4), 500
    key = jax.random.PRNGKey(11)
    body = jgd._make_ddpm_body(params, key, jc, jg)
    ref, _ = body(jnp.asarray(x), jnp.int32(t))
    k_samp = jax.random.split(jax.random.fold_in(key, t), 3)[0]
    noise = jax.random.normal(k_samp, x.shape, jnp.float32)
    out = tgd.ddpm_step(_t(x), t, tc, tg, noise=_t(noise))
    assert_close(out, ref, 1e-4)


def test_port_ddpm_recurrence_at_t0(two_models):
    """At t=0 every noise term is masked, so the recurrence re-noising
    (sqrt(a_0 / a_prev_0) scaling, k=2 passes) is deterministic on both
    sides."""
    jgd, jg, jc, tgd, tg, tc, params = _pair(two_models, recurrence=True,
                                             recurrence_k=2)
    x = rand(2, 16, 128, 2, seed=9)
    body = jgd._make_ddpm_body(params, jax.random.PRNGKey(3), jc, jg)
    ref, _ = body(jnp.asarray(x), jnp.int32(0))
    out = tgd.ddpm_step(_t(x), 0, tc, tg, generator=torch.Generator().manual_seed(0))
    assert_close(out, ref, 1e-4)


def test_port_five_ddim_steps_from_shared_x_t(two_models):
    jgd, jg, jc, tgd, tg, tc, params = _pair(two_models, using_ddim=True,
                                             ddim_sampling_steps=50)
    x_t = rand(2, 16, 128, 2, seed=5)
    ts, tns = jgd.sample_ts()
    ref = jgd.sample_chunk(params, jax.random.PRNGKey(0), jnp.asarray(x_t),
                           (ts[:5], tns[:5]), jc, jg)
    steps = tgd.sample_ts()[:5]
    assert steps == list(zip(np.asarray(ts[:5]).tolist(), np.asarray(tns[:5]).tolist()))
    out = tgd.sample_chunk(_t(x_t), steps, tc, tg)
    assert_close(out, ref, 2e-3)
