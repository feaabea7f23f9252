"""The diffusion core's options against the JAX package at a small size
(UNet2D dim 8, mults (1, 2), weights through ``utils/convert.py``):
pred_x0 / pred_v (``loss_weight``, ``p_losses``, ``model_predictions``),
post-hoc guidance (``guidance_u0=False``) with both of JAX's noises fed in,
``CondSpec.transform`` in DDPM and DDIM, ``fuse_two_models``, the
self-conditioned UNet2D, ``normalize`` / ``unnormalize``, and the metrics'
``report_all`` / ``solver=``.

Tolerances (max |port - jax| <= rtol * max(1, max |jax|)):
- constants: exact (the same float64 numpy, the same float32 cast);
- losses: 1e-5 relative to the loss (snr weights reach ~1e4 at small t, so
  relative to the value, not to 1);
- model outputs and single steps: 1e-4, the UNet2D forwards differ by
  summation order only (~1e-6);
- DDIM steps at the end of the schedule: 1e-4 (no 1/sqrt(alphas_cumprod)
  amplification there);
- the two-model step against the two calls made by hand: bit-equal on the
  CPU (the forwards run one after the other);
- metrics: 1e-6, elementwise float32.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.benchmarks import burgers as jbench
from diffphycon_tpu.control.metrics import burgers_metric as jax_burgers_metric
from diffphycon_tpu.control.metrics import mse_deviation as jax_mse_deviation
from diffphycon_tpu.diffusion.core import DiffusionConstants as JaxConsts
from diffphycon_tpu.diffusion.core import GaussianDiffusion as JaxGD
from diffphycon_tpu.diffusion.core import GuidanceSpec as JaxGuidance
from diffphycon_tpu.nets.unet2d import UNet2D as JaxUNet2D
from diffphycon_tpu_torch.benchmarks import burgers as tbench
from diffphycon_tpu_torch.control.metrics import burgers_metric, mse_deviation
from diffphycon_tpu_torch.diffusion import core
from diffphycon_tpu_torch.diffusion.core import DiffusionConstants, GaussianDiffusion, GuidanceSpec
from diffphycon_tpu_torch.nets import UNet2D
from diffphycon_tpu_torch.utils.convert import load_flax_unet2d
from torch_port_helpers import assert_close, flax_tree, rand

CFG = dict(dim=8, dim_mults=(1, 2), is_condition_u0=True, is_condition_uT=True,
           prior_beta=0.5)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def nets():
    """JAX joint/prior UNet2D trees, the jitted apply and port copies."""
    net = JaxUNet2D(dim=8, dim_mults=(1, 2), channels=2, out_dim=2, resnet_block_groups=1)
    x0, t0 = jnp.zeros((2, 16, 128, 2)), jnp.zeros((2,))
    params = (flax_tree(net, x0, t0, seed=0), flax_tree(net, x0, t0, seed=1))
    cfg = tbench.BurgersConfig(**CFG)
    ports = [load_flax_unet2d(tbench.build_unet(cfg, "cpu"), p) for p in params]
    u_target = (0.5 * rand(2, 11, 128, seed=7)).astype(np.float32)
    return jax.jit(net.apply), params, ports, u_target


def _pair(nets, two_models=True, **cfg_kw):
    """(jax diffusion, guidance, cond, port diffusion, guidance, cond,
    params) for the Burgers config; attributes build_diffusion does not take
    (objective, guidance_u0) are set on both after, fuse_two_models on the
    JAX one only (the port has no such flag)."""
    apply, params, ports, u_target = nets
    extra = {k: cfg_kw.pop(k) for k in ("objective", "guidance_u0", "fuse_two_models")
             if k in cfg_kw}
    jcfg, tcfg = jbench.BurgersConfig(**CFG, **cfg_kw), tbench.BurgersConfig(**CFG, **cfg_kw)
    if two_models:
        jgd = jbench.build_diffusion(jcfg, apply, model_w_apply=apply)
        tgd = tbench.build_diffusion(tcfg, ports[0], model_w=ports[1], device="cpu")
    else:
        jgd = jbench.build_diffusion(jcfg, apply)
        tgd = tbench.build_diffusion(tcfg, ports[0], device="cpu")
        params = params[0]
    for k, v in extra.items():
        setattr(jgd, k, v)
        if k != "fuse_two_models":
            setattr(tgd, k, v)
        if k == "objective":
            jgd.consts = JaxConsts.create(jcfg.timesteps, jcfg.beta_schedule, v)
            tgd.consts = DiffusionConstants.create(tcfg.timesteps, tcfg.beta_schedule, v,
                                                   device="cpu")
    jg = jbench.build_guidance(jcfg, u_target, wu=1000.0, wf=0.1)
    tg = tbench.build_guidance(tcfg, _t(u_target), wu=1000.0, wf=0.1)
    cond = {"u0": u_target[:, 0] / 10.0, "uT": u_target[:, 10] / 10.0}
    return (jgd, jg, {k: jnp.asarray(v) for k, v in cond.items()},
            tgd, tg, {k: _t(v) for k, v in cond.items()}, params)


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0", "pred_v"])
def test_port_objective_loss_weight_exact(objective):
    ref = JaxConsts.create(100, "cosine", objective)
    out = DiffusionConstants.create(100, "cosine", objective, device="cpu")
    np.testing.assert_array_equal(out.loss_weight.numpy(), np.asarray(ref.loss_weight))
    with pytest.raises(ValueError, match="unknown objective"):
        DiffusionConstants.create(10, "cosine", "pred_eps", device="cpu")


@pytest.mark.parametrize("objective", ["pred_x0", "pred_v"])
def test_port_objective_p_losses(nets, objective):
    jgd, _, jc, tgd, _, tc, params = _pair(nets, two_models=False, objective=objective)
    x0 = 0.3 * rand(3, 16, 128, 2, seed=2)
    t = np.array([3, 400, 950], np.int32)
    key = jax.random.PRNGKey(4)
    noise = np.asarray(jax.random.normal(key, x0.shape, jnp.float32))
    cond = {k: v[:1].repeat(3, 0) for k, v in jc.items()}
    ref = float(jgd.p_losses(params, key, jnp.asarray(x0), jnp.asarray(t), cond))
    with torch.no_grad():
        out = float(tgd.p_losses(_t(x0), torch.from_numpy(t.astype(np.int64)),
                                 {k: _t(v) for k, v in cond.items()}, _t(noise)))
    assert abs(out - ref) <= 1e-5 * abs(ref), (out, ref)


@pytest.mark.parametrize("objective", ["pred_x0", "pred_v"])
@pytest.mark.parametrize("clip", [False, True])
def test_port_objective_model_predictions(nets, objective, clip):
    jgd, jg, jc, tgd, tg, tc, params = _pair(nets, objective=objective)
    x = rand(2, 16, 128, 2, seed=3)
    ref = jgd.model_predictions(params, jnp.asarray(x), 400, jc, jg, clip_x_start=clip,
                                rederive_pred_noise=True)
    out = tgd.model_predictions(_t(x), 400, tc, tg, clip_x_start=clip,
                                rederive_pred_noise=True)
    for o, r in zip(out, ref):
        assert_close(o, r, 1e-4)


@pytest.mark.parametrize("t", [500, 0])
def test_port_post_hoc_guidance_ddpm_step(nets, t):
    jgd, jg, jc, tgd, tg, tc, params = _pair(nets, guidance_u0=False)
    x = rand(2, 16, 128, 2, seed=4)
    key = jax.random.PRNGKey(11)
    ref, _ = jgd._make_ddpm_body(params, key, jc, jg)(jnp.asarray(x), jnp.int32(t))
    k_samp, k_guid, _ = jax.random.split(jax.random.fold_in(key, t), 3)
    n1, n2 = (jax.random.normal(k, x.shape, jnp.float32) for k in (k_samp, k_guid))
    out = tgd.ddpm_step(_t(x), t, tc, tg, noise=_t(n1), guided_noise=_t(n2))
    assert_close(out, ref, 1e-4)
    # the guidance moved the step: without it the result differs
    plain = tgd.ddpm_step(_t(x), t, tc, GuidanceSpec(), noise=_t(n1))
    assert float((out - plain).abs().max()) > 1e-3


def _transform_pair():
    def jf(x_new, x_start, cond, t):
        return 0.5 * x_new + 0.1 * jnp.tanh(x_start) + 1e-3 * t

    def tf(x_new, x_start, cond, t):
        return 0.5 * x_new + 0.1 * torch.tanh(x_start) + 1e-3 * t

    return jf, tf


def test_port_transform_in_ddpm(nets):
    jgd, jg, jc, tgd, tg, tc, params = _pair(nets)
    jf, tf = _transform_pair()
    jgd.cond, tgd.cond = (dataclasses.replace(jgd.cond, transform=jf),
                          dataclasses.replace(tgd.cond, transform=tf))
    x, t = rand(2, 16, 128, 2, seed=5), 300
    key = jax.random.PRNGKey(2)
    ref, _ = jgd._make_ddpm_body(params, key, jc, jg)(jnp.asarray(x), jnp.int32(t))
    k_samp = jax.random.split(jax.random.fold_in(key, t), 3)[0]
    noise = jax.random.normal(k_samp, x.shape, jnp.float32)
    assert_close(tgd.ddpm_step(_t(x), t, tc, tg, noise=_t(noise)), ref, 1e-4)


def test_port_transform_in_ddim_last_steps(nets):
    jgd, jg, jc, tgd, tg, tc, params = _pair(nets, using_ddim=True, ddim_sampling_steps=50)
    jf, tf = _transform_pair()
    jgd.cond, tgd.cond = (dataclasses.replace(jgd.cond, transform=jf),
                          dataclasses.replace(tgd.cond, transform=tf))
    x = 0.5 * rand(2, 16, 128, 2, seed=6)
    ts, tns = jgd.sample_ts()
    ref = jgd.sample_chunk(params, jax.random.PRNGKey(0), jnp.asarray(x),
                           (ts[-3:], tns[-3:]), jc, jg)
    steps = tgd.sample_ts()[-3:]
    assert steps[-1][1] < 0  # the last step returns the transformed x_start
    assert_close(tgd.sample_chunk(_t(x), steps, tc, tg), ref, 1e-4)


def _in_turn(model, x, model_w, x_w, tb):
    return model(x, tb), model_w(x_w, tb)


def test_port_fuse_two_models(nets):
    """The port's form of JAX's fuse_two_models is its only two-model path
    (``core.two_forwards``: two CUDA streams, on the CPU one forward after
    the other): against the two calls made by hand and JAX's fused step."""
    jgd, jg, jc, tgd, tg, tc, params = _pair(nets, fuse_two_models=True)
    x, t = rand(2, 16, 128, 2, seed=8), 450
    fused, _ = tgd._raw_eps(_t(x), t, tc, tg)
    with mock.patch.object(core, "two_forwards", _in_turn):
        two, _ = tgd._raw_eps(_t(x), t, tc, tg)
    assert torch.equal(fused, two)
    ref, _ = jgd._raw_eps(params, jnp.asarray(x), t, jc, jg)
    assert_close(fused, ref, 1e-4)
    key = jax.random.PRNGKey(5)
    ref_step, _ = jgd._make_ddpm_body(params, key, jc, jg)(jnp.asarray(x), jnp.int32(t))
    k_samp = jax.random.split(jax.random.fold_in(key, t), 3)[0]
    noise = _t(jax.random.normal(k_samp, x.shape, jnp.float32))
    step = tgd.ddpm_step(_t(x), t, tc, tg, noise=noise)
    with mock.patch.object(core, "two_forwards", _in_turn):
        assert torch.equal(step, tgd.ddpm_step(_t(x), t, tc, tg, noise=noise))
    assert_close(step, ref_step, 1e-4)


def test_port_self_condition_unet2d():
    jnet = JaxUNet2D(dim=8, dim_mults=(1, 2), channels=2, out_dim=2, self_condition=True)
    x, sc = rand(2, 16, 128, 2, seed=9), rand(2, 16, 128, 2, seed=10)
    t = np.array([10.0, 700.0], np.float32)
    params = flax_tree(jnet, jnp.asarray(x), jnp.asarray(t), seed=3)
    assert params["params"]["init_conv"]["kernel"].shape == (7, 7, 4, 8)
    net = load_flax_unet2d(UNet2D(dim=8, dim_mults=(1, 2), channels=2, out_dim=2,
                                  self_condition=True), params)
    assert net.init_conv.weight.shape == (8, 4, 7, 7)
    with torch.no_grad():
        for cond in (None, sc):
            ref = jnet.apply(params, jnp.asarray(x), jnp.asarray(t),
                             None if cond is None else jnp.asarray(cond))
            args = () if cond is None else (_t(cond),)
            assert_close(net(_t(x), _t(t), *args), ref, 1e-4)
            assert_close(net.forward_plain(_t(x), _t(t), *args), ref, 1e-4)


def test_port_normalize_unnormalize(nets):
    apply, params, ports, _ = nets
    norm, unnorm = (lambda x: 2 * x - 1), (lambda x: (x + 1) / 2)
    kw = dict(sample_shape=(16, 128, 2), timesteps=20)
    jgd = JaxGD(apply, normalize=norm, unnormalize=unnorm, **kw)
    tgd = GaussianDiffusion(ports[0], normalize=norm, unnormalize=unnorm, device="cpu", **kw)
    x0 = 0.5 + 0.2 * rand(2, 16, 128, 2, seed=11)
    key = jax.random.PRNGKey(7)
    ref = float(jgd.loss(params[0], key, jnp.asarray(x0), {}))
    kt, kn = jax.random.split(key)
    t = np.asarray(jax.random.randint(kt, (2,), 0, 20)).astype(np.int64)
    noise = np.asarray(jax.random.normal(kn, x0.shape, jnp.float32))
    with torch.no_grad():
        out = float(tgd.loss(_t(x0), {}, t=torch.from_numpy(t), noise=_t(noise)))
        assert out != float(tgd.p_losses(_t(x0), torch.from_numpy(t), {}, _t(noise)))
    assert abs(out - ref) <= 1e-5 * abs(ref), (out, ref)
    # sample unnormalizes what the steps produce; sample_chunk does not
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        out = tgd.sample(2, {}, GuidanceSpec(), generator=g)
        g = torch.Generator().manual_seed(0)
        raw = tgd.sample_chunk(tgd.sample_init(2, g), tgd.sample_ts(), {}, GuidanceSpec(), g)
    assert torch.equal(out, unnorm(raw))
    np.testing.assert_array_equal(np.asarray(jgd.sample_finalize(jnp.asarray(raw.numpy()))),
                                  unnorm(raw).numpy())


@pytest.mark.parametrize("po", [None, "front_rear_quarter"])
def test_port_mse_deviation_report_all(po):
    u1, u2 = rand(3, 11, 128, seed=12), rand(3, 11, 128, seed=13)
    ref = jax_mse_deviation(jnp.asarray(u1), jnp.asarray(u2), po, report_all=True)
    out = mse_deviation(_t(u1), _t(u2), po, report_all=True)
    assert len(out) == 4
    for o, r in zip(out, ref):
        assert_close(o, r, 1e-6)
    assert_close(mse_deviation(_t(u1), _t(u2), po), ref[0], 1e-6)


def test_port_burgers_metric_solver():
    """A stand-in solver (u0 plus the running sum of f) on both sides."""
    u_target, f = rand(3, 11, 128, seed=14), 0.1 * rand(3, 10, 128, seed=15)

    def jax_solver(u0, ff):
        return jnp.concatenate([u0[:, None], u0[:, None] + jnp.cumsum(ff, axis=1)], axis=1)

    calls = []

    def solver(u0, ff):
        calls.append(torch.is_grad_enabled())
        return torch.cat([u0[:, None], u0[:, None] + torch.cumsum(ff, dim=1)], dim=1)

    for pc in ("full", "front_rear_quarter"):
        (jall, jenergy) = jax_burgers_metric(jnp.asarray(u_target), jnp.asarray(f),
                                             partial_control=pc, report_all=True,
                                             solver=jax_solver)
        (tall, tenergy) = burgers_metric(_t(u_target), _t(f), partial_control=pc,
                                         report_all=True, solver=solver)
        for o, r in zip(tall, jall):
            assert_close(o, r, 1e-6)
        assert_close(tenergy, jenergy, 1e-6)
    assert calls == [False, False]  # the re-simulation runs without a gradient
