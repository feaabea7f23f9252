"""The port's smoke model and sampler against the JAX package at a small
size: UNet3D with weights carried from a flax tree (and back through
``convert_unet3d``), the SpatialUpsample alone, the smoke conditioning, the
guidance gradient, the two-model ``combine_w_with_guidance`` step, three
guided DDIM steps at eta 0, one at eta 1 with JAX's draw fed in, and
``evaluate_samples`` at the real shapes.

Tolerances (max |port - jax| <= rtol * max(1, max |jax|)):
- one UNet3D forward, model outputs: 1e-4, float32 sums in another order
  (GroupNorm and LayerNorm statistics, conv and attention reductions);
- conditioning: exact; guidance gradient: 1e-6, elementwise arithmetic;
- 3 guided DDIM steps from x_T: 2e-3. With the linear schedule
  sqrt(1/alphas_cumprod[999] - 1) ~ 157 carries the forwards' ~1e-6 gap
  into x_start, and the guidance scale 1e5 multiplies the gradient at it;
  clipping x_start to [-1, 1] bounds what is left;
- evaluate_samples: see the test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.benchmarks import smoke as jbench
from diffphycon_tpu.diffusion.conditioning import smoke_cond_spec as jax_smoke_cond
from diffphycon_tpu.nets.unet3d import SpatialUpsample as JaxUpsample
from diffphycon_tpu.nets.unet3d import UNet3D as JaxUNet3D
from diffphycon_tpu.nets.unet3d import t5_relative_position_buckets as jax_buckets
from diffphycon_tpu.physics.fluids.smoke_env import SmokeSim as JaxSmokeSim
from diffphycon_tpu.utils.torch_convert import convert_unet3d
from diffphycon_tpu_torch.benchmarks import smoke as tbench
from diffphycon_tpu_torch.diffusion.conditioning import smoke_cond_spec, smoke_derive_cond
from diffphycon_tpu_torch.nets.unet3d import UNet3D, t5_relative_position_buckets
from diffphycon_tpu_torch.physics.fluids.smoke_env import SmokeSim
from diffphycon_tpu_torch.utils.convert import load_flax_unet3d
from torch_port_helpers import assert_close, flax_tree, rand

SMALL = dict(dim=8, dim_mults=(1, 2), frames=4, image_size=16)
X_SHAPE = (2, 4, 16, 16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def nets():
    """JAX joint (6-channel) and prior (2-channel) UNet3D trees, their
    jitted applies, and the port's copies."""
    out = {}
    for ch, seed in ((6, 0), (2, 1)):
        net = JaxUNet3D(dim=8, dim_mults=(1, 2), channels=ch, out_dim=ch, resnet_groups=8)
        params = flax_tree(net, jnp.zeros((1, 4, 16, 16, ch)), jnp.zeros((1,)), seed=seed)
        port = load_flax_unet3d(UNet3D(dim=8, dim_mults=(1, 2), channels=ch, out_dim=ch),
                                params).eval()
        out[ch] = (jax.jit(net.apply), params, port)
    return out


@pytest.mark.parametrize("ch", [6, 2])
def test_port_unet3d_forward_with_carried_weights(nets, ch):
    apply, params, port = nets[ch]
    x = rand(*X_SHAPE, ch, seed=ch)
    t = np.array([3.0, 871.0], np.float32)
    ref = apply(params, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        out = port(_t(x), _t(t))
    assert_close(out, ref, 1e-4)


@pytest.mark.parametrize("ch", [6, 2])
def test_port_unet3d_state_dict_converts_to_the_flax_tree(nets, ch):
    _, params, port = nets[ch]
    back = _flat(convert_unet3d(port.state_dict(), num_levels=2))
    ref = _flat(params["params"])
    assert sorted(back) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


def test_port_spatial_upsample_alone():
    """flax stores the ConvTranspose3d kernel (kd, kh, kw, OUT, IN) and
    convolves the dilated input with it flipped and io-swapped; the port
    runs torch's ConvTranspose3d on the (IN, OUT, kd, kh, kw) weight."""
    mod = JaxUpsample(dim=12)
    x = rand(2, 3, 5, 6, 8, seed=11)
    params = flax_tree(mod, jnp.zeros((1, 3, 5, 6, 8)), seed=12)
    ref = mod.apply(params, jnp.asarray(x))
    up = torch.nn.ConvTranspose3d(8, 12, (1, 4, 4), (1, 2, 2), (0, 1, 1))
    p = params["params"]
    with torch.no_grad():
        up.weight.copy_(_t(np.transpose(p["kernel"], (4, 3, 0, 1, 2))))
        up.bias.copy_(_t(p["bias"]))
        out = up(_t(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    assert out.shape == (2, 3, 10, 12, 12)
    assert_close(out, ref, 1e-5)


def test_port_relative_position_buckets():
    for n in (4, 32, 40):
        np.testing.assert_array_equal(t5_relative_position_buckets(n), jax_buckets(n))


@pytest.mark.parametrize("is_w_model", [False, True])
def test_port_smoke_cond_spec(is_w_model):
    jc, tc = jax_smoke_cond(is_w_model), smoke_cond_spec(is_w_model)
    x = rand(*X_SHAPE, 6, seed=13)
    init = rand(2, 16, 16, seed=14)
    jv, tv = {"init": jnp.asarray(init)}, {"init": _t(init)}
    np.testing.assert_array_equal(tc.pin(_t(x), tv).numpy(), np.asarray(jc.pin(jnp.asarray(x), jv)))
    np.testing.assert_array_equal(tc.pin(_t(x), {}).numpy(), x)
    w_in = tc.w_zero_input(_t(x), tv)
    np.testing.assert_array_equal(w_in.numpy(), np.asarray(jc.w_zero_input(jnp.asarray(x), jv)))
    out_w = rand(*X_SHAPE, 2, seed=15)
    np.testing.assert_array_equal(tc.w_zero_output(_t(out_w), tv).numpy(),
                                  np.asarray(jc.w_zero_output(jnp.asarray(out_w), jv)))
    np.testing.assert_array_equal(smoke_derive_cond(_t(x))["init"].numpy(), x[:, 0, :, :, 0])
    for ch in (6, 2):  # the noise target: frame 0, channel 0 zeroed for both models
        target = rand(*X_SHAPE, ch, seed=20 + ch)
        zeroed = tc.zero_target(_t(target), tv).numpy()
        np.testing.assert_array_equal(zeroed, np.asarray(jc.zero_target(jnp.asarray(target), jv)))
        assert not zeroed[:, 0, :, :, 0].any() and (zeroed[:, 1:] == target[:, 1:]).all()


@pytest.mark.parametrize("ch", [6, 2])
def test_port_smoke_p_losses_matches_jax(nets, ch):
    """p_losses on the smoke spec (q_sample, the frame-0 pin, zero_target,
    loss_weight[t]) through the joint (C=6) and the w (C=2) UNet3D, fed
    JAX's noise: 1e-4, the UNet3D forwards' summation order."""
    apply, params, port = nets[ch]
    kw = dict(is_w_model=ch == 2, **SMALL)
    x = 0.5 * rand(*X_SHAPE, ch, seed=30 + ch)
    t = np.array([17, 903])
    key = jax.random.PRNGKey(ch)
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))
    jgd = jbench.build_diffusion(jbench.SmokeConfig(**kw), apply)
    ref = jgd.p_losses(params, key, jnp.asarray(x), jnp.asarray(t),
                       jbench.derive_cond(jnp.asarray(x)))
    tgd = tbench.build_diffusion(tbench.SmokeConfig(**kw), port, device="cpu")
    with torch.no_grad():
        out = tgd.p_losses(_t(x), _t(t), smoke_derive_cond(_t(x)), _t(noise))
    assert_close(out, ref, 1e-4)


@pytest.mark.parametrize("design,w_energy", [("standard", 0.0), ("standard", 0.5),
                                             ("standard-alpha", 0.1)])
def test_port_smoke_guidance(design, w_energy):
    kw = dict(design_guidance=design, w_energy=w_energy, coeff_ratio=2.0, **SMALL)
    jg = jbench.build_guidance(jbench.SmokeConfig(**kw))
    tg = tbench.build_guidance(tbench.SmokeConfig(**kw), device="cpu")
    x = 0.5 * rand(*X_SHAPE, 6, seed=16)
    assert_close(tg.nabla_j(_t(x)), jg.nabla_j(jnp.asarray(x)), 1e-6)
    assert_close(tg.j_schedule, jg.j_schedule, 1e-6)


def _pair(nets, **cfg_kw):
    (ja, jp, tj), (wa, wp, tw) = nets[6], nets[2]
    jcfg = jbench.SmokeConfig(**SMALL, **cfg_kw)
    tcfg = tbench.SmokeConfig(**SMALL, **cfg_kw)
    jgd = jbench.build_diffusion(jcfg, ja, model_w_apply=wa)
    tgd = tbench.build_diffusion(tcfg, tj, model_w=tw, device="cpu")
    init = 0.3 * rand(2, 16, 16, seed=17)
    return (jgd, jbench.build_guidance(jcfg), {"init": jnp.asarray(init)}, (jp, wp),
            tgd, tbench.build_guidance(tcfg, device="cpu"), {"init": _t(init)})


def test_port_two_model_combine_w_with_guidance(nets):
    jgd, jg, jc, params, tgd, tg, tc = _pair(nets)
    x = rand(*X_SHAPE, 6, seed=18)
    ref_eps, ref_w = jgd._raw_eps(params, jnp.asarray(x), 600, jc, jg)
    eps, eps_w = tgd._raw_eps(_t(x), 600, tc, tg)
    assert_close(eps, ref_eps, 1e-4)
    assert_close(eps_w, ref_w, 1e-4)
    ref = jgd.model_predictions(params, jnp.asarray(x), 600, jc, jg, clip_x_start=True,
                                rederive_pred_noise=True)
    out = tgd.model_predictions(_t(x), 600, tc, tg, clip_x_start=True,
                                rederive_pred_noise=True)
    for o, r in zip(out, ref):
        assert_close(o, r, 1e-4)


def test_port_three_guided_ddim_steps(nets):
    jgd, jg, jc, params, tgd, tg, tc = _pair(nets, ddim_sampling_steps=10, ddim_eta=0.0)
    x_t = rand(*X_SHAPE, 6, seed=19)
    ts, tns = jgd.sample_ts()
    body = jgd._make_ddim_body(params, jax.random.PRNGKey(0), jc, jg)
    ref = jnp.asarray(x_t)
    for t, tn in zip(np.asarray(ts[:3]), np.asarray(tns[:3])):
        ref, _ = body(ref, (jnp.int32(t), jnp.int32(tn)))
    steps = tgd.sample_ts()[:3]
    assert steps == list(zip(np.asarray(ts[:3]).tolist(), np.asarray(tns[:3]).tolist()))
    with torch.no_grad():
        out = tgd.sample_chunk(_t(x_t), steps, tc, tg)
    assert_close(out, ref, 2e-3)


def test_port_ddim_step_eta_one_with_jax_noise(nets):
    """The app's sampler: DDIM at eta 1 on the linear schedule, one guided
    step t=899 -> 799 with JAX's draw fed in. Limit 1e-3: the forwards'
    ~1e-6 gap reaches x_start through sqrt(1/alphas_cumprod[899] - 1) ~ 79."""
    jgd, jg, jc, params, tgd, tg, tc = _pair(nets, ddim_sampling_steps=10, ddim_eta=1.0)
    ts, tns = jgd.sample_ts()
    t, tn = int(ts[1]), int(tns[1])
    key = jax.random.PRNGKey(5)
    x = rand(*X_SHAPE, 6, seed=21)
    ref, _ = jgd._make_ddim_body(params, key, jc, jg)(jnp.asarray(x),
                                                      (jnp.int32(t), jnp.int32(tn)))
    noise = jax.random.normal(jax.random.fold_in(key, t), x.shape, jnp.float32)
    with torch.no_grad():
        out = tgd.ddim_step(_t(x), t, tn, tc, tg, noise=_t(noise))
    assert_close(out, ref, 1e-3)


def test_port_evaluate_samples_at_real_shapes():
    """pred and data of the real shapes (B=1, 32, 64, 64, 6); both sides
    re-simulate 255 frames with every solve capped at 20 CG iterations
    (cheap here, and the same iteration count on both sides). Limit 1e-4:
    the metrics are sums over the trajectory of 255 float32 steps that
    differ by rounding only."""
    rng = np.random.default_rng(20)
    pred = np.clip(0.5 * rng.normal(size=(1, 32, 64, 64, 6)), -1, 1).astype(np.float32)
    pred[..., 4] = np.abs(pred[..., 4])  # an updraft in the control ring
    data = np.zeros((1, 33, 64, 64, 6), np.float32)
    data[:, 0, 10:16, 28:36, 0] = 1.0
    ref = jbench.evaluate_samples(JaxSmokeSim.create(accuracy=1e-8, max_iterations=20),
                                  jnp.asarray(pred), jnp.asarray(data), w_energy=0.5)
    out = tbench.evaluate_samples(SmokeSim.create(accuracy=1e-8, max_iterations=20,
                                                  device="cpu"),
                                  _t(pred), _t(data), w_energy=0.5)
    assert set(out) == set(ref)
    for k in ref:
        assert_close(out[k], ref[k], 1e-4)
    assert float(out["sim_traj"][..., 5].abs().max()) > 0  # smoke reached a bucket
