"""The bfloat16 UNet3D (the JAX ``UNet3D(dtype=jnp.bfloat16)``, flax's
compute dtype, the JAX bench's deployment dtype for smoke and jellyfish)
against the JAX package on the CPU, at a small size (dim 8, mults (1, 2),
batch 2 of 4 frames of 16x16).

Parameters stay float32 on both sides and carry across through
``utils/convert.py``; inputs are seeded numpy arrays, rounded to bfloat16
where the block receives bfloat16 in the net. Checked: every block type
against its JAX block on the same inputs, the dtype of every intermediate
flax captures (convs, denses, GroupNorms, ResnetBlocks and attentions
bfloat16; the channel LayerNorms and the upsample float32, the net's output
bfloat16), the whole net, that the bf16 forward is not the fp32 one, that
gradients reach the float32 parameters, the smoke ``p_losses`` and the
jellyfish EBM loss against JAX's, and that ``train_smoke`` /
``train_jellyfish --bf16 True`` keep float32 state.

Tolerances, max |port - jax| <= rtol * max(1, max |jax|). A bfloat16 value
carries 8 significant bits (a relative step of 2^-8 to 2^-7), and the two
frameworks sum each conv and matmul in another order before rounding, so
two correct implementations differ by a rounding step wherever a sum lands
near a tie, and GroupNorm and the softmaxes carry that on:
- one block on the same inputs: BLOCK_RTOL 2e-2 (measured 1.0e-3 to
  9.2e-3: one to two bf16 steps of the block's largest value);
- the whole net: NET_RTOL 5e-2 (measured 1.7e-2: ~40 blocks compound the
  steps; JAX's own bf16 and fp32 nets lie about as far apart);
- the bf16 forward against the port's fp32 forward: at least GUARD 1e-3
  apart (measured 1.4e-2; the fp32 port matches JAX fp32 to ~1e-6), so the
  net does run in bfloat16;
- the smoke p_losses and the EBM loss: LOSS_RTOL 2e-2 of the loss
  (measured 1.8e-4 and 3.1e-3).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.benchmarks import jellyfish as jjelly
from diffphycon_tpu.benchmarks import smoke as jsmoke
from diffphycon_tpu.nets import unet3d as J
from diffphycon_tpu.nets.blocks import TimeMLP
from diffphycon_tpu_torch.benchmarks import jellyfish as tjelly
from diffphycon_tpu_torch.benchmarks import smoke as tsmoke
from diffphycon_tpu_torch.diffusion import smoke_derive_cond
from diffphycon_tpu_torch.nets import unet3d as P
from diffphycon_tpu_torch.utils import convert
from torch_port_helpers import assert_close, flax_tree, rand

BF16 = torch.bfloat16
BLOCK_RTOL = 2e-2
NET_RTOL = 5e-2
GUARD = 1e-3
LOSS_RTOL = 2e-2
B, FR, H, C = 2, 4, 16, 6
T = np.array([3.0, 700.0], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jf32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _cf(x):  # torch (B, F, H, W, C) -> (B, C, F, H, W)
    return x.permute(0, 4, 1, 2, 3)


def _cl(x):  # back
    return x.permute(0, 2, 3, 4, 1)


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    return module


def _sub(sd_fn, tree, prefix=""):
    """The state_dict entries ``sd_fn`` writes for ``tree``, keys relative
    to the module, with ``prefix``."""
    sd = {}
    sd_fn(tree, "m", sd)
    return {prefix + k[2:]: v for k, v in sd.items()}


def _attn_sd(tree, prefix):
    return {f"{prefix}to_qkv.weight": np.transpose(np.asarray(tree["to_qkv"]["kernel"])),
            f"{prefix}to_out.weight": np.transpose(np.asarray(tree["to_out"]["kernel"]))}


def _bf(shape, seed):
    """Seeded values rounded to bfloat16 (the same bits on both sides)."""
    return np.asarray(jnp.asarray(rand(*shape, seed=seed), jnp.bfloat16))


def _block_case(name):
    """(jax module, jax inputs, port module maker (params -> module), port
    call (module, torch inputs) -> channels-last output)."""
    x8, x16 = _bf((B, FR, H, H, 8), 1), _bf((B, FR, H, H, 16), 2)
    temb = _bf((B, 32), 3)
    pos = np.asarray(rand(4, FR, FR, seed=4))
    f32 = rand(B, FR, H, H, 16, seed=5)

    def cf_call(m, x, *rest):
        return _cl(m(_cf(x), *rest))

    if name == "resnet_res_conv":
        return (J.ResnetBlock3D(16, 8, jnp.bfloat16), (x8, temb),
                lambda p: _load(P.ResnetBlock(8, 16, 32, 8, BF16),
                                _sub(convert._resnet_block3d, p["params"])), cf_call)
    if name == "resnet":
        return (J.ResnetBlock3D(16, 8, jnp.bfloat16), (x16, temb),
                lambda p: _load(P.ResnetBlock(16, 16, 32, 8, BF16),
                                _sub(convert._resnet_block3d, p["params"])), cf_call)
    if name == "chan_layer_norm":
        return (J.ChanLayerNorm3D(16, jnp.bfloat16), (x16,),
                lambda p: _load(P.LayerNorm(16), {"gamma": np.asarray(
                    p["params"]["gamma"]).reshape(1, -1, 1, 1, 1)}), cf_call)
    if name == "temporal_attention":
        return (J.TemporalAttention(16, dtype=jnp.bfloat16), (f32, pos),
                lambda p: _load(P.TemporalTokens(P.Attention(16, rotary=True, dtype=BF16)),
                                _attn_sd(p["params"], "fn.")),
                lambda m, x, pb: cf_call(m, x, pb))
    if name == "spatial_linear_attention":
        return (J.SpatialLinearAttention3D(16, dtype=jnp.bfloat16), (f32,),
                lambda p: _load(P.SpatialLinearAttention(16, dtype=BF16), {
                    **_sub(convert._conv2d_from_3d, p["params"]["to_qkv"], "to_qkv."),
                    **_sub(convert._conv2d_from_3d, p["params"]["to_out"], "to_out.")}),
                cf_call)
    if name == "spatial_full_attention":
        return (J.SpatialFullAttention(16, dtype=jnp.bfloat16), (f32,),
                lambda p: _load(P.SpatialTokens(P.Attention(16, dtype=BF16)),
                                _attn_sd(p["params"], "fn.")), cf_call)
    if name == "downsample":
        return (J.SpatialDownsample(16, jnp.bfloat16), (x16,),
                lambda p: _load(P.Conv3d(16, 16, (1, 4, 4), (1, 2, 2), (0, 1, 1), dtype=BF16),
                                _sub(convert._conv3d, p["params"]["conv"])), cf_call)
    if name == "upsample":
        return (J.SpatialUpsample(16, jnp.bfloat16), (x16,),
                lambda p: _load(P.Upsample(16, BF16), {
                    "weight": np.transpose(np.asarray(p["params"]["kernel"]), (4, 3, 0, 1, 2)),
                    "bias": np.asarray(p["params"]["bias"])}), cf_call)
    assert name == "time_mlp"
    return (TimeMLP(8, 32, dtype=jnp.bfloat16), (T,),
            lambda p: _load(P.time_mlp(8, 32, BF16), {
                **_sub(convert._linear, p["params"]["fc1"], "1."),
                **_sub(convert._linear, p["params"]["fc2"], "3.")}),
            lambda m, t: m(t))


BLOCKS = ("resnet_res_conv", "resnet", "chan_layer_norm", "temporal_attention",
          "spatial_linear_attention", "spatial_full_attention", "downsample", "upsample",
          "time_mlp")


@pytest.mark.parametrize("name", BLOCKS)
def test_bf16_unet3d_block_matches_flax_bf16(name):
    jmod, inputs, make, call = _block_case(name)
    params = flax_tree(jmod, *(jnp.asarray(a) for a in inputs), seed=7)
    ref = jax.jit(jmod.apply)(params, *(jnp.asarray(a) for a in inputs))
    module = make(params)
    with torch.no_grad():
        out = call(module, *(_t(a) if a.dtype != jnp.bfloat16 else _t(_jf32(a)).to(BF16)
                             for a in inputs))
    assert str(out.dtype).split(".")[-1] == str(ref.dtype), (out.dtype, ref.dtype)
    assert all(p.dtype == torch.float32 for p in module.parameters())
    assert_close(out.float(), _jf32(ref), BLOCK_RTOL)


def _port_name(path: str) -> str:
    """The port module of a flax intermediate's path (``a/b/c``; '' the net)."""
    if not path:
        return ""
    head, *rest = path.split("/")
    sub = "." + ".".join(rest) if rest else ""
    m = re.fullmatch(r"(down|up)_(\d)_(block1|block2|sattn_norm|sattn|tattn_norm|tattn|"
                     r"downsample|upsample)", head)
    if m:
        side, i, part = m.groups()
        key = f"{side}s.{i}"
        block = {"block1": ".0", "block2": ".1"}.get(part)
        if block:
            return key + block + sub
        if part in ("downsample", "upsample"):
            return key + ".4"
        slot = ".2" if part.startswith("s") else ".3"
        if part.endswith("norm"):
            return key + slot + ".fn.norm"
        return key + slot + (".fn.fn" + sub if part == "sattn" else ".fn.fn" + (
            ".fn" + sub if rest else ""))
    fixed = {"init_conv": "init_conv", "init_attn_norm": "init_temporal_attn.fn.norm",
             "mid_block1": "mid_block1", "mid_block2": "mid_block2",
             "mid_sattn_norm": "mid_spatial_attn.fn.norm",
             "mid_tattn_norm": "mid_temporal_attn.fn.norm",
             "final_block": "final_conv.0", "final_conv": "final_conv.1"}
    if head in fixed:
        return fixed[head] + sub
    if head == "time_mlp":
        return "time_mlp" + {"": "", ".fc1": ".1", ".fc2": ".3"}[sub]
    tokens = {"init_temporal_attn": "init_temporal_attn", "mid_sattn": "mid_spatial_attn",
              "mid_tattn": "mid_temporal_attn"}[head]
    return tokens + ".fn.fn" + (".fn" + sub if rest else "")


@pytest.fixture(scope="module")
def whole():
    """The JAX bf16 net (jitted, intermediates captured) and the port's bf16
    and fp32 nets on the same float32 parameters."""
    x = rand(B, FR, H, H, C, seed=11)
    jnet = J.UNet3D(dim=8, dim_mults=(1, 2), channels=C, out_dim=C, dtype=jnp.bfloat16)
    params = flax_tree(jnet, jnp.asarray(x), jnp.asarray(T), seed=3)
    ref, inter = jax.jit(lambda p, a, t: jnet.apply(
        p, a, t, capture_intermediates=True, mutable=["intermediates"]))(params, x, T)
    nets = {dt: convert.load_flax_unet3d(
        P.UNet3D(dim=8, dim_mults=(1, 2), channels=C, out_dim=C, dtype=dt), params)
        for dt in (BF16, torch.float32)}
    return x, params, ref, inter["intermediates"], nets


def test_bf16_unet3d_intermediate_dtypes_match_flax(whole):
    x, _, ref, inter, nets = whole
    net = nets[BF16]
    captured = {}
    paths = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(inter)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        assert keys[-2:] == ["__call__", "0"], keys
        name = "/".join(k for k in keys if k not in ("__call__", "0"))
        paths[_port_name(name)] = (name, leaf)
    hooks = [net.get_submodule(n).register_forward_hook(
        lambda m, i, o, n=n: captured.__setitem__(n, o)) for n in paths if n]
    with torch.no_grad():
        captured[""] = net(_t(x), _t(T))
    for h in hooks:
        h.remove()
    assert len(paths) > 90 and set(captured) == set(paths)
    for n, (name, leaf) in paths.items():
        assert str(captured[n].dtype).split(".")[-1] == str(leaf.dtype), (name, n)
    dtypes = {name: str(leaf.dtype) for name, leaf in paths.values()}
    for name in ("init_attn_norm", "down_0_sattn_norm", "mid_tattn_norm", "up_0_upsample"):
        assert dtypes[name] == "float32", name
    for name in ("init_conv", "time_mlp/fc1", "down_1_block1/mlp", "down_1_block1/block1/proj",
                 "down_1_block1/block1/norm", "down_1_block1/res_conv", "down_1_block1",
                 "down_0_sattn", "down_0_tattn", "down_0_tattn/to_qkv", "mid_sattn",
                 "up_1_block1", "final_conv", ""):
        assert dtypes[name] == "bfloat16", name


def test_bf16_unet3d_matches_flax_bf16(whole):
    x, _, ref, _, nets = whole
    with torch.no_grad():
        out = nets[BF16](_t(x), _t(T))
        out32 = nets[torch.float32](_t(x), _t(T))
    assert out.dtype == BF16 and out32.dtype == torch.float32
    assert_close(out.float(), _jf32(ref), NET_RTOL)
    gap = float((out.float() - out32).abs().max()) / max(1.0, float(out32.abs().max()))
    assert gap >= GUARD, gap


def test_bf16_unet3d_rotary_angles_stay_fp32():
    """Under bf16 the temporal attention rotates q and k with float32
    angles, so its logits are float32 (JAX ``apply_rotary`` of fp32 cos/sin);
    rounding the angles to bf16 would move them by up to 2^-8 rad."""
    attn = P.Attention(16, rotary=True, dtype=BF16)
    seen = {}
    orig = P.apply_rotary

    def spy(x, ang):
        seen[x.dtype] = ang.dtype
        return orig(x, ang)

    P.apply_rotary = spy
    try:
        with torch.no_grad():
            attn(torch.randn(3, FR, 16))
    finally:
        P.apply_rotary = orig
    assert seen == {BF16: torch.float32}


def test_bf16_unet3d_gradients_reach_fp32_parameters(whole):
    x, _, _, _, nets = whole
    net = nets[BF16]
    net.zero_grad()
    out = net(_t(x), _t(T))
    (out.float() ** 2).mean().backward()
    grads = {k: p.grad for k, p in net.named_parameters()}
    assert all(g is not None and g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads.values())
    assert sum(float(g.abs().sum()) > 0 for g in grads.values()) >= len(grads) - 12
    net.zero_grad()


SMALL = dict(dim=8, dim_mults=(1, 2), frames=FR, image_size=H)


def test_bf16_smoke_p_losses_matches_jax():
    """The smoke spec's p_losses (q_sample, frame-0 pin, zero_target,
    loss_weight[t]) through the bf16 joint UNet3D: the bf16 model output
    promotes against the float32 noise, as in JAX."""
    jnet = J.UNet3D(dim=8, dim_mults=(1, 2), channels=C, out_dim=C, dtype=jnp.bfloat16)
    params = flax_tree(jnet, jnp.zeros((1, FR, H, H, C)), jnp.zeros((1,)), seed=4)
    port = tsmoke.init_params(tsmoke.SmokeConfig(bf16=True, **SMALL), device="cpu")
    assert port.dtype == BF16
    convert.load_flax_unet3d(port, params)
    x = 0.5 * rand(B, FR, H, H, C, seed=36)
    t = np.array([17, 903])
    key = jax.random.PRNGKey(6)
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))
    jgd = jsmoke.build_diffusion(jsmoke.SmokeConfig(bf16=True, **SMALL), jax.jit(jnet.apply))
    ref = jgd.p_losses(params, key, jnp.asarray(x), jnp.asarray(t),
                       jsmoke.derive_cond(jnp.asarray(x)))
    tgd = tsmoke.build_diffusion(tsmoke.SmokeConfig(bf16=True, **SMALL), port, device="cpu")
    with torch.no_grad():
        out = tgd.p_losses(_t(x), _t(t), smoke_derive_cond(_t(x)), _t(noise))
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    assert abs(float(out) - float(ref)) <= LOSS_RTOL * abs(float(ref))


def test_bf16_jellyfish_ebm_loss_matches_jax():
    """The EBM loss (double backward through the bf16 joint net: the
    gradient of -sum(model(x)^2) with respect to the noisy state against
    the noise) and its parameter gradient on the port, against JAX's loss."""
    cfg = dict(dim=8, dim_mults=(1, 2), frames=FR, image_size=H, timesteps=20,
               beta_schedule="cosine")
    jnet = J.UNet3D(dim=8, dim_mults=(1, 2), channels=7, out_dim=4, dtype=jnp.bfloat16)
    params = flax_tree(jnet, jnp.zeros((1, FR, H, H, 7)), jnp.zeros((1,)), seed=0)
    jgd = jjelly.JellyfishDiffusion(jjelly.JellyfishConfig(bf16=True, **cfg), jnet.apply)
    rng = np.random.default_rng(0)
    state0 = rng.uniform(-1, 1, size=(B, FR, H, H, 3)).astype(np.float32)
    bd0 = rng.normal(size=(B, FR, H, H, 3)).astype(np.float32)
    thetas0 = rng.normal(size=(B, FR)).astype(np.float32)
    t = np.array([3, 17])
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, state0.shape, jnp.float32))
    ref = jax.jit(jgd.p_losses_states)(params, key, jnp.asarray(state0), jnp.asarray(bd0),
                                        jnp.asarray(thetas0), jnp.asarray(t))
    jcfg = tjelly.JellyfishConfig(bf16=True, **cfg)
    port = convert.load_flax_unet3d(tjelly.build_joint_unet(jcfg, device="cpu"), params)
    assert port.dtype == BF16
    gd = tjelly.JellyfishDiffusion(jcfg, port, device="cpu")
    loss = gd.p_losses_states(_t(state0), _t(bd0), _t(thetas0), _t(t), _t(noise))
    loss.backward()
    assert loss.dtype == torch.float32
    loss = float(loss.detach())
    assert abs(loss - float(ref)) <= LOSS_RTOL * abs(float(ref)), (loss, ref)
    grads = [p.grad for p in port.parameters()]
    assert all(g is not None and g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads)


def test_bf16_train_apps_keep_fp32_state(tmp_path):
    """``train_smoke`` and ``train_jellyfish --bf16 True`` (one step each)
    train the bf16 UNet3D with float32 parameters, Adam moments and EMA,
    and save them float32."""
    from diffphycon_tpu_torch.apps import generate_smoke, train_jellyfish, train_smoke
    from diffphycon_tpu_torch.training.data import synthetic_jellyfish
    from diffphycon_tpu_torch.training.trainer import Trainer

    generate_smoke.main(generate_smoke.build_parser().parse_args([
        "--device", "cpu", "--out", str(tmp_path / "sm"), "--n_test", "0", "--n_train", "1",
        "--batch", "1", "--max_iterations", "20", "--filter_rate", "-1",
        "--min_sum_rate", "-1", "--max_sum_rate", "1e9"]))
    synthetic_jellyfish(1, str(tmp_path / "jf" / "train_data"), seed=0)
    net = ["--dim", "8", "--dim_mults", "1", "2", "--frames", "2", "--bf16", "True",
           "--device", "cpu", "--train_num_steps", "1", "--checkpoint_interval", "1",
           "--batch_size", "1"]
    runs = {
        "smoke": train_smoke.main(train_smoke.build_parser().parse_args(
            net + ["--dataset_path", str(tmp_path / "sm"),
                   "--results_folder", str(tmp_path / "smoke")])),
        "jellyfish": train_jellyfish.main(train_jellyfish.build_parser().parse_args(
            net + ["--dataset_path", str(tmp_path / "jf"), "--model_type", "states",
                   "--results_folder", str(tmp_path / "jellyfish")])),
    }
    for name, tr in runs.items():
        assert tr.step == 1 and tr.model.dtype == BF16, name
        assert all(p.dtype == torch.float32 for p in tr.params + tr.ema), name
        moments = [v for st in tr.optimizer.state.values() for k, v in st.items() if k != "step"]
        assert moments and all(v.dtype == torch.float32 for v in moments), name
        for use_ema in (False, True):
            saved = Trainer.load_params(str(tmp_path / name), 1, use_ema=use_ema)
            assert saved and all(v.dtype == torch.float32 for v in saved.values()), name
