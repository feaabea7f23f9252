"""The flax ``dtype=bfloat16`` UNet2D (the JAX ``UNet2D(dtype=jnp.bfloat16)``,
which ``BurgersConfig(bf16=True)``, the Burgers bench and ``infer_burgers
--impl xla`` run) against the JAX package on the CPU, at a small size (dim 8,
mults (1, 2), input (2, 16, 32, 2)).

The port's ``UNet2D(dtype=torch.bfloat16)`` follows flax's rules with
explicit casts (``kernels/unet2d_blocks.py``, ``kernels/attention.py``,
``nets/unet2d.py``): bfloat16 activations between blocks; each conv and
Dense sums its bf16 x bf16 products in float32, rounds, adds its bias
rounded to bf16 and rounds again; GroupNorm in float32, rounded once; FiLM,
SiLU (XLA's ``1 / (1 + exp(-x))``), the softmaxes and the residual adds
rounded after every op; ChanLN with eps 1e-3, its statistics rounded. The
kernels' plain versions are held here; the bf16-activation kernels round in
the same order (K5's token softmax too: a max pass, a sum pass, then the
probabilities, as flax, not online), so no emulation differs from them, and
they are held against the plain versions on the card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py`` phase 18).

Parameters stay float32 and carry across through ``utils/convert.py`` as it
is. Inputs are seeded numpy arrays rounded to bfloat16 where a block
receives bfloat16 in the net.

Tolerances, max |port - jax| <= rtol * max(1, max |jax|), each beside the
gap measured here. The two frameworks round at the same points, so most
values are bit-equal and the rest differ where a float32 sum in another
order lands next to a rounding tie:
- one block: BLOCK_RTOL 1e-2 (measured 0 for the convs, the downsample, the
  upsample, both attention blocks and the two-source ResBlock; 1.2e-3 and
  3.2e-3, one bf16 step, for the one-source ResBlocks), and at most
  FLIP_SHARE 1% of its values differ at all (measured 0 to 0.27%; a
  rounding step left out or added, e.g. the linear attention's exps summed
  unrounded, moves 2-15% of the values);
- the whole net: NET_RTOL 5e-2 (measured 1.03e-2: a flipped value spreads
  through the ResBlocks' one GroupNorm group), the UNet3D's bound for the
  same cascade;
- the net differs from the weight-only bf16 net and from the float32 net by
  more than GUARD 1e-3 (measured 3.7e-2 and 3.3e-2), so neither stands in
  for it;
- p_losses: LOSS_RTOL 2e-2 of the loss (measured 2.4e-5), as for the UNet3D.
The two ``infer_burgers`` apps are held against each other in
``tests/test_torch_port_bf16_flax_apps.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from diffphycon_tpu.benchmarks import burgers as jbench
from diffphycon_tpu.nets import blocks as JB
from diffphycon_tpu.nets.unet2d import UNet2D as JaxUNet2D
from diffphycon_tpu_torch.benchmarks import burgers as tbench
from diffphycon_tpu_torch.kernels import attention as ka
from diffphycon_tpu_torch.kernels import unet2d_blocks as kb
from diffphycon_tpu_torch.kernels import unet2d_mega as kmega
from diffphycon_tpu_torch.nets.unet2d import UNet2D
from diffphycon_tpu_torch.utils.convert import load_flax_unet2d
from torch_port_helpers import assert_close, flax_tree, rand

BF16 = torch.bfloat16
BLOCK_RTOL = 1e-2
FLIP_SHARE = 0.01
NET_RTOL = 5e-2
GUARD = 1e-3
LOSS_RTOL = 2e-2
SHAPE = (2, 16, 32, 2)
T = np.array([3.0, 700.0], np.float32)


def _t(a):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))


def _bf(shape, seed, scale=1.0):
    """Seeded values rounded to bfloat16 (jax array; the same bits on both sides)."""
    return jnp.asarray(scale * rand(*shape, seed=seed)).astype(jnp.bfloat16)


def _flax_net():
    return JaxUNet2D(dim=8, dim_mults=(1, 2), channels=2, out_dim=2, resnet_block_groups=1,
                     dtype=jnp.bfloat16)


@pytest.fixture(scope="module")
def net():
    """(flax net, its tree, the port net on that tree, the port's packs)."""
    jnet = _flax_net()
    tree = flax_tree(jnet, jnp.zeros(SHAPE), jnp.zeros((2,)), seed=0)
    port = load_flax_unet2d(UNet2D(dim=8, dim_mults=(1, 2), dtype=BF16), tree).eval()
    with torch.no_grad():
        return jnet, tree, port, port.pack()


def _close(out, ref, rtol=BLOCK_RTOL):
    """assert_close, and the share of values that differ at all."""
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    out = out.detach().float().numpy()
    assert_close(out, ref, rtol)
    share = float(np.mean(out != ref))
    assert share <= FLIP_SHARE, share
    return share


BLOCKS = ("resnet_film", "resnet_film_res_conv_two_sources", "resnet_res_conv",
          "resnet_plain", "linear_attention", "attention", "downsample", "upsample",
          "conv3x3", "conv3x3_halo_rows", "conv3x3_halo_row_runs")


@pytest.mark.parametrize("name", BLOCKS)
def test_flax_bf16_block_matches_flax(net, name):
    """Each block's plain version on bfloat16 inputs against the flax block
    under dtype=bfloat16 with the same (converted) weights: the ResnetBlock
    with and without FiLM and res_conv (the two-source case reads the skip
    in place, as K1 does), both attention blocks, the downsample, the
    upsample and the last level's 3x3 conv, also through the persistent
    tile's halo A tile (emulated) on grids it takes a halo for."""
    _, tree, port, packs = net
    p = tree["params"]
    x8, x16 = _bf((2, 16, 32, 8), 1), _bf((2, 8, 16, 16), 2)
    temb = JB.TimeMLP(8, 32, dtype=jnp.bfloat16).apply({"params": p["time_mlp"]},
                                                       jnp.asarray(T))
    with torch.no_grad():
        film = port._film(torch.from_numpy(T), packs)
    widths = np.cumsum([0, *packs["film_widths"]])
    ss = {i: film[:, widths[i]:widths[i + 1]] for i in range(len(widths) - 1)}
    res_names = ["down_0_block1", "down_0_block2", "down_1_block1", "down_1_block2",
                 "mid_block1", "mid_block2", "up_0_block1", "up_0_block2", "up_1_block1",
                 "up_1_block2", "final_res_block"]
    with torch.no_grad():
        if name.startswith("resnet"):
            film_on = "film" in name
            if "res_conv" in name:  # up_0_block1: 16 + 8 -> 16 channels, a res_conv
                i, xa, xb = res_names.index("up_0_block1"), x16, _bf((2, 8, 16, 8), 3)
            else:  # mid_block1: 16 -> 16
                i, xa, xb = res_names.index("mid_block1"), x16, None
            co = 16
            two = name.endswith("two_sources")
            xin = jnp.concatenate([xa, xb], -1) if xb is not None else xa
            if xb is not None and not two:  # one source holding all 24 channels
                xa, xb = xin, None
            ref = JB.ResnetBlock(co, 1, jnp.bfloat16).apply(
                {"params": p[res_names[i]]}, xin, temb if film_on else None)
            out = kb.resblock_plain(_t(xa).to(BF16), ss[i] if film_on else None,
                                    packs["res"][i], x_b=None if xb is None else _t(xb).to(BF16))
        elif name == "linear_attention":
            ref = JB.LinearAttentionBlock(8, 4, 32, dtype=jnp.bfloat16).apply(
                {"params": p["down_0_attn"]}, x8)
            assert ref.dtype == jnp.float32  # the fp32 ChanLN gain promotes it
            ref = ref.astype(jnp.bfloat16)  # stored rounded: exact (test below)
            out = ka.linear_attention_block_plain(_t(x8).to(BF16), packs["down_attn"][0])
        elif name == "attention":
            ref = JB.AttentionBlock(16, 4, 32, dtype=jnp.bfloat16).apply(
                {"params": p["mid_attn"]}, x16)
            out = ka.attention_block_plain(_t(x16).to(BF16), packs["mid_attn"])
        elif name == "downsample":
            ref = JB.Downsample(8, jnp.bfloat16).apply({"params": p["down_0_downsample"]}, x8)
            d = packs["down"][0]
            out = kb.downsample_nhwc_plain(_t(x8).to(BF16), d["w"], d["b"])
        elif name == "upsample":
            ref = JB.Upsample(8, jnp.bfloat16).apply({"params": p["up_0_upsample"]}, x16)
            u = packs["up"][0]
            out = kb.conv2d_nhwc_plain(_t(x16).to(BF16), u["w"], u["b"], k=3, upsample=True)
        elif name.startswith("conv3x3_halo"):
            # the persistent tile's halo A tile (kb.halo_im2col, emulated)
            # summed as the kernel sums it, one float32 chain in its k
            # order, then flax's epilogue: grids of whole 64-pixel rows (bw
            # 64, bh 2) and of 128-pixel runs of one row (bw 128, bh 1)
            rows = name.endswith("rows")
            x = _bf((2, 2, 64, 8) if rows else (1, 1, 256, 8), 5)
            ref = nn.Conv(16, (3, 3), padding=1, dtype=jnp.bfloat16).apply(
                {"params": p["down_1_downsample"]}, x)
            d = packs["down"][1]
            a = kb.halo_im2col(_t(x).to(BF16).float(), None, *((64, 2) if rows else (128, 1)))
            out = kb.conv_bias_bf16(a @ d["w"].float(), d["b"]).reshape(*x.shape[:3], 16)
        else:
            x = _bf((2, 8, 16, 8), 4)  # the last level: 8 -> 16 channels at 8 x 16
            ref = nn.Conv(16, (3, 3), padding=1, dtype=jnp.bfloat16).apply(
                {"params": p["down_1_downsample"]}, x)
            d = packs["down"][1]
            out = kb.conv2d_nhwc_plain(_t(x).to(BF16), d["w"], d["b"], k=3)
    assert out.dtype == BF16
    _close(out, ref)


def test_flax_bf16_net_matches_flax(net):
    """The whole dim-8 net against ``UNet2D(dtype=bf16).apply``: bfloat16
    out, within NET_RTOL; the kernel-backed ``forward`` (plain versions on
    the CPU) equal to ``forward_plain``; apart from the weight-only bf16 net
    and the float32 net by more than GUARD."""
    jnet, tree, port, _ = net
    x = rand(*SHAPE, seed=5)
    ref = jnet.apply(tree, jnp.asarray(x), jnp.asarray(T))
    assert ref.dtype == jnp.bfloat16
    xt, tt = torch.from_numpy(x), torch.from_numpy(T)
    with torch.no_grad():
        out = port(xt, tt)
        assert out.dtype == BF16
        torch.testing.assert_close(out, port.forward_plain(xt, tt), rtol=0, atol=0)
        others = [load_flax_unet2d(UNet2D(dim=8, dim_mults=(1, 2), **kw), tree)(xt, tt)
                  for kw in ({"weight_dtype": BF16}, {})]
    assert_close(out.float(), _t(ref), NET_RTOL)
    for o in others:
        gap = float((out.float() - o).abs().max()) / max(1.0, float(o.abs().max()))
        assert gap > GUARD, gap


def test_flax_bf16_intermediate_dtypes_match_flax(net):
    """The storage finding. In the flax bf16 net every block's output is
    bfloat16 but the LinearAttentionBlocks' (float32: the ChanLN gain), and
    those feed only convs that round them to bfloat16: flax's output with
    each of them rounded to bfloat16 is bit-equal to flax's own. So the
    port stores every activation between kernels as bfloat16 (checked on
    its block sequence)."""
    jnet, tree, port, packs = net
    x, t = jnp.asarray(rand(*SHAPE, seed=6)), jnp.asarray(T)
    _, state = jnet.apply(tree, x, t, capture_intermediates=True, mutable=["intermediates"])
    dtypes = {k: v["__call__"][0].dtype for k, v in state["intermediates"].items()
              if k not in ("time_mlp", "__call__")}
    f32 = sorted(k for k, d in dtypes.items() if d == jnp.float32)
    assert f32 == ["down_0_attn", "down_1_attn", "up_0_attn", "up_1_attn"], dtypes
    assert all(d == jnp.bfloat16 for k, d in dtypes.items() if k not in f32)

    def round_attn(next_fun, args, kwargs, context):
        y = next_fun(*args, **kwargs)
        if isinstance(context.module, JB.LinearAttentionBlock):
            return y.astype(jnp.bfloat16)
        return y

    with nn.intercept_methods(round_attn):
        rounded = jnet.apply(tree, x, t)
    assert np.array_equal(np.asarray(rounded.astype(jnp.float32)),
                          np.asarray(jnet.apply(tree, x, t).astype(jnp.float32)))

    seen = []

    def wrap(fn):
        def run(*args, **kw):
            y = fn(*args, **kw)
            seen.append(y.dtype)
            return y
        return run

    ops = tuple(wrap(f) for f in kmega.PLAIN_OPS)
    with torch.no_grad():
        port._forward(torch.from_numpy(np.array(x)), torch.from_numpy(T), packs, ops)
    assert len(seen) == 20 and set(seen) == {BF16}


def test_flax_bf16_chan_ln_small_variance_separates_the_modes(net):
    """Tokens whose channels barely vary (variance ~1e-5, between the two
    eps): flax's bf16 ChanLayerNorm (eps 1e-3, rounded statistics) and the
    port's bf16-activation ChanLN agree bit for bit, and so do the linear
    attention blocks; the weight-only mode's ChanLN (eps 1e-5 on float32)
    and its block do not. This is the difference the two bf16 modes make."""
    _, tree, _, packs = net
    x = jnp.asarray(1.0 + 3e-3 * rand(2, 16, 32, 8, seed=7)).astype(jnp.bfloat16)
    g = 1 + 0.1 * rand(8, seed=8)
    ref = JB.ChanLayerNorm(8, dtype=jnp.bfloat16).apply({"params": {"g": jnp.asarray(g)}}, x)
    xt, gt = _t(x).to(BF16), torch.from_numpy(g)
    flax_mode = ka.chan_ln_bf16(xt, gt)
    weight_only = ka._chan_ln(xt.float(), gt)
    assert flax_mode.dtype == torch.float32 and ref.dtype == jnp.float32
    assert np.array_equal(flax_mode.numpy(), np.asarray(ref))
    gap = float((weight_only - _t(ref)).abs().max()) / float(np.abs(np.asarray(ref)).max())
    assert gap > 0.5, gap  # eps 1e-5 against 1e-3 at a variance of ~1e-5

    p = tree["params"]["down_0_attn"]
    blk = JB.LinearAttentionBlock(8, 4, 32, dtype=jnp.bfloat16).apply({"params": p}, x)
    with torch.no_grad():
        out = ka.linear_attention_block_plain(xt, packs["down_attn"][0])
        pw = {k: v.to(BF16) if k in ("wqkv", "wo") else v
              for k, v in packs["down_attn"][0].items()}
        out_w = ka.linear_attention_block_plain(xt.float(), pw)
    _close(out, blk.astype(jnp.bfloat16))
    gap_w = float((out_w - _t(blk)).abs().max()) / max(1.0, float(jnp.abs(blk).max()))
    assert gap_w > 100 * BLOCK_RTOL * 0.01 and gap_w > 0.05, gap_w


def test_flax_bf16_p_losses_match_jax_and_reach_fp32_params():
    """``p_losses`` of the flax bf16 net (u0/uT conditioning) against JAX's,
    fed JAX's t and noise (LOSS_RTOL), through the plain-VJP autograd path:
    every float32 parameter gets a float32 gradient."""
    kw = dict(dim=8, dim_mults=(1, 2), is_condition_u0=True, is_condition_uT=True)
    jnet = _flax_net()
    tree = flax_tree(jnet, jnp.zeros(SHAPE), jnp.zeros((2,)), seed=3)
    x = 0.3 * rand(*SHAPE, seed=9)
    t = np.array([17, 640])
    key = jax.random.PRNGKey(4)
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))
    jcfg = jbench.BurgersConfig(**kw, bf16=True)
    jgd = jbench.build_diffusion(jcfg, jbench.build_unet(jcfg).apply)
    ref = jgd.p_losses(tree, key, jnp.asarray(x), jnp.asarray(t),
                       jbench.derive_cond(jnp.asarray(x)))
    tcfg = tbench.BurgersConfig(**kw, bf16=True)
    model = load_flax_unet2d(tbench.build_unet(tcfg, "cpu"), tree).train()
    assert model.dtype == BF16
    tgd = tbench.build_diffusion(tcfg, model, device="cpu")
    xt = torch.from_numpy(x)
    loss = tgd.p_losses(xt, torch.from_numpy(t), tbench.derive_cond(xt), torch.from_numpy(noise))
    assert abs(loss.item() - float(ref)) <= LOSS_RTOL * abs(float(ref)), (loss.item(), float(ref))
    loss.backward()
    grads = [q.grad for q in model.parameters()]
    assert all(g is not None and g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads)
    assert all(float(g.abs().max()) > 0 for g in grads)
