"""bf16 weights on the port's Burgers UNet2D path against the JAX package.

The bf16 rule: the Pallas kernels under ``pack_unet2d_params(...,
weight_dtype=jnp.bfloat16)`` (``diffphycon_tpu/research/pallas_unet2d.py``),
which the port's ``UNet2D(weight_dtype=torch.bfloat16)`` follows on the CPU
(the plain versions) and on the card (the bf16 variants of K1/K2, K5, K6):

- The kernel packs hold the matmul weights in bfloat16, rounded to nearest
  even from the float32 parameters: every K1/K2 weight (a ResBlock's w1, w2
  and wr; the downsample, upsample and last-level 3x3 convs) and each
  attention block's wqkv and wo.
- Parameters, optimizer state, EMA and checkpoints stay float32 (flax's
  ``param_dtype``). So do biases, the GroupNorm scale and shift, the ChanLN
  gains (eps 1e-5), the FiLM projection and the time MLP.
- At each matmul the float32 activation operand is rounded to bfloat16, to
  nearest even (``cvt.rn.bf16x2.f32`` on the card, ``.to(torch.bfloat16)``
  here, ``astype`` in JAX; not the ``cvt.rna`` of the TF32 path), and
  multiplied with float32 accumulation. Split-K partials are float32 and
  summed in split order.
- The linear attention's context and its application, and the full
  attention's q k^T and P v, run on float32 values (Pallas :217-220,
  :247-250). The out-projection's operand is their float32 result, rounded
  at the matmul.
- The init 7x7 and final 1x1 convs run in float32 on a float32 input, with
  bfloat16-rounded weights (``_conv_xla``).

A bf16 x bf16 product is exact in float32. So the plain versions (both
operands rounded, then multiplied in float32) and the Pallas kernels differ
only in summation order, and in the rare operand whose float32 values on
the two sides lie an ulp apart and round to neighbouring bfloat16 values
(a 2^-8 relative step of one term of a sum).

Tolerances, max |port - ref| <= rtol * max(1, max |ref|), each beside the
gap measured here (seeded inputs; the largest over a test's cases):
- one block against the Pallas kernel in interpret mode: BLOCK_RTOL 2e-3,
  the suggested ceiling (measured 5.6e-8 to 2.9e-7 for the convs, the
  ResBlocks, the downsample and the linear attention; 2.2e-5 for the full
  attention, whose softmax magnifies a rounding flip); K5's and K6's
  emulations against the plain blocks the same (3.3e-5);
- the whole dim-8 UNet2D against ``unet2d_pallas_apply`` on bf16 packs:
  NET_RTOL 1e-2 (measured 5.5e-3). That gap is the bf16 net's own
  sensitivity, not a difference of rule: the bf16 Pallas forward itself
  moves by 6.6e-3 when its input moves by 1e-7 relative, as rounding flips
  cascade through 11 ResBlocks with one GroupNorm group. The block tests
  above are where a difference of rule would show;
- 2 DDIM steps at eta 0 (steps 25-26 of 50, where sqrt(1/a - 1) ~ 1 does
  not amplify eps) against JAX's sampler on the Pallas forward: NET_RTOL
  (measured 2.0e-3);
- the same net against the flax UNet2D: FLAX_RTOL 0.05, the JAX package's
  own bound for its bf16 Pallas forward (``tests/test_pallas_unet2d.py``:
  test_parity_bf16_weights); measured 7.3e-3 against float32 and 2.6e-2
  against ``dtype=bfloat16`` (flax's other bf16 semantics, with bf16
  activations and ChanLN eps 1e-3: a deliberate difference, ROADMAP.md);
- the guard: the bf16 forward differs from the float32 forward by more
  than GUARD 1e-3 (measured 7.3e-3), ten times the float32 parity bound of
  1e-4 (``test_torch_port_nets.py``), so a silent float32 path fails.

The bf16 variants themselves run only on the card: ``test_torch_port_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.benchmarks import burgers as jbench
from diffphycon_tpu.nets.unet2d import UNet2D as JaxUNet2D
from diffphycon_tpu.research import pallas_unet2d as pu
from diffphycon_tpu_torch.benchmarks import burgers as tbench
from diffphycon_tpu_torch.benchmarks import jellyfish as tjelly
from diffphycon_tpu_torch.benchmarks import smoke as tsmoke
from diffphycon_tpu_torch.kernels import attention as ka
from diffphycon_tpu_torch.kernels import unet2d_blocks as kb
from diffphycon_tpu_torch.nets.init import seeded_init_
from diffphycon_tpu_torch.nets.unet2d import UNet2D
from diffphycon_tpu_torch.utils.convert import load_flax_unet2d
from torch_port_helpers import assert_close, flax_tree, rand

BLOCK_RTOL = 2e-3
NET_RTOL = 1e-2
FLAX_RTOL = 0.05
GUARD = 1e-3
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def _interpret():
    pu.set_interpret(True)
    yield
    pu.set_interpret(False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jw(a):
    """A float32 numpy weight as JAX's bf16 pack holds it."""
    return jnp.asarray(a).astype(jnp.bfloat16)


def _w(shape, seed):
    fan_in = int(np.prod(shape[:-1]))
    return rand(*shape, seed=seed) / np.float32(np.sqrt(fan_in))


def _res_case(ci, co, res_conv, seed=10):
    """Pallas-layout ResBlock weights (float32 numpy)."""
    p = {"w1": _w((9, ci, co), seed), "b1": 0.1 * rand(co, seed=seed + 1),
         "w2": _w((9, co, co), seed + 2), "b2": 0.1 * rand(co, seed=seed + 3),
         "gs1": 1 + 0.1 * rand(co, seed=seed + 4), "gb1": 0.1 * rand(co, seed=seed + 5),
         "gs2": 1 + 0.1 * rand(co, seed=seed + 6), "gb2": 0.1 * rand(co, seed=seed + 7)}
    if res_conv:
        p["wr"], p["br"] = _w((ci, co), seed + 8), 0.1 * rand(co, seed=seed + 9)
    return p


def _pallas_pack(p):
    return {k: _jw(v) if k in ("w", "w1", "w2", "wr", "wqkv", "wo") else jnp.asarray(v)
            for k, v in p.items()}


def _port_pack(p):
    """Port layout: a (taps, Ci, Co) weight flattened to (taps*Ci, Co), the
    matmul weights rounded to bfloat16 by torch."""
    out = {}
    for k, v in p.items():
        t = _t(v)
        if k in ("w", "w1", "w2", "wr", "wqkv", "wo"):
            t = t.reshape(-1, t.shape[-1]).to(BF16)
        out[k] = t
    return out


def _attn_case(c, linear, seed=20):
    hidden = 128
    p = {"norm_g": 1 + 0.1 * rand(c, seed=seed), "wqkv": _w((c, 3 * hidden), seed + 1),
         "wo": _w((hidden, c), seed + 2), "bo": 0.1 * rand(c, seed=seed + 3)}
    if linear:
        p["out_g"] = 1 + 0.1 * rand(c, seed=seed + 4)
    return p


def _block(kind):
    """(port fn, Pallas fn) of one block case on seeded inputs."""
    if kind.startswith("resblock"):
        dual = kind == "resblock_dual"
        ci, co = {"resblock": (16, 16), "resblock_res": (8, 16), "resblock_dual": (24, 16)}[kind]
        ca = 16 if dual else ci
        xa, xb = 2 * rand(2, 8, 16, ca, seed=1), rand(2, 8, 16, ci - ca, seed=2)
        ss = 0.5 * rand(2, 2 * co, seed=3)
        p = _res_case(ci, co, res_conv=ci != co)
        x_ref = np.concatenate([xa, xb], -1) if dual else xa
        return (lambda: kb.resblock(_t(xa), _t(ss), _port_pack(p), x_b=_t(xb) if dual else None),
                lambda: pu.resblock(jnp.asarray(x_ref), jnp.asarray(ss), _pallas_pack(p)))
    if kind in ("conv3x3", "conv1x1", "upsample"):
        k = 1 if kind == "conv1x1" else 3
        x = 2 * rand(2, 8, 16, 16, seed=4)
        p = {"w": _w((k * k, 16, 24), 5), "b": 0.1 * rand(24, seed=6)}
        if k == 1:
            p["w"] = p["w"][0]
        jp = _pallas_pack(p)
        ref = {"conv3x3": lambda: pu.conv(jnp.asarray(x), jp, 3, 3),
               "conv1x1": lambda: pu.conv(jnp.asarray(x), jp, 1, 1),
               "upsample": lambda: pu.upsample(jnp.asarray(x), jp)}[kind]
        tp = _port_pack(p)
        return (lambda: kb.conv2d_nhwc(_t(x), tp["w"], tp["b"], k=k, upsample=kind == "upsample"),
                ref)
    if kind == "downsample":
        x = 2 * rand(2, 8, 16, 16, seed=7)
        p = {"w": _w((4, 16, 32), 8), "b": 0.1 * rand(32, seed=9)}
        tp = _port_pack(p)
        return (lambda: kb.downsample_nhwc(_t(x), tp["w"], tp["b"]),
                lambda: pu.downsample(jnp.asarray(x), _pallas_pack(p)))
    linear = kind == "linear_attention"
    x = 2 * rand(2, 4, 8, 32, seed=11) + 0.3
    p = _attn_case(32, linear)
    port_fn = ka.linear_attention_block if linear else ka.attention_block
    pallas_fn = pu.linear_attention_block if linear else pu.attention_block
    return (lambda: port_fn(_t(x), _port_pack(p)),
            lambda: pallas_fn(jnp.asarray(x), _pallas_pack(p)))


@pytest.mark.parametrize("kind", ["resblock", "resblock_res", "resblock_dual", "conv3x3",
                                  "upsample", "conv1x1", "downsample", "linear_attention",
                                  "attention"])
def test_bf16_block_matches_pallas_bf16(kind):
    """Each block with bf16 packs (CPU: the plain version behind the kernel
    wrapper) against the Pallas kernel run with bf16 weights."""
    port, pallas = _block(kind)
    kb.reset_launch_counts()
    with torch.no_grad():
        out = port()
    assert all(v == 0 for v in kb.launch_counts().values())  # CPU: no kernel
    assert_close(out, pallas(), BLOCK_RTOL)


def test_bf16_emulations_follow_the_rule():
    """K5's chunked context and K6's online softmax with head-wise
    out-projection (the kernels' arithmetic in plain PyTorch) round the same
    operands as the plain versions."""
    x = _t(2 * rand(2, 16, 16, 32, seed=12) + 0.3)
    for linear in (True, False):
        p = _port_pack(_attn_case(32, linear, seed=30))
        if linear:
            out = ka.linear_attention_chunked_emulated(x, p, chunk=64)
            ref = ka.linear_attention_block_plain(x, p)
        else:
            out = ka.attention_tiled_emulated(x, p, key_tile=64)
            ref = ka.attention_block_plain(x, p)
        assert_close(out, ref, BLOCK_RTOL)


@pytest.mark.parametrize("linear", [True, False])
@pytest.mark.parametrize("shape", [(2, 4, 16, 32), (3, 1, 21, 16)])
def test_bf16_emulations_match_pallas_bf16(linear, shape):
    """K5's and K6's arithmetic under bf16 weights in plain PyTorch (K5's
    chunked context merged in chunk order; K6's online softmax and its
    out-projection as one product over all 128 channels, as the bf16 K6c
    sums it) against the plain version and the Pallas kernel run with bf16
    weights, on 64 tokens a sample and on 21 (the bf16 kernels' 64-token
    tiles of the flattened tokens then hold three samples)."""
    x = 2 * rand(*shape, seed=13) + 0.3
    p = _attn_case(shape[-1], linear, seed=31)
    tp = _port_pack(p)
    if linear:
        out = ka.linear_attention_chunked_emulated(_t(x), tp, chunk=64)
        ref = ka.linear_attention_block_plain(_t(x), tp)
        pallas = pu.linear_attention_block(jnp.asarray(x), _pallas_pack(p))
    else:
        out = ka.attention_tiled_emulated(_t(x), tp, key_tile=16)
        ref = ka.attention_block_plain(_t(x), tp)
        pallas = pu.attention_block(jnp.asarray(x), _pallas_pack(p))
    assert_close(out, ref, BLOCK_RTOL)
    assert_close(out, pallas, BLOCK_RTOL)


@pytest.fixture(scope="module")
def small_net():
    """A dim-8, mults (1, 2) JAX UNet2D tree, the port net carrying it in
    bf16 and in float32, and an input."""
    jnet = JaxUNet2D(dim=8, dim_mults=(1, 2), channels=2, out_dim=2, resnet_block_groups=1)
    x, t = rand(2, 16, 32, 2), np.array([3.0, 700.0], np.float32)
    params = flax_tree(jnet, jnp.asarray(x), jnp.asarray(t))
    nets = {wd: load_flax_unet2d(UNet2D(dim=8, dim_mults=(1, 2), channels=2, out_dim=2,
                                        weight_dtype=wd), params)
            for wd in (BF16, torch.float32)}
    return params, nets, x, t


def test_bf16_unet2d_matches_pallas_apply(small_net):
    params, nets, x, t = small_net
    packed = pu.pack_unet2d_params(params, dim=8, dim_mults=(1, 2), weight_dtype=jnp.bfloat16)
    ref = jax.jit(pu.unet2d_pallas_apply)(packed, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        out = nets[BF16](_t(x), _t(t))
        plain = nets[BF16].forward_plain(_t(x), _t(t))
    assert_close(out, ref, NET_RTOL)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


@pytest.mark.parametrize("flax_dtype", [jnp.float32, jnp.bfloat16])
def test_bf16_unet2d_against_flax(small_net, flax_dtype):
    params, nets, x, t = small_net
    jnet = JaxUNet2D(dim=8, dim_mults=(1, 2), channels=2, out_dim=2, resnet_block_groups=1,
                     dtype=flax_dtype)
    ref = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x), jnp.asarray(t)), np.float32)
    with torch.no_grad():
        assert_close(nets[BF16](_t(x), _t(t)), ref, FLAX_RTOL)


def test_bf16_forward_is_not_the_fp32_forward(small_net):
    _, nets, x, t = small_net
    with torch.no_grad():
        bf, fp = (nets[wd](_t(x), _t(t)) for wd in (BF16, torch.float32))
    gap = float((bf - fp).abs().max()) / max(1.0, float(fp.abs().max()))
    assert gap > GUARD, gap


def _bits(a):
    """The raw bits of a bfloat16 or float32 array or tensor, as integers."""
    if isinstance(a, torch.Tensor):
        return a.detach().view(torch.int16 if a.dtype == BF16 else torch.int32).numpy()
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def test_bf16_packs_equal_jax_bit_for_bit(small_net):
    """Every weight of the port's bf16 packs equals pack_unet2d_params(...,
    weight_dtype=bfloat16) bit for bit, after the layout permutation, and
    everything else stays float32."""
    params, nets, *_ = small_net
    jp = pu.pack_unet2d_params(params, dim=8, dim_mults=(1, 2), weight_dtype=jnp.bfloat16)
    tp = nets[BF16].pack()
    pairs = []
    for name, res in zip(pu._res_names(2), tp["res"]):
        for k in res:
            pairs.append((res[k], jp[name][k], k in ("w1", "w2", "wr")))
    for i in range(2):
        for side in ("down", "up"):
            key = f"{side}_{i}_{'downsample' if side == 'down' else 'upsample'}"
            for k in ("w", "b"):
                pairs.append((tp[side][i][k], jp[key][k], k == "w"))
            for k, v in tp[f"{side}_attn"][i].items():
                pairs.append((v, jp[f"{side}_{i}_attn"][k], k in ("wqkv", "wo")))
    for k, v in tp["mid_attn"].items():
        pairs.append((v, jp["mid_attn"][k], k in ("wqkv", "wo")))
    assert sum(matmul for *_, matmul in pairs) == 41  # 27 ResBlock, 4 resample, 10 attention
    for port, ref, matmul in pairs:
        assert port.dtype == (BF16 if matmul else torch.float32)
        ref = np.asarray(ref)
        np.testing.assert_array_equal(_bits(port), _bits(ref.reshape(tuple(port.shape))))
    film_w = np.concatenate([np.asarray(jp[n]["film_w"]) for n in pu._res_names(2)], 1)
    assert tp["film_w"].dtype == torch.float32
    np.testing.assert_array_equal(tp["film_w"].detach().numpy(), film_w)
    assert all(p.dtype == torch.float32 for p in nets[BF16].parameters())


def test_bf16_gradients_reach_the_fp32_parameters(small_net):
    """Through the packs' .to(bfloat16) the loss reaches every float32
    parameter, as flax's param_dtype does; the gradients stay float32."""
    _, nets, x, t = small_net
    net = nets[BF16]
    net.zero_grad()
    net(_t(x), _t(t)).square().mean().backward()
    grads = [p.grad for p in net.parameters()]
    assert all(g is not None and g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads)
    assert all(float(g.abs().max()) > 0 for g in grads)
    net.zero_grad()


def test_bf16_ddim_steps_match_jax_on_pallas_bf16():
    """BurgersConfig(bf16=True, impl="pallas") (the weight-only mode, JAX's
    ``infer_burgers --impl pallas``) builds through benchmarks/burgers.py and
    two DDIM steps at eta 0 (two models, u0/uT conditioning, wu=1000) match
    JAX's sampler driven by unet2d_pallas_apply on bf16 packs."""
    kw = dict(dim=8, dim_mults=(1, 2), is_condition_u0=True, is_condition_uT=True,
              using_ddim=True, ddim_sampling_steps=50)
    jnet = JaxUNet2D(dim=8, dim_mults=(1, 2), channels=2, out_dim=2, resnet_block_groups=1)
    x0, t0 = jnp.zeros((2, 16, 128, 2)), jnp.zeros((2,))
    trees = [flax_tree(jnet, x0, t0, seed=s) for s in (0, 1)]
    tcfg = tbench.BurgersConfig(**kw, bf16=True, impl="pallas")
    ports = [load_flax_unet2d(tbench.build_unet(tcfg, "cpu"), p) for p in trees]
    assert all(p.weight_dtype == BF16 for p in ports)
    packs = tuple(pu.pack_unet2d_params(p, dim=8, dim_mults=(1, 2), weight_dtype=jnp.bfloat16)
                  for p in trees)
    jcfg = jbench.BurgersConfig(**kw)
    apply = jax.jit(lambda p, x, t: pu.unet2d_pallas_apply(p, x, t))
    jgd = jbench.build_diffusion(jcfg, apply, model_w_apply=apply)
    tgd = tbench.build_diffusion(tcfg, ports[0], model_w=ports[1], device="cpu")
    u_target = 0.5 * rand(2, 11, 128, seed=13)
    jg = jbench.build_guidance(jcfg, u_target, wu=1000.0)
    tg = tbench.build_guidance(tcfg, _t(u_target), wu=1000.0)
    cond = {"u0": u_target[:, 0] / 10.0, "uT": u_target[:, 10] / 10.0}
    x_t = rand(2, 16, 128, 2, seed=14)
    ts, tns = jgd.sample_ts()
    ref = jgd.sample_chunk(packs, jax.random.PRNGKey(0), jnp.asarray(x_t),
                           (ts[25:27], tns[25:27]), {k: jnp.asarray(v) for k, v in cond.items()},
                           jg)
    with torch.no_grad():
        out = tgd.sample_chunk(_t(x_t), tgd.sample_ts()[25:27],
                               {k: _t(v) for k, v in cond.items()}, tg)
    assert_close(out, ref, NET_RTOL)


def test_bf16_refused_where_not_ported():
    """The smoke and jellyfish builders give a UNet3D that computes in
    bfloat16 (flax ``dtype=bf16``) on float32 parameters, and
    ``forward_mega`` (K8's plain replay on the CPU) takes bf16 packs and
    equals the bf16 ``forward``. What is refused: K7/K8 in the flax
    ``dtype=bf16`` mode (bf16 activations), ``forward_mega`` and
    ``resblock_pair`` both, with a message naming ROADMAP's item."""
    nets = [tsmoke.init_params(tsmoke.SmokeConfig(bf16=True, dim=8, dim_mults=(1, 2)),
                               device="cpu"),
            tjelly.build_joint_unet(tjelly.JellyfishConfig(bf16=True, dim=8, dim_mults=(1, 2)),
                                    device="cpu"),
            tjelly.build_thetas_unet(tjelly.JellyfishConfig(bf16=True, dim=8,
                                                            dim_mults=(1, 2)), device="cpu")]
    for net in nets:
        assert net.dtype == BF16 and net.init_conv.compute_dtype == BF16
        assert all(p.dtype == torch.float32 for p in net.parameters())
    net = seeded_init_(UNet2D(dim=8, dim_mults=(1, 2), weight_dtype=BF16),
                       torch.Generator().manual_seed(0))
    x, t = _t(rand(1, 8, 32, 2)), torch.tensor([5.0])
    with torch.no_grad():
        torch.testing.assert_close(net.forward_mega(x, t), net(x, t), rtol=0, atol=0)
    flax = seeded_init_(UNet2D(dim=8, dim_mults=(1, 2), dtype=BF16),
                        torch.Generator().manual_seed(0))
    p = flax.pack()["res"][1]  # down_0_block2: 8 -> 8 channels
    xb, ss = _t(rand(1, 8, 32, 8)).to(BF16), torch.zeros(1, 16, dtype=BF16)
    with torch.no_grad():
        assert flax(x, t).dtype == BF16
        for call in (lambda: flax.forward_mega(x, t),
                     lambda: kb.resblock_pair(xb, ss, ss, p, p)):
            with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2 item 10"):
                call()


def test_bf16_weight_checks():
    w32, w16 = torch.zeros(8, 16), torch.zeros(8, 16, dtype=BF16)
    assert kb.weight_is_bf16("k", w16, w16) and not kb.weight_is_bf16("k", w32)
    with pytest.raises(TypeError, match="mixed"):
        kb.weight_is_bf16("k", w32, w16)
    with pytest.raises(ValueError, match="multiple of 8"):
        kb.weight_is_bf16("k", torch.zeros(8, 12, dtype=BF16))
    # ties go to the even neighbour: 1 + 2^-8 to 1, 1 + 3 * 2^-8 to 1 + 2^-6
    ties = torch.tensor([1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8])
    assert kb.bf16_operands(ties, w16)[0].tolist() == [1.0, 1.0 + 2 ** -6]


def test_bf16_train_app_keeps_fp32_state(tmp_path):
    """``train_burgers --bf16 True`` (dim 8, two steps) trains the bf16 net
    with float32 parameters, Adam moments and EMA, and saves them float32,
    as flax's param_dtype."""
    from diffphycon_tpu_torch.apps import train_burgers
    from diffphycon_tpu_torch.training.trainer import Trainer

    folder = tmp_path / "models"
    tr = train_burgers.main(train_burgers.build_parser().parse_args(
        ["--dim", "8", "--dim_mults", "1", "2", "--device", "cpu", "--bf16", "True",
         "--synthetic_data", "8", "--train_num_steps", "2", "--checkpoint_interval", "2",
         "--batch_size", "4", "--is_condition_u0", "True", "--is_condition_uT", "True",
         "--data_root", str(tmp_path / "data"), "--results_folder", str(folder)]))
    assert tr.step == 2 and tr.model.weight_dtype == BF16 and tr.model.dtype == BF16
    assert all(p.dtype == torch.float32 for p in tr.params + tr.ema)
    moments = [t for st in tr.optimizer.state.values() for k, t in st.items() if k != "step"]
    assert moments and all(t.dtype == torch.float32 for t in moments)  # Adam's m and v
    for use_ema in (False, True):
        saved = Trainer.load_params(str(folder), 2, use_ema=use_ema)
        assert all(v.dtype == torch.float32 for v in saved.values())
