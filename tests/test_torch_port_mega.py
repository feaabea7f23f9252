"""K7 (``resblock_pair``) and K8 (``UNet2D.forward_mega``): their plain
versions against the Pallas kernels they replace (interpret mode), and K8's
stage table replayed on the CPU.

- ``resblock_pair_plain`` against ``pallas_unet2d.resblock_pair``: max |err|
  <= 1e-4 * max(1, max |pallas|), the tolerance of the ResBlock test
  (float32 on both sides, summation order only);
- ``forward_mega`` on the CPU against ``unet2d_mega_apply`` (jitted, so the
  interpret-mode kernel compiles once instead of dispatching op by op): max
  |err| <= 5e-5 * max(1, max |ref|), the JAX mega test's own tolerance;
- the recorded stage table (the int64 rows the CUDA kernel reads) executed
  stage by stage with plain torch, phase by phase: every stage of a phase
  reads the workspace as it was at the phase's barrier, so a missing barrier
  or a buffer reused while still live gives a different result (the
  workspace starts as NaN, so reading a buffer before it is written shows
  too). Split-K partials are added in split order, linear attention's
  chunk partials merged in chunk order and full attention's softmax taken
  over 64-key tiles, as the kernel does. Equal to ``unet2d_mega_plain``
  within 1e-5 relative.

The kernels themselves run only on an NVIDIA GPU (test_torch_port_cuda.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.nets.unet2d import UNet2D as JaxUNet2D
from diffphycon_tpu.research import pallas_unet2d as pu
from diffphycon_tpu.research import pallas_unet2d_mega as mega
from diffphycon_tpu_torch.kernels import attention as ka
from diffphycon_tpu_torch.kernels import unet2d_blocks as kb
from diffphycon_tpu_torch.kernels import unet2d_mega as km
from diffphycon_tpu_torch.nets.init import seeded_init_
from diffphycon_tpu_torch.nets.unet2d import UNet2D, _conv_nchw
from diffphycon_tpu_torch.utils import convert
from test_torch_port_kernels import _res_params, _torch_res
from torch_port_helpers import assert_close, flax_tree, rand

RTOL = 1e-4
MEGA_RTOL = 5e-5


@pytest.fixture(autouse=True)
def _interpret():
    pu.set_interpret(True)
    mega.set_interpret(True)
    yield
    pu.set_interpret(False)
    mega.set_interpret(False)


@pytest.mark.parametrize("shape", [(2, 8, 16, 8), (3, 4, 32, 16)])
def test_port_resblock_pair_plain_matches_pallas(shape):
    c = shape[-1]
    x = rand(*shape)
    ss_a, ss_b = 0.5 * rand(shape[0], 2 * c, seed=1), 0.5 * rand(shape[0], 2 * c, seed=2)
    p_a, p_b = _res_params(c, c, res_conv=False, seed=10), _res_params(c, c, False, seed=30)
    ref = pu.resblock_pair(jnp.asarray(x), jnp.asarray(ss_a), jnp.asarray(ss_b),
                           {k: jnp.asarray(v) for k, v in p_a.items()},
                           {k: jnp.asarray(v) for k, v in p_b.items()})
    args = (torch.from_numpy(x), torch.from_numpy(ss_a), torch.from_numpy(ss_b),
            _torch_res(p_a), _torch_res(p_b))
    assert_close(kb.resblock_pair_plain(*args), ref, RTOL)
    kb.reset_launch_counts()
    assert_close(kb.resblock_pair(*args), ref, RTOL)  # a CPU tensor: the plain version
    assert kb.launch_counts()["resblock_pair"] == 0


def test_port_resblock_pair_unequal_channels_raise():
    x, ss = torch.from_numpy(rand(1, 4, 8, 8)), torch.zeros(1, 32)
    p_a = _torch_res(_res_params(8, 16, res_conv=True))
    p_b = _torch_res(_res_params(16, 16, res_conv=False, seed=30))
    for fn in (kb.resblock_pair, kb.resblock_pair_plain):
        with pytest.raises(ValueError, match="equal channels"):
            fn(x, ss, ss, p_a, p_b)


def _nets(dim, mults, channels, groups, x, t):
    jnet = JaxUNet2D(dim=dim, dim_mults=mults, channels=channels, out_dim=channels,
                     resnet_block_groups=groups)
    params = flax_tree(jnet, jnp.asarray(x), jnp.asarray(t))
    port = UNet2D(dim=dim, dim_mults=mults, channels=channels, out_dim=channels,
                  resnet_block_groups=groups)
    return params, convert.load_flax_unet2d(port, params)


# the two shapes of tests/test_pallas_unet2d_mega.py, and one with 2 groups
@pytest.mark.parametrize("dim,mults,shape,groups", [
    (16, (1, 2, 4), (4, 16, 128, 2), 1),
    (8, (1, 2), (3, 8, 64, 3), 1),
    (8, (1,), (2, 8, 16, 2), 2),
])
def test_port_forward_mega_matches_pallas_mega(dim, mults, shape, groups):
    x = rand(*shape, seed=1)
    t = np.linspace(0.0, 999.0, shape[0]).astype(np.float32)
    params, port = _nets(dim, mults, shape[-1], groups, x, t)
    packed = mega.pack_unet2d_mega(params, dim=dim, dim_mults=mults, groups=groups,
                                   weight_dtype=None)
    apply = jax.jit(lambda p, x, t: mega.unet2d_mega_apply(p, x, t, groups=groups,
                                                            batch_tile=shape[0]))
    ref = np.asarray(apply(packed, jnp.asarray(x), jnp.asarray(t)))
    kb.reset_launch_counts()
    with torch.no_grad():
        out = port.forward_mega(torch.from_numpy(x), torch.from_numpy(t))
        plain = port.forward_plain(torch.from_numpy(x), torch.from_numpy(t))
    assert all(v == 0 for v in kb.launch_counts().values())  # CPU: nothing launched
    assert_close(out, ref, MEGA_RTOL)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


def test_port_forward_mega_is_forward_only():
    net = seeded_init_(UNet2D(dim=8, dim_mults=(1, 2)), torch.Generator().manual_seed(0))
    x, t = torch.from_numpy(rand(1, 8, 32, 2)), torch.tensor([5.0])
    with pytest.raises(RuntimeError, match="forward-only"):
        net.forward_mega(x, t)
    with torch.no_grad():
        net.forward_mega(x, t)
        with torch.enable_grad(), pytest.raises(RuntimeError, match="forward-only"):
            net.forward_mega(x.requires_grad_(True), t)


# ---------------------------------------------------------------------------
# the stage table replayed with plain torch
# ---------------------------------------------------------------------------


def _gn_partials(x, groups, chunk, S):
    B, H, W, C = x.shape
    rows = x.reshape(B, H * W, groups, C // groups).permute(0, 2, 1, 3).reshape(B * groups, -1)
    part = torch.empty(B * groups, S, 2)
    for s in range(S):
        seg = rows[:, s * chunk:(s + 1) * chunk]
        mean = seg.mean(dim=1)
        part[:, s, 0] = mean
        part[:, s, 1] = ((seg - mean[:, None]) ** 2).sum(dim=1)
    return part


def _gn_merge(part, L, chunk):
    """Chan's merge of (mean, m2) chunk partials -> (mean, var) per row."""
    S = part.shape[1]
    cnt = torch.tensor([min(chunk, L - i * chunk) for i in range(S)], dtype=torch.float32)
    mean = (cnt * part[:, :, 0]).sum(dim=1) / L
    var = (part[:, :, 1].sum(dim=1) + (cnt * (part[:, :, 0] - mean[:, None]) ** 2).sum(dim=1)) / L
    return mean, var


def _mm(a, b, tc3):
    """a @ b, or as the tensor-core bodies compute it (tc3): 3xTF32
    products lo*hi' + hi*lo' + hi*hi' with fp32 sums."""
    if not tc3:
        return a @ b
    ah, al = kb.tf32_split(a)
    bh, bl = kb.tf32_split(b)
    return al @ bh + ah @ bl + ah @ bh


def _im2col(x_a, x_b, k, up):
    """The (M, K) matrix K1's gather reads, K ordered (dy*k + dx)*Ci + c."""
    x = kb._conv_input(x_a, x_b, up)
    B, H, W, ci = x.shape
    p = (k - 1) // 2
    xp = torch.nn.functional.pad(x, (0, 0, p, k - 1 - p, p, k - 1 - p))
    return torch.cat([xp[:, dy:dy + H, dx:dx + W, :].reshape(B * H * W, ci)
                      for dy in range(k) for dx in range(k)], dim=1)


def _gemm_stage(a, w, b, i, tc3):
    """The GEMM of a conv or down stage on its split-K plan: bias + the
    splits' partials over K slices [z*per*BK, (z+1)*per*BK), added in split
    order (BK: the core's stage depth, 32 for float32 weights, 64 for the
    bf16 core)."""
    step = i["per"] * (kb.TC_BK_BF16 if w.dtype == torch.bfloat16 else kb.TC_BK)
    acc = None
    for z in range(i["splits"]):
        term = _mm(a[:, z * step:(z + 1) * step], w[z * step:(z + 1) * step], tc3)
        acc = term if acc is None else acc + term
    return acc + b


def _qkv(x, g, wqkv, tc3):
    B, H, W, C = x.shape
    hidden = ka.KERNEL_HEADS * ka.KERNEL_DIM_HEAD
    return _mm(ka._chan_ln(x, g).reshape(-1, C), wqkv, tc3).reshape(B, H * W, 3 * hidden)


def _heads(t):
    """(B, n, 128) -> (B, n, 4, 32)."""
    return t.reshape(*t.shape[:2], ka.KERNEL_HEADS, ka.KERNEL_DIM_HEAD)


def _run_stage(op, i, view, tc3=False):
    """One stage of the table on CPU tensors; view(slot, shape) reads and
    view(slot, shape, write=True) gives the output buffer. Split-K partials
    are added in split order, K5's chunk partials merged in chunk order and
    K6's softmax taken online over 64-key tiles, as the kernel does; tc3:
    every product as 3xTF32."""
    B, H, W, ca, cb, co = i["B"], i["H"], i["W"], i["ca"], i["cb"], i["co"]
    n, hidden = H * W, ka.KERNEL_HEADS * ka.KERNEL_DIM_HEAD
    if op == km.CONV:
        src = (B, H // 2, W // 2) if i["up"] else (B, H, W)
        k = i["ks"]
        a = _im2col(view("x", src + (ca,)), view("x2", src + (cb,)) if cb else None, k,
                    bool(i["up"]))
        out = _gemm_stage(a, view("w", (k * k * (ca + cb), co)), view("bias", (co,)), i, tc3)
        out = out.reshape(B, H, W, co)
    elif op == km.DOWN:
        x6 = view("x", (B, H, W, ca)).reshape(B, H // 2, 2, W // 2, 2, ca)
        a = x6.permute(0, 1, 3, 2, 4, 5).reshape(-1, 4 * ca)
        out = _gemm_stage(a, view("w", (4 * ca, co)), view("bias", (co,)), i, tc3)
        out = out.reshape(B, H // 2, W // 2, co)
    elif op in (km.GN_STATS, km.GN_APPLY):
        g, chunk, S = i["groups"], i["chunk"], i["S"]
        x = view("x", (B, H, W, co))
        if op == km.GN_STATS:
            out = _gn_partials(x, g, chunk, S)
            view("scr", out.shape, write=True).copy_(out)
            return
        mean, var = _gn_merge(view("scr", (B * g, S, 2)), H * W * co // g, chunk)
        y = x.reshape(B, H * W, g, co // g)
        y = ((y - mean.view(B, 1, g, 1)) / torch.sqrt(var.view(B, 1, g, 1) + kb.GN_EPS))
        y = y.reshape(x.shape) * view("w", (co,)) + view("bias", (co,))
        ss = view("aux", (B, 2 * co), stride=i["ss_stride"])
        if ss is not None:
            y = y * (ss[:, None, None, :co] + 1.0) + ss[:, None, None, co:]
        y = y * torch.sigmoid(y)
        res = view("res", x.shape)
        out = y if res is None else y + res
    elif op == km.LA_CONTEXT:
        chunk, S = i["chunk"], i["S"]
        qkv = _qkv(view("x", (B, H, W, co)), view("w", (co,)), view("aux", (co, 3 * hidden)), tc3)
        k, v = _heads(qkv[..., hidden:2 * hidden]), _heads(qkv[..., 2 * hidden:])
        part = view("scr", (B, S, hidden, ka.LA_PART), write=True)
        for s in range(S):  # each chunk's (context, max, sum) of exp(k - max)^T v
            kc, vc = k[:, s * chunk:(s + 1) * chunk], v[:, s * chunk:(s + 1) * chunk]
            m = kc.amax(dim=1)  # (B, 4, 32)
            e = torch.exp(kc - m[:, None])
            ctx_s = torch.einsum("bnhd,bnhe->bhde", e, vc) if not tc3 else torch.stack(
                [_mm(e[:, :, h].transpose(1, 2), vc[:, :, h], True) for h in range(4)], 1)
            part[:, s, :, :ka.KERNEL_DIM_HEAD] = ctx_s.reshape(B, hidden, -1)
            part[:, s, :, ka.KERNEL_DIM_HEAD] = m.reshape(B, hidden)
            part[:, s, :, ka.KERNEL_DIM_HEAD + 1] = e.sum(dim=1).reshape(B, hidden)
        # the merge, in chunk order (the last chunk to arrive runs it)
        m_all = part[..., ka.KERNEL_DIM_HEAD].amax(dim=1)
        ctx, total = 0.0, 0.0
        for s in range(S):
            w = torch.exp(part[:, s, :, ka.KERNEL_DIM_HEAD] - m_all)
            total = total + w * part[:, s, :, ka.KERNEL_DIM_HEAD + 1]
            ctx = ctx + w[..., None] * part[:, s, :, :ka.KERNEL_DIM_HEAD]
        out = (ctx / total[..., None]).reshape(B, ka.KERNEL_HEADS, ka.KERNEL_DIM_HEAD, -1)
    elif op == km.LA_OUTPUT:
        x = view("x", (B, H, W, co))
        q = _heads(_qkv(x, view("w", (co,)), view("aux", (co, 3 * hidden)), tc3)[..., :hidden])
        q = torch.softmax(q, dim=-1) * ka.KERNEL_DIM_HEAD ** -0.5
        ctx = view("scr", (B, ka.KERNEL_HEADS, ka.KERNEL_DIM_HEAD, ka.KERNEL_DIM_HEAD))
        o = torch.stack([_mm(q[:, :, h], ctx[:, h], tc3) for h in range(4)], 2)
        y = _mm(o.reshape(B * n, hidden), view("x2", (hidden, co)), tc3) + view("bias", (co,))
        out = x + ka._chan_ln(y.reshape(x.shape), view("res", (co,)))
    elif op == km.ATT_QKV:
        qkv = _qkv(view("x", (B, H, W, co)), view("w", (co,)), view("aux", (co, 3 * hidden)), tc3)
        scale = torch.ones(3 * hidden)
        scale[:hidden] = ka.KERNEL_DIM_HEAD ** -0.5
        out = (qkv * scale).reshape(B * n, 3 * hidden)
    elif op == km.ATT_CORE:  # online softmax over 64-key tiles
        qkv = view("x", (B, n, 3 * hidden))
        q, k, v = (_heads(qkv[..., j * hidden:(j + 1) * hidden]).transpose(1, 2)
                   for j in range(3))  # (B, 4, n, 32), q scaled
        m = torch.full((B, 4, n), -math.inf)
        total, o = torch.zeros(B, 4, n), torch.zeros(B, 4, n, ka.KERNEL_DIM_HEAD)
        for k0 in range(0, n, ka.ATTN_KEY_TILE):
            kt, vt = k[:, :, k0:k0 + ka.ATTN_KEY_TILE], v[:, :, k0:k0 + ka.ATTN_KEY_TILE]
            sc = _mm(q, kt.transpose(-1, -2), tc3)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            e = torch.exp(sc - m_new[..., None])
            total = total * alpha + e.sum(dim=-1)
            o = o * alpha[..., None] + _mm(e, vt, tc3)
            m = m_new
        out = (o / total[..., None]).transpose(1, 2).reshape(B * n, hidden)
    else:  # ATT_OUT: the heads' partials of the out-projection in head order
        x = view("x", (B, H, W, co))
        o, wo = view("scr", (B * n, hidden)), view("x2", (hidden, co))
        d = ka.KERNEL_DIM_HEAD
        acc = None
        for h in range(ka.KERNEL_HEADS):
            term = _mm(o[:, h * d:(h + 1) * d], wo[h * d:(h + 1) * d], tc3)
            acc = term if acc is None else acc + term
        out = x + (acc + view("bias", (co,))).reshape(x.shape)
    view("out", out.shape, write=True).copy_(out)


def _replay(plan, inputs, weights, tc3=False):
    """Run plan.table on the CPU: phase by phase, each stage reading the
    workspace as it stood at the phase's barrier (a stage reads what it
    wrote itself: K5's merge and the split-K sums run in the stage that
    wrote their partials)."""
    by_addr = {t.data_ptr(): t for t in weights}
    ws = torch.full((plan.workspace_bytes // 4,), float("nan"))
    out = torch.empty(plan.out_shape)
    flats = {1: ws, 2 + len(inputs): out.reshape(-1)}
    flats.update({2 + k: t.reshape(-1) for k, t in enumerate(inputs)})
    names = dict(zip(km.INTS, range(len(km.INTS))))
    snapshot = {1: ws.clone()}
    for row in plan.table:
        ints = {name: int(row[k]) for name, k in names.items()}

        def view(slot, shape, write=False, stride=None, row=row):
            s = km.SLOTS[slot]
            base, off = int(row[km.BASE + s]), int(row[km.OFF + s])
            if base == 0:
                return by_addr[off].reshape(shape) if off else None
            flat = flats[base] if write or base != 1 else snapshot[1]
            if stride is not None:
                return flat.as_strided(shape, (stride, 1), off // 4)
            assert off % 4 == 0 and off // 4 + math.prod(shape) <= flat.numel()
            assert base != 1 or off >= 4 * plan.n_counters  # clear of the counters
            return flat[off // 4: off // 4 + math.prod(shape)].view(shape)

        _run_stage(ints["op"], ints, view, tc3)
        if ints["sync"]:
            snapshot[1] = ws.clone()
    return out


def _mega_inputs(net, shape, t, seed=3):
    """(x0, film, packs) of forward_mega for a CPU net."""
    x = torch.from_numpy(rand(*shape, seed=seed))
    packs = net.pack()
    return _conv_nchw(x, net.init_conv), net._film(t, packs), packs


@pytest.mark.parametrize("dim,mults,shape", [(8, (1, 2, 4, 8), (2, 16, 128, 2)),
                                             (16, (1, 2, 4), (2, 16, 128, 2))])
def test_port_mega_stage_table_replays_to_the_plain_forward(dim, mults, shape):
    """The 4-level Burgers layout (a 32-token bottleneck) and the 3-level one
    (128 tokens): stage counts as the architecture implies, then the table
    run on the CPU against forward_plain."""
    net = seeded_init_(UNet2D(dim=dim, dim_mults=mults), torch.Generator().manual_seed(0))
    with torch.no_grad():
        x0, film, packs = _mega_inputs(net, shape, torch.tensor([3.0, 600.0]))
        plan = km.mega_plan(packs, x0.shape, net.groups, 4, 32, x0.device)
        # 4n + 3 ResBlocks (2n + 1 with a residual conv), n - 1 downsamples,
        # n - 1 upsamples and two last-level 3x3 convs, 2n linear attentions
        # (context, output), one full attention (qkv, core, out)
        n = len(mults)
        assert plan.counts() == {"conv": 11 * n + 8, "down": n - 1, "gn_stats": 8 * n + 6,
                                 "gn_apply": 8 * n + 6, "la_context": 2 * n,
                                 "la_output": 2 * n, "att_qkv": 1, "att_core": 1, "att_out": 1}
        got = _replay(plan, (x0, film), list(_tensors(packs)))
        ref = km.unet2d_mega_plain(x0, film, packs, plan)
    assert_close(got, ref, 1e-5)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
