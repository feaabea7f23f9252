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
  too). Equal to ``unet2d_mega_plain`` within 1e-5 relative.

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


def _run_stage(op, i, view):
    """One stage of the table on CPU tensors; view(slot, shape) reads and
    view(slot, shape, write=True) gives the output buffer."""
    B, H, W, ca, cb, co = i["B"], i["H"], i["W"], i["ca"], i["cb"], i["co"]
    if op == km.CONV:
        src = (B, H // 2, W // 2) if i["up"] else (B, H, W)
        k = i["ks"]
        out = kb.conv2d_nhwc_plain(view("x", src + (ca,)), view("w", (k * k * (ca + cb), co)),
                                   view("bias", (co,)),
                                   view("x2", src + (cb,)) if cb else None, k=k,
                                   upsample=bool(i["up"]))
    elif op == km.DOWN:
        out = kb.downsample_nhwc_plain(view("x", (B, H, W, ca)), view("w", (4 * ca, co)),
                                       view("bias", (co,)))
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
    else:
        x = view("x", (B, H, W, co))
        n, hidden = H * W, ka.KERNEL_HEADS * ka.KERNEL_DIM_HEAD
        qkv = lambda: ka._qkv(x, view("w", (co,)), view("aux", (co, 3 * hidden)),  # noqa: E731
                              ka.KERNEL_HEADS, ka.KERNEL_DIM_HEAD)
        wo, bo = view("x2", (hidden, co)), view("bias", (co,))
        if op == km.LA_CONTEXT:
            _, k, v = qkv().unbind(2)
            k = torch.softmax(k.permute(0, 2, 3, 1), dim=-1)
            out = torch.einsum("bhdn,bnhe->bhde", k, v)
            view("scr", out.shape, write=True).copy_(out)
            return
        if op == km.LA_OUTPUT:
            q = torch.softmax(qkv()[:, :, 0], dim=-1) * ka.KERNEL_DIM_HEAD ** -0.5
            ctx = view("scr", (B, ka.KERNEL_HEADS, ka.KERNEL_DIM_HEAD, ka.KERNEL_DIM_HEAD))
            o = torch.einsum("bhde,bnhd->bnhe", ctx, q).reshape(B * n, hidden)
            out = x + ka._chan_ln((o @ wo + bo).reshape(x.shape), view("res", (co,)))
        elif op == km.ATT_HEADS:
            q, k, v = qkv().unbind(2)
            sim = torch.einsum("bihd,bjhd->bhij", q * ka.KERNEL_DIM_HEAD ** -0.5, k)
            out = torch.einsum("bhij,bjhd->bihd", torch.softmax(sim, dim=-1), v)
            out = out.reshape(B, n, hidden)
            view("scr", out.shape, write=True).copy_(out)
            return
        else:  # ATT_OUTPUT
            o = view("scr", (B, n, hidden)).reshape(B * n, hidden)
            out = x + (o @ wo + bo).reshape(x.shape)
    view("out", out.shape, write=True).copy_(out)


def _replay(plan, inputs, weights):
    """Run plan.table on the CPU: phase by phase, each stage reading the
    workspace as it stood at the phase's barrier."""
    by_addr = {t.data_ptr(): t for t in weights}
    ws = torch.full((plan.workspace_bytes // 4,), float("nan"))
    out = torch.empty(plan.out_shape)
    flats = {1: ws, 2 + len(inputs): out.reshape(-1)}
    flats.update({2 + k: t.reshape(-1) for k, t in enumerate(inputs)})
    names = dict(zip(km._INTS, range(len(km._INTS))))
    snapshot = {1: ws.clone()}
    for row in plan.table:
        ints = {name: int(row[k]) for name, k in names.items()}

        def view(slot, shape, write=False, stride=None, row=row):
            s = km._SLOTS[slot]
            base, off = int(row[24 + s]), int(row[16 + s])
            if base == 0:
                return by_addr[off].reshape(shape) if off else None
            flat = flats[base] if write or base != 1 else snapshot[1]
            if stride is not None:
                return flat.as_strided(shape, (stride, 1), off // 4)
            assert off % 4 == 0 and off // 4 + math.prod(shape) <= flat.numel()
            return flat[off // 4: off // 4 + math.prod(shape)].view(shape)

        _run_stage(ints["op"], ints, view)
        if ints["sync"]:
            snapshot[1] = ws.clone()
    return out


@pytest.mark.parametrize("dim,mults,shape", [(8, (1, 2, 4, 8), (2, 16, 128, 2)),
                                             (16, (1, 2, 4), (2, 16, 128, 2))])
def test_port_mega_stage_table_replays_to_the_plain_forward(dim, mults, shape):
    """The 4-level Burgers layout (a 32-token bottleneck) and the 3-level one
    (128 tokens, the kernel's largest): stage counts as the architecture
    implies, then the table run on the CPU against forward_plain."""
    net = seeded_init_(UNet2D(dim=dim, dim_mults=mults), torch.Generator().manual_seed(0))
    x, t = torch.from_numpy(rand(*shape, seed=3)), torch.tensor([3.0, 600.0])
    with torch.no_grad():
        packs = net.pack()
        film = net._film(t, packs)
        x0 = _conv_nchw(x, net.init_conv)
        plan = km.mega_plan(packs, x0.shape, net.groups, 4, 32, x0.device)
        # 4n + 3 ResBlocks (2n + 1 with a residual conv), n - 1 downsamples,
        # n - 1 upsamples and two last-level 3x3 convs, 2n linear attentions
        n = len(mults)
        assert plan.counts() == {"conv": 11 * n + 8, "down": n - 1, "gn_stats": 8 * n + 6,
                                 "gn_apply": 8 * n + 6, "la_context": 2 * n,
                                 "la_output": 2 * n, "att_heads": 1, "att_output": 1}
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
