"""K8's host plan and arithmetic after its move onto the tensor-core bodies
(``csrc/unet2d_persistent.cu``: K1's 3xTF32 ``wgmma`` tile, K5's and K6's
bodies), on the CPU.

- Every conv and down stage of the full-width Burgers UNet2D at batch 50,
  16 and 1 takes a 128-row tile plan (``unet2d_mega.MEGA_TILES``,
  ``unet2d_blocks.pick_plan`` for the grid) whose splits cover K exactly
  once and that fills one wave of the grid it was made for (the grid is an
  argument: 132 CTAs on an H100 SXM, 114 on a PCIe card); each
  linear-attention stage a chunk plan that covers the sample, each full
  attention a token tile of 32 or 64.
- The recorded table replayed on the CPU (``test_torch_port_mega._replay``)
  with every product in 3xTF32 (``unet2d_blocks.tf32_split``), split-K
  partials added in split order and K5's chunk partials merged in chunk
  order, on a small grid so that a dim-8 net takes split-K: against
  ``forward_plain`` and against the JAX ``unet2d_mega_apply`` in interpret
  mode.
- A 2-level dim-16 net on (2, 16, 128, 2), whose bottleneck holds 8 x 64 =
  512 tokens: its plan passes the kernel's shape checks (the kernel used to
  refuse more than 128 tokens) and its replay matches the JAX flax
  ``UNet2D.apply``.

Tolerances (max |port - ref| <= rtol * max(1, max |ref|)): 1e-5 against
``forward_plain`` and the flax net (float32 on every side; the 3xTF32
products drop a ~2^-22 relative term, and sums run in another order), and
the JAX mega test's own 5e-5 against ``unet2d_mega_apply``.

The kernel itself runs on the card (test_torch_port_cuda.py, chip_smoke.py
phase 10).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.nets.unet2d import UNet2D as JaxUNet2D
from diffphycon_tpu.research import pallas_unet2d_mega as mega
from diffphycon_tpu_torch.kernels import attention as ka
from diffphycon_tpu_torch.kernels import unet2d_blocks as kb
from diffphycon_tpu_torch.kernels import unet2d_mega as km
from diffphycon_tpu_torch.nets.unet2d import UNet2D, _conv_nchw
from diffphycon_tpu_torch.utils import convert
from test_torch_port_mega import _replay, _tensors
from torch_port_helpers import assert_close, flax_tree, rand

RTOL = 1e-5
MEGA_RTOL = 5e-5


@pytest.fixture(scope="module")
def burgers_packs():
    """The full-width Burgers UNet2D's packed weights (dim 64, mults (1, 2,
    4, 8)); the plans only read their shapes."""
    net = UNet2D(dim=64, dim_mults=(1, 2, 4, 8))
    with torch.no_grad():
        return net.pack(), net.groups


@pytest.mark.parametrize("grid", [132, 114])
@pytest.mark.parametrize("batch", [50, 16, 1])
def test_port_mega_plans_cover_k_in_one_wave(burgers_packs, batch, grid):
    """Every conv and down stage on a 128-row tile plan for the grid whose
    splits cover K exactly once and fill one wave; every other stage's plan
    for the grid."""
    packs, groups = burgers_packs
    plan = km.mega_plan(packs, (batch, 16, 128, 64), groups, 4, 32, "cpu", grid=grid)
    km.check_kernel_plan(plan)
    assert plan.grid == grid
    gemms = [s for s in plan.stages if s.op in (km.CONV, km.DOWN)]
    assert len(gemms) == 55
    counters, split = 0, 0
    for st in gemms:
        i = st.ints
        if st.op == km.CONV:
            m, k = i["B"] * i["H"] * i["W"], i["ks"] ** 2 * (i["ca"] + i["cb"])
        else:
            m, k = i["B"] * (i["H"] // 2) * (i["W"] // 2), 4 * i["ca"]
        n = i["co"]
        tp = kb.TilePlan(i["bm"], i["bn"], i["splits"], i["per"])
        assert tp == kb.pick_plan(m, n, k, tiles=km.MEGA_TILES, sms=grid)
        assert (tp.bm, tp.bn) in km.MEGA_TILES and (tp.bn == 64 or n > 64), (m, n, k, tp)
        slices = math.ceil(k / kb.TC_BK)
        # split z walks K slices [z * per, min((z + 1) * per, slices)): all
        # non-empty, disjoint, together exactly [0, K)
        ranges = [(z * tp.per, min((z + 1) * tp.per, slices)) for z in range(tp.splits)]
        assert all(lo < hi for lo, hi in ranges)
        assert ranges[0][0] == 0 and ranges[-1][1] == slices
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert tp.splits == 1 or tp.per >= kb.MIN_SLICES_PER_SPLIT
        # one wave of the grid, unless even the most splits cannot fill it
        most = tp.ctas(m, n) // tp.splits * max(1, slices // kb.MIN_SLICES_PER_SPLIT)
        assert tp.ctas(m, n) >= grid or most < grid, (m, n, k, tp)
        if tp.splits > 1:  # partials of every split, a counter per tile
            assert st.ptrs["scr"].shape == (tp.splits, m, n)
            assert st.ptrs["cnt"].n == tp.ctas(m, n) // tp.splits
            counters += st.ptrs["cnt"].n
            split += 1
        else:
            assert "scr" not in st.ptrs and "cnt" not in st.ptrs
    for st in plan.stages:
        i = st.ints
        if st.op == km.LA_CONTEXT:
            n = i["H"] * i["W"]
            assert (i["chunk"], i["S"]) == ka.la_chunk_plan(i["B"], n, grid)
            assert i["hg"] == ka.la_head_groups(i["B"], i["S"], grid)
            assert i["chunk"] in ka.LA_CHUNKS
            assert (i["S"] - 1) * i["chunk"] < n <= i["S"] * i["chunk"]
            assert i["hg"] == 1 or 2 * i["B"] * i["S"] <= grid
            assert st.ptrs["cnt"].n == i["B"]
            counters += i["B"]
        elif st.op in (km.ATT_QKV, km.ATT_OUT):
            assert i["tr"] == ka.attn_tile_rows(i["B"], i["H"] * i["W"], grid) in (32, 64)
    assert plan.n_counters == counters
    assert plan.barriers() == sum(s.sync for s in plan.stages) + 1
    assert plan.workspace_bytes >= 4 * counters
    if batch == 50:  # the deepest levels need split-K to fill the card
        assert split > 0


def _jax_net(dim, mults, x, t):
    jnet = JaxUNet2D(dim=dim, dim_mults=mults, channels=x.shape[-1], out_dim=x.shape[-1])
    params = flax_tree(jnet, jnp.asarray(x), jnp.asarray(t))
    port = UNet2D(dim=dim, dim_mults=mults, channels=x.shape[-1], out_dim=x.shape[-1])
    return jnet, params, convert.load_flax_unet2d(port, params)


def _replayed_forward(net, x, t, grid):
    """net.forward_mega with the kernel's table replayed in 3xTF32 in place
    of the launch, on a plan that passes the kernel's checks: (output,
    plan)."""
    packs = net.pack()
    film = net._film(t, packs)
    x0 = _conv_nchw(torch.from_numpy(x), net.init_conv)
    plan = km.mega_plan(packs, x0.shape, net.groups, 4, 32, x0.device, grid=grid)
    km.check_kernel_plan(plan)
    h = _replay(plan, (x0, film), list(_tensors(packs)), tc3=True)
    return _conv_nchw(h, net.final_conv), plan


def test_port_mega_tc_replay_matches_plain_and_pallas_mega():
    """dim 8, mults (4,) (channels 8 and 32) at batch 2 on a 16-CTA grid:
    split-K convs (K up to 360), chunked linear attention and a 128-token
    full attention, replayed in 3xTF32."""
    dim, mults, shape = 8, (4,), (2, 8, 16, 2)
    x = rand(*shape, seed=1)
    t = np.linspace(0.0, 999.0, shape[0]).astype(np.float32)
    _, params, port = _jax_net(dim, mults, x, t)
    with torch.no_grad():
        got, plan = _replayed_forward(port, x, torch.from_numpy(t), grid=16)
        plain = port.forward_plain(torch.from_numpy(x), torch.from_numpy(t))
    assert any(s.ints.get("splits", 1) > 1 for s in plan.stages)
    assert any(s.op == km.LA_CONTEXT and s.ints["S"] > 1 for s in plan.stages)
    assert_close(got, plain, RTOL)
    mega.set_interpret(True)
    try:
        packed = mega.pack_unet2d_mega(params, dim=dim, dim_mults=mults, groups=1,
                                       weight_dtype=None)
        apply = jax.jit(lambda p, x, t: mega.unet2d_mega_apply(p, x, t, groups=1,
                                                                batch_tile=shape[0]))
        ref = np.asarray(apply(packed, jnp.asarray(x), jnp.asarray(t)))
    finally:
        mega.set_interpret(False)
    assert_close(got, ref, MEGA_RTOL)


def test_port_mega_512_token_bottleneck_plans_and_matches_flax():
    """A 2-level dim-16 net on (2, 16, 128, 2): the bottleneck is 8 x 64 =
    512 tokens. Its plan passes the kernel's checks (full attention as K6's
    three steps, four 64-query tiles per head), and the replayed table
    matches the JAX net."""
    dim, mults, shape = 16, (1, 2), (2, 16, 128, 2)
    x = rand(*shape, seed=2)
    t = np.array([3.0, 700.0], np.float32)
    jnet, params, port = _jax_net(dim, mults, x, t)
    with torch.no_grad():
        got, plan = _replayed_forward(port, x, torch.from_numpy(t), grid=kb.SM_COUNT)
    att = [s for s in plan.stages if s.op in (km.ATT_QKV, km.ATT_CORE, km.ATT_OUT)]
    assert [s.op for s in att] == [km.ATT_QKV, km.ATT_CORE, km.ATT_OUT]
    assert all(s.ints["H"] * s.ints["W"] == 512 for s in att)
    ref = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    assert_close(got, ref, RTOL)


@pytest.mark.parametrize("case", ["heads", "channels", "dtype"])
def test_port_mega_kernel_plan_check_refuses(burgers_packs, case):
    """check_kernel_plan refuses a plan the kernel cannot take (8 heads of
    16, a net of 6 channels, float64 weights), where the recorder itself
    does not."""
    packs, groups = burgers_packs
    shape, heads = (1, 16, 128, 64), (4, 32)
    if case == "heads":
        heads = (8, 16)
    else:
        net = UNet2D(dim=6 if case == "channels" else 8, dim_mults=(1,))
        if case == "dtype":
            net = net.double()
        with torch.no_grad():
            packs, groups = net.pack(), net.groups
        shape = (1, 16, 128, net.dim)
    plan = km.mega_plan(packs, shape, groups, *heads, "cpu")
    with pytest.raises(TypeError if case == "dtype" else ValueError):
        km.check_kernel_plan(plan)
