"""K8 (``UNet2D.forward_mega``) and K7 (``resblock_pair``) with bfloat16
weight packs, on the CPU: the plain replay that is K7's and K8's bf16 plain
version, against the JAX mega kernel on its bf16 packs and against the
port's own bf16 forward; K8's bf16 stage table replayed phase by phase; and
the plan checks that hold a bf16 plan to what the kernel's bf16
instantiation takes.

The rule (``pack_unet2d_mega``'s default ``weight_dtype=bfloat16``,
``research/pallas_unet2d_mega.py:72``): the matmul weights are bf16, the
float32 activation is rounded to bf16 at each matmul (``_mm`` :113-114, the
wide conv :93-94, the downsample :224-225), sums are float32; GroupNorm,
ChanLN, the softmaxes and the attention products stay float32, and the init
and final convs take bf16-rounded weights on a float32 input.

Tolerances, max |port - ref| <= rtol * max(1, max |ref|):
- ``forward_mega`` (bf16 packs) against ``unet2d_mega_apply`` on
  ``pack_unet2d_mega(weight_dtype=bf16)`` (jitted, interpret mode):
  NET_RTOL 1e-2, the bound of ``test_torch_port_bf16.py``'s whole-net test
  (measured 7.5e-3 at dim 16 and 4.4e-3 at dim 8: a float32 sum in another
  order moves an activation across a bf16 rounding boundary now and then,
  and that step, 2^-8 of one term, cascades through the ResBlocks' single
  GroupNorm group; the same test file measured the bf16 Pallas forward
  itself moving by 6.6e-3 when its input moves by 1e-7 relative);
- ``forward_mega`` against the port's bf16 ``UNet2D.forward`` on the CPU:
  equal (both run the plain versions through the same block sequence on
  the same packs); against the float32 ``forward_mega``: more than 1e-3
  apart (measured 7.8e-3 and 5.2e-3), so the packs are bf16;
- the bf16 stage table replayed on the CPU against ``unet2d_mega_plain``:
  NET_RTOL (measured 4.2e-3, the same cascade from another summation order;
  a barrier missing or a live buffer reused gives NaN or O(1) errors, the
  workspace starting as NaN).

The bf16 plan's integers are held exactly: the conv and down stages on the
bf16 core's tiles (MEGA_TILES_BF16) and 64-deep stages, TMA boxes exactly
where ``unet2d_blocks.tma_boxes`` (igemm_bf16::launch's rule) allows them,
the tensor maps' geometry and alignment, K5's and K6's plans for the
plan's grid; and the float32 plan's table as it was recorded before the
bf16 instance changed (digests of its integers, weight addresses zeroed).

The kernels themselves run only on the card: the bf16 K7/K8 tests of
``test_torch_port_cuda.py`` and ``chip_smoke.py`` phases 9 and 10.
"""

import hashlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_mega as tm
from diffphycon_tpu.research import pallas_unet2d_mega as mega
from diffphycon_tpu_torch.kernels import attention as ka
from diffphycon_tpu_torch.kernels import unet2d_blocks as kb
from diffphycon_tpu_torch.kernels import unet2d_mega as km
from diffphycon_tpu_torch.nets.init import seeded_init_
from diffphycon_tpu_torch.nets.unet2d import UNet2D, _conv_nchw
from diffphycon_tpu_torch.utils import convert
from torch_port_helpers import assert_close, rand

BF16 = torch.bfloat16
NET_RTOL = 1e-2


@pytest.fixture(autouse=True)
def _interpret():
    mega.set_interpret(True)
    yield
    mega.set_interpret(False)


def _bf16_net(dim, mults, channels=2, groups=1, seed=0):
    net = UNet2D(dim=dim, dim_mults=mults, channels=channels, out_dim=channels,
                 resnet_block_groups=groups, weight_dtype=BF16)
    return seeded_init_(net, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("dim,mults,shape", [(16, (1, 2, 4), (4, 16, 128, 2)),
                                             (8, (1, 2), (3, 8, 64, 3))])
def test_bf16_forward_mega_matches_pallas_mega_bf16(dim, mults, shape):
    x = rand(*shape, seed=1)
    t = np.linspace(0.0, 999.0, shape[0]).astype(np.float32)
    params, port32 = tm._nets(dim, mults, shape[-1], 1, x, t)
    port = convert.load_flax_unet2d(
        UNet2D(dim=dim, dim_mults=mults, channels=shape[-1], out_dim=shape[-1],
               weight_dtype=BF16), params)
    packed = mega.pack_unet2d_mega(params, dim=dim, dim_mults=mults, groups=1,
                                   weight_dtype=jnp.bfloat16)
    apply = jax.jit(lambda p, x, t: mega.unet2d_mega_apply(p, x, t, groups=1,
                                                            batch_tile=shape[0]))
    ref = np.asarray(apply(packed, jnp.asarray(x), jnp.asarray(t)))
    kb.reset_launch_counts()
    with torch.no_grad():
        out = port.forward_mega(torch.from_numpy(x), torch.from_numpy(t))
        fwd = port(torch.from_numpy(x), torch.from_numpy(t))
    assert all(v == 0 for v in kb.launch_counts().values())  # CPU: nothing launched
    assert_close(out, ref, NET_RTOL)
    torch.testing.assert_close(out, fwd, rtol=0, atol=0)
    with torch.no_grad():
        fp32 = port32.forward_mega(torch.from_numpy(x), torch.from_numpy(t))
    assert float((out - fp32).abs().max()) > 1e-3 * max(1.0, float(fp32.abs().max()))


_mm_fp32 = tm._mm


def _mm_bf16(a, b, tc3):
    """The replay's products with the kernel's bf16 rule where the weight
    is bf16 (``unet2d_blocks.matmul_w``); float32 operands as before."""
    if b.dtype == BF16:
        return kb.matmul_w(a, b)
    return _mm_fp32(a, b, tc3)


def test_bf16_mega_stage_table_replays_to_the_plain_forward(monkeypatch):
    """The 4-level Burgers layout at dim 8 with bf16 packs: every matmul
    stage holds a bf16 weight, the table is the float32 one's, and its
    replay matches the bf16 plain replay."""
    net = _bf16_net(8, (1, 2, 4, 8))
    t = torch.tensor([3.0, 600.0])
    with torch.no_grad():
        x = torch.from_numpy(rand(2, 16, 128, 2, seed=3))
        packs = net.pack()
        x0, film = _conv_nchw(x, net.init_conv, BF16), net._film(t, packs)
        plan = km.mega_plan(packs, x0.shape, net.groups, 4, 32, x0.device)
        assert plan.weight_dtype == BF16
        for st in plan.stages:
            for slot in km.MATMUL_SLOTS.get(st.op, ()):
                assert st.ptrs[slot].dtype == BF16, (km.OP_NAMES[st.op], slot)
        km.check_kernel_plan(plan)  # what a CUDA plan is held to
        net32 = _bf16_net(8, (1, 2, 4, 8))
        net32.weight_dtype = torch.float32
        plan32 = km.mega_plan(net32.pack(), x0.shape, net.groups, 4, 32, x0.device)
        assert plan.counts() == plan32.counts() and plan.barriers() == plan32.barriers()
        monkeypatch.setattr(tm, "_mm", _mm_bf16)
        got = tm._replay(plan, (x0, film), list(tm._tensors(packs)))
        ref = km.unet2d_mega_plain(x0, film, packs, plan)
    assert torch.isfinite(got).all()
    assert_close(got, ref, NET_RTOL)


def test_bf16_resblock_pair_plain_takes_bf16_packs():
    """K7's plain version on a bf16 pair pack equals two bf16 plain
    ResBlocks (the bf16 conv rule), and K7's plan for it is a bf16 plan."""
    net = _bf16_net(16, (1, 2))
    with torch.no_grad():
        p_a, p_b = net.pack()["res"][:2]
        x = torch.from_numpy(rand(2, 16, 128, 16, seed=5))
        ss_a, ss_b = (torch.from_numpy(0.5 * rand(2, 32, seed=s)) for s in (6, 7))
        pair = kb.resblock_pair(x, ss_a, ss_b, p_a, p_b)
        two = kb.resblock_plain(kb.resblock_plain(x, ss_a, p_a), ss_b, p_b)
        plan = km._pair_plan(tuple(x.shape), (32, 32), 1, p_a, p_b, "cpu")
    assert p_a["w1"].dtype == BF16
    torch.testing.assert_close(pair, two, rtol=0, atol=0)
    assert plan.weight_dtype == BF16 and plan.counts()["conv"] == 4
    km.check_kernel_plan(plan)


@pytest.mark.parametrize("case", ["mixed_matmul", "bf16_bias", "rows_of_12", "map_offset_8"])
def test_bf16_mega_kernel_plan_check_refuses(case):
    """check_kernel_plan refuses a plan the bf16 instantiation cannot take:
    one float32 matmul weight in a bf16 plan (no mixed plans: one launch runs
    one instantiation), a bf16 bias, bf16 weight rows of 12 (the bf16
    tiles move 8 weights per 16-byte copy), and a tensor map whose global
    address is not 16-byte aligned (TMA's rule)."""
    dim = 12 if case == "rows_of_12" else 8
    net = _bf16_net(dim, (1, 2))
    with torch.no_grad():
        packs = net.pack()
    res = packs["res"][0]
    if case == "mixed_matmul":
        res["w1"] = res["w1"].float()
    elif case == "bf16_bias":
        res["b1"] = res["b1"].to(BF16)
    plan = km.mega_plan(packs, (1, 16, 128, dim), net.groups, 4, 32, "cpu")
    if case == "map_offset_8":
        plan.map_specs[1, 3] += 8
    err = TypeError if case in ("mixed_matmul", "bf16_bias") else ValueError
    match = {"rows_of_12": "multiple of 8", "map_offset_8": "16-byte"}.get(case, "mixed")
    with pytest.raises(err, match=match):
        km.check_kernel_plan(plan)


def _conv_grid(st):
    """(gh, gw, scale, ca, cb, Hs, Ws) of a conv or down stage: the grid its
    tiles walk (the output's, through the upsample the source's), the
    traversal stride, the sources' channels and size."""
    i = st.ints
    if st.op == km.DOWN:
        return i["H"] // 2, i["W"] // 2, 2, i["ca"], 0, i["H"], i["W"]
    hs, ws = (i["H"] // 2, i["W"] // 2) if i["up"] else (i["H"], i["W"])
    return hs, ws, 1, i["ca"], i["cb"], hs, ws


@pytest.mark.parametrize("dim,mults,batch,grid", [(64, (1, 2, 4, 8), 50, 132),
                                                  (64, (1, 2, 4, 8), 16, 132),
                                                  (64, (1, 2, 4, 8), 1, 132),
                                                  (64, (1, 2, 4, 8), 50, 114),
                                                  (16, (1, 2, 4), 3, 132)])
def test_bf16_mega_plan_takes_the_bf16_core_plans(dim, mults, batch, grid):
    """K8's bf16 plan at the Burgers width (batch 50, 16, 1; the grid of an
    H100 and a smaller one) and a dim-16 net: every conv and down stage on a
    tile of MEGA_TILES_BF16 (128 x 256 for conv stages by boxes alone) whose
    splits cover K in 64-deep stages, none empty; the A tile by TMA boxes
    exactly where tma_boxes allows it, the
    boxes' maps on the stage's own sources with the rule's box (and K2's
    stride 2), the arrival counters for the tiles it walks (through the
    upsample 4 ceil(B gh gw / 128) tile rows); every map record 64-byte
    aligned in the array and every mapped address and stride 16-byte
    aligned; K5's chunks, head groups and K5b's (tile rows, work items),
    and K6's 64-token tiles, the attention plans for the plan's grid."""
    net = _bf16_net(dim, mults)
    with torch.no_grad():
        packs = net.pack()
    plan = km.mega_plan(packs, (batch, 16, 128, dim), net.groups, 4, 32, "cpu", grid=grid)
    km.check_kernel_plan(plan)
    assert plan.grid == grid and km.MAP_BYTES % 64 == 0
    specs = plan.map_specs
    assert len(specs) and (specs[:, 3] % 16 == 0).all() and (specs[:, 8:11] % 16 == 0).all()
    assert set(specs[:, 2].tolist()) <= {0, 1, 2}  # weights, the workspace, x0
    counters, boxed = 0, 0
    for st, row in zip(plan.stages, plan.table):
        i = st.ints
        ext = dict(zip(km.EXTRA, row[km.EXT:].tolist()))
        if st.op in (km.CONV, km.DOWN):
            assert (i["bm"], i["bn"]) in km.MEGA_TILES_BF16
            assert i["bn"] < 256 or (st.op == km.CONV and ext["boxes"])  # compiled for no other
            k = (i["ks"] ** 2 * (i["ca"] + i["cb"])) if st.op == km.CONV else 4 * i["ca"]
            stages = math.ceil(k / kb.TC_BK_BF16)
            assert (i["splits"] - 1) * i["per"] < stages <= i["splits"] * i["per"]
            gh, gw, scale, ca, cb, hs, ws = _conv_grid(st)
            box = kb.tma_boxes(128, gh, gw, ca, cb, scale)
            assert ext["boxes"] == (box is not None)
            w = specs[ext["map_w"]]
            assert w[0] == 0 and w[1] == 2 and w[2] == 0 and w[3] == st.ptrs["w"].data_ptr()
            assert list(w[4:6]) == [i["co"], k] and list(w[11:13]) == [64, 64]
            for name, c in (("map_a", ca), ("map_b", cb)):
                if box is None or c == 0:
                    assert ext[name] == -1
                    continue
                m = specs[ext[name]]
                src = st.ptrs["x" if name == "map_a" else "x2"]
                assert (m[2], m[3]) == (src.base, src.off) and src.shape == (batch, hs, ws, c)
                assert list(m[4:8]) == [c, ws, hs, batch]
                assert list(m[11:19]) == [32, box[0] * scale, box[1] * scale, box[2], 1, scale,
                                          scale, 1]
            boxed += box is not None
            m = batch * gh * gw if st.op == km.DOWN or not i["up"] else batch * gh * gw * 4
            tiles_m = (4 * math.ceil(batch * gh * gw / 128) if box is not None and i.get("up")
                       else math.ceil(m / 128))
            if i["splits"] > 1:
                assert st.ptrs["cnt"].first == counters
                counters += tiles_m * math.ceil(i["co"] / i["bn"])
        elif st.op == km.LA_CONTEXT:
            n = i["H"] * i["W"]
            assert (i["chunk"], i["S"]) == ka.la_chunk_plan(batch, n, grid)
            assert i["hg"] == ka.la_head_groups(batch, i["S"], grid, C=i["co"], bf16=True)
            assert st.ptrs["cnt"].first == counters
            counters += batch
            assert specs[ext["map_w"]][3] == st.ptrs["aux"].data_ptr()
        elif st.op == km.LA_OUTPUT:
            assert (i["tr"], ext["ctas"]) == ka.la_output_plan(batch, i["H"] * i["W"], i["co"],
                                                               grid)
            assert ext["map_a"] == ext["map_w"] + 1  # OutMaps: wqkv, then wo
            assert specs[ext["map_w"]][3] == st.ptrs["aux"].data_ptr()
            assert specs[ext["map_a"]][3] == st.ptrs["x2"].data_ptr()
        elif st.op in (km.ATT_QKV, km.ATT_OUT):
            assert i["tr"] == 64
            wt = st.ptrs["aux" if st.op == km.ATT_QKV else "x2"]
            assert specs[ext["map_w"]][3] == wt.data_ptr()
    assert counters == plan.n_counters
    assert boxed > 0 if dim == 64 else boxed < len([s for s in plan.stages
                                                   if s.op in (km.CONV, km.DOWN)])


# the float32 plans' tables (their first 38 columns, weight addresses
# zeroed) as the parent of the bf16 redesign recorded them: (dim, mults,
# batch) -> (digest, workspace bytes, counters, barriers)
FP32_TABLES = {(8, (1, 2, 4, 8), 2): ("e0ed350522f4d8e0", 2963968, 47, 141),
               (64, (1, 2, 4, 8), 50): ("878439705c49e58e", 409569280, 3128, 141),
               (16, (1, 2), 2): ("a8068058915efac2", 6211328, 200, 81)}


@pytest.mark.parametrize("dim,mults,batch", list(FP32_TABLES))
def test_fp32_mega_plan_table_is_the_recorded_one(dim, mults, batch):
    """The float32 instance's plan is unchanged integer for integer: the
    table's first 38 columns (weight addresses zeroed) hash to the digest
    recorded before the bf16 instance moved to the bf16 bodies, with the
    same workspace, counters and barriers; its bf16-only columns are 0
    (boxes, work items) and -1 (no tensor maps), and it lists no map."""
    net = seeded_init_(UNet2D(dim=dim, dim_mults=mults), torch.Generator().manual_seed(0))
    with torch.no_grad():
        plan = km.mega_plan(net.pack(), (batch, 16, 128, dim), net.groups, 4, 32, "cpu")
    t = plan.table[:, :km.EXT].copy()
    off, base = t[:, km.OFF:km.OFF + len(km.SLOTS)], t[:, km.BASE:km.BASE + len(km.SLOTS)]
    off[base == 0] = 0
    got = (hashlib.sha256(t.tobytes()).hexdigest()[:16], plan.workspace_bytes,
           plan.n_counters, plan.barriers())
    assert km.EXT == 38 and got == FP32_TABLES[dim, mults, batch]
    assert (plan.table[:, km.EXT:] == [0, 0, -1, -1, -1]).all() and len(plan.map_specs) == 0
