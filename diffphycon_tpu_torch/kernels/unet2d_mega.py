"""K7 and K8: the persistent UNet2D kernel (``csrc/unet2d_persistent.cuh``)
behind :func:`unet2d_mega` and :func:`kernels.unet2d_blocks.resblock_pair`.

The port of ``diffphycon_tpu/research/pallas_unet2d_mega.py`` (the whole
UNet2D forward in one ``pallas_call``, :392) and of ``_resblock_pair_kernel``
(``research/pallas_unet2d.py:170``, two ResnetBlocks in one call). One CUDA
kernel carries both: a cooperative launch that walks a table of stages
(convs, GroupNorm statistics and apply, linear and full attention) with a
grid-wide barrier wherever a stage reads what an earlier one of the same
phase wrote.

The stage table is recorded on the host by running the block sequence with
recording ops (:class:`_Recorder`) in place of the kernel wrappers:

- :func:`unet2d_sequence` is THE block sequence between the init conv and
  the final conv; ``UNet2D.forward`` and ``forward_plain`` run it with the
  K1-K6 wrappers or the plain versions, :func:`unet2d_mega_plain` with the
  plain versions, and :func:`mega_plan` records K8's stages from it (the
  counterpart of ``_block_plan``, pallas_unet2d_mega.py:245-266);
- ResnetBlocks are recorded through ``unet2d_blocks._resblock``, the same
  function the per-block forward runs.

A plan holds the stage table, the workspace size (every intermediate lives
in one workspace tensor; a buffer is reused once every stage that reads it
has passed a barrier) and the weights' addresses. :func:`mega_plan` builds it
once per weight pack and input shape and caches it in the pack, which
``UNet2D`` caches until a parameter changes. Pointers in the table are
relative to a few bases (the workspace, the call's inputs and its output),
so a cached plan serves every call.

Each stage runs the tensor-core body of the per-block kernel it stands
for: the convs K1's 3xTF32 ``wgmma`` tile on a tile plan
(``unet2d_blocks.pick_plan``) made for the persistent grid (128-row tiles,
:data:`MEGA_TILES`), split-K reduced inside the launch by the last split of
a tile to finish, in split order; linear attention K5's bodies (chunked
context, merged in chunk order by the last chunk of a sample to finish,
then the output tiles); full attention K6's three steps (any token count).
The plan holds each stage's choices: K1's, K5's and K6's host plans with
the persistent grid (:func:`grid_blocks`: one 256-thread CTA per SM; a CPU
plan takes ``SM_COUNT``) in place of the card's SMs.

A bf16 plan runs the per-block bf16 kernels' Hopper bodies
(``igemm_bf16.cuh``, ``attention_bf16.cuh``) with their host plans for this
grid: the convs on :data:`MEGA_TILES_BF16` in 64-deep stages, the A tile by
TMA boxes where ``unet2d_blocks.tma_boxes`` allows them; K5a's head groups,
K5b's (tile rows, work items) from ``attention.la_output_plan``, K6's
64-token tiles. Those bodies read their weights, and the boxes their
activations, through tensor maps: the plan lists them (``Plan.map_specs``,
each a weight's or an activation buffer's box geometry), and a launch
needs them encoded for the addresses it runs on. The workspace and the
inputs are allocated per call, so every launch encodes its maps on the
host and writes them into a fresh device array on its own stream, before
the kernel (``unet2d_persistent_maps``: a kernel that takes the encoded
records as its parameters), as it allocates its workspace. So two streams
never share an array, and a CUDA graph captures the writing kernels with
their records by value, on an array of the graph's pool that each replay
writes again before its kernel reads it. That costs the host
``maps_host_us`` and the device ``maps_device_us`` a launch, beside the
launch's ``kernel_ms`` (``chip_smoke.py`` phase 10's ``unet2d_mega_bf16``
record).

The kernel takes float32 or bfloat16 matmul weights, one type per plan
(``Plan.weight_dtype``: the launch picks the kernel's float or bf16
instantiation, ``unet2d_persistent_f32`` / ``_bf16``), channel counts (and
channels per GroupNorm group) that are multiples of 4, bf16 weight rows of
a multiple of 8, 4 heads of 32 and at most 512 channels in the attention
blocks; the plan raises otherwise. With bf16 packs (``UNet2D(weight_dtype=
torch.bfloat16)``, bit-equal to ``pack_unet2d_mega(..., weight_dtype=
bf16)``) every matmul rounds its float32 activation to bf16 and sums in
float32, as the Pallas mega kernel and the plain replay (the bf16 plain
ops) do; biases, norms, softmaxes and the attention cores stay float32.
It is forward-only, as the Pallas call (no VJP).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from diffphycon_tpu_torch.kernels import _build, register_launch_counters
from diffphycon_tpu_torch.kernels import attention as ka
from diffphycon_tpu_torch.kernels import unet2d_blocks as kb
from diffphycon_tpu_torch.utils.profiling import in_span, recording

KERNEL_OPS = (kb.resblock, kb.downsample_nhwc, kb.conv2d_nhwc, ka.linear_attention_block,
              ka.attention_block)
PLAIN_OPS = (kb.resblock_plain, kb.downsample_nhwc_plain, kb.conv2d_nhwc_plain,
             ka.linear_attention_block_plain, ka.attention_block_plain)
# the span each of the five ops runs in (unet2d_sequence)
OP_SPANS = ("nets.block.resblock", "nets.block.downsample", "nets.block.conv",
            "nets.block.linear_attention", "nets.block.attention")

# the persistent kernel's conv tiles: igemm_tc's 128-row tiles (two
# warpgroups fill its 256 threads), one CTA per SM, K1's measured costs
MEGA_TILES = {tile: cost for tile, cost in kb.TC_TILES.items() if tile[0] == 128}
# the bf16 instance's: igemm_bf16's 128-row tiles (its 64 x 64 tile takes
# 128-thread CTAs), the bf16 core's measured costs. 128 x 256 only for conv
# stages whose A tile comes by TMA boxes (the instance compiles it for no
# other: the downsamples and the gathers of every plan here take 64-column
# tiles)
MEGA_TILES_BF16 = {tile: cost for tile, cost in kb.TC_TILES_BF16.items() if tile[0] == 128}
_NARROW_BF16 = {tile: cost for tile, cost in MEGA_TILES_BF16.items() if tile[1] <= 128}


# K7 and K8 have no bf16-activation instance: they refuse the flax
# dtype=bfloat16 mode, on the card and in their CPU replay alike
BF16_ACT_REFUSED = ("{}: the persistent kernel (K7/K8) does not run bfloat16 activations "
                    "(flax dtype=bfloat16); ROADMAP.md queue 2 item 10 lists that instance. "
                    "Use forward() / resblock(), or the weight-only mode (weight_dtype=bfloat16)")


def unet2d_sequence(ops, x, film, packs, groups: int, heads: int, dim_head: int):
    """The UNet2D blocks from the init conv's output ``x`` to the input of
    the final 1x1 conv (pallas_unet2d_mega.py:340-381), through ``ops``
    (resblock, downsample, conv, linear attention, full attention). film:
    iterator of the ResBlocks' FiLM (B, 2C) slices in forward order; packs:
    ``UNet2D.pack()``. The last level's resample is a 3x3 conv. The
    activation's dtype runs through: a bfloat16 ``x`` (and film) makes every
    op take its bf16-activation version and return bfloat16, the skips
    included (flax's float32 linear-attention outputs are stored rounded,
    exactly, ``kernels/attention.py``). While a profiler records, each op
    runs in its span of :data:`OP_SPANS`; otherwise the ops run bare (one
    flag check a forward, not one a block)."""
    if recording():
        ops = [functools.partial(in_span, name, op) for name, op in zip(OP_SPANS, ops)]
    resblock, downsample, conv, linear_attn, attn = ops
    res_p = iter(packs["res"])

    def block(x_a, x_b=None):
        return resblock(x_a, next(film), next(res_p), x_b=x_b, groups=groups)

    n = len(packs["down"])
    r = x
    h = []
    for i in range(n):
        x = block(x)
        h.append(x)
        x = block(x)
        x = linear_attn(x, packs["down_attn"][i], heads, dim_head)
        h.append(x)
        p = packs["down"][i]
        x = downsample(x, p["w"], p["b"]) if i < n - 1 else conv(x, p["w"], p["b"], k=3)

    x = block(x)
    x = attn(x, packs["mid_attn"], heads, dim_head)
    x = block(x)

    for i in range(n):
        x = block(x, h.pop())
        x = block(x, h.pop())
        x = linear_attn(x, packs["up_attn"][i], heads, dim_head)
        p = packs["up"][i]
        x = conv(x, p["w"], p["b"], k=3, upsample=i < n - 1)
    return block(x, r)


GN_BLOCK = 1024
_GN_TARGET_PROGRAMS = 528  # ~4 items per CTA of a 132-CTA grid


def chunking(rows: int, L: int):
    """(chunk, S) of the GroupNorm stages: split each of `rows` reductions of
    length L into S non-empty chunks of `chunk` elements (a multiple of
    GN_BLOCK)."""
    want = max(1, min(64, math.ceil(_GN_TARGET_PROGRAMS / rows)))
    chunk = math.ceil(math.ceil(L / want) / GN_BLOCK) * GN_BLOCK
    return chunk, math.ceil(L / chunk)


# ---------------------------------------------------------------------------
# the stage table (layout: csrc/unet2d_persistent.cuh, structs Stage and StageBf16)
# ---------------------------------------------------------------------------

CONV, DOWN, GN_STATS, GN_APPLY, LA_CONTEXT, LA_OUTPUT, ATT_QKV, ATT_CORE, ATT_OUT = range(9)
# the slots that hold a matmul weight, by op: float32 or bfloat16 (one type
# per plan); every other tensor slot (biases, gains, norms) is float32
MATMUL_SLOTS = {CONV: ("w",), DOWN: ("w",), LA_CONTEXT: ("aux",), LA_OUTPUT: ("aux", "x2"),
                ATT_QKV: ("aux",), ATT_OUT: ("x2",)}
OP_NAMES = ("conv", "down", "gn_stats", "gn_apply", "la_context", "la_output", "att_qkv",
            "att_core", "att_out")
INTS = ("op", "sync", "B", "H", "W", "ca", "cb", "co", "ks", "up", "groups", "chunk", "S",
        "ss_stride", "bm", "bn", "splits", "per", "hg", "tr")
SLOTS = {"x": 0, "x2": 1, "w": 2, "bias": 3, "out": 4, "scr": 5, "aux": 6, "res": 7, "cnt": 8}
OFF, BASE = len(INTS), len(INTS) + len(SLOTS)  # columns of the slots' offsets and bases
# the bf16 instance's ints, after the slots: the A tile by TMA boxes, K5b's
# work items, and the stage's tensor maps (indices into Plan.map_specs; -1
# none): map_w the weight's (K5b: wqkv, wo's at map_a = map_w + 1), map_a /
# map_b the boxes of x / x2. The float instance's records end before them.
EXTRA = ("boxes", "ctas", "map_w", "map_a", "map_b")
EXT = BASE + len(SLOTS)
_ROW = EXT + len(EXTRA)  # int64 per stage: 20 ints, 9 offsets, 9 base ids, 5 more
_N_BASES = 8      # 0: null (absolute addresses), 1: workspace, 2..: inputs, then the output
_ALIGN = 256
# a tensor map record: CUtensorMap, 128 bytes, 64-byte aligned in the array
MAP_BYTES = 128
# columns of Plan.map_specs (csrc/unet2d_persistent_bf16.cu: unet2d_persistent_maps):
# element type (0 bf16, 1 fp32), rank, base id, byte offset, dims[4],
# strides[3] (bytes), box[4], element strides[4]
MAP_COLS = 19


class _Val:
    """A tensor of the recorded forward: a workspace buffer (base 1, placed
    by :meth:`_Recorder.finish`) or a bound input / the output."""

    def __init__(self, shape, base: int = 1):
        self.shape = tuple(int(s) for s in shape)
        self.base = base
        self.off = 0

    @property
    def nbytes(self) -> int:
        return 4 * int(np.prod(self.shape))


@dataclass
class _Counters:
    """`n` arrival counters (int32) from int `first` of the workspace's
    counter region."""
    first: int
    n: int


@dataclass
class _Map:
    """A tensor map of the bf16 instance: a bf16 weight's (2-D, 64 x 64
    boxes) or a box geometry of an fp32 NHWC activation (4-D)."""
    target: object  # torch.Tensor (a weight) or _Val
    spec: tuple     # element type, rank, dims[4], strides[3], box[4], element strides[4]


def _weight_map(w: torch.Tensor) -> _Map:
    """hopper_tma::weight_map of a (K, N) row-major bf16 weight."""
    k, n = w.shape
    return _Map(w, (0, 2, n, k, 0, 0, 2 * n, 0, 0, 64, 64, 0, 0, 1, 1, 0, 0))


def _source_map(x: "_Val", box, scale: int) -> _Map:
    """igemm_bf16::source_map of an NHWC source (B, Hs, Ws, C): boxes of 32
    channels x bw x bh pixels (at traversal stride `scale`) x bb images."""
    b, hs, ws, c = x.shape
    bw, bh, bb = box
    return _Map(x, (1, 4, c, ws, hs, b, 4 * c, 4 * c * ws, 4 * c * ws * hs, 32, bw * scale,
                    bh * scale, bb, 1, scale, scale, 1))


@dataclass
class _Film:
    """A FiLM (B, 2C) operand: columns col.. of a bound (B, F) input with
    row stride ``stride`` (floats)."""
    val: _Val
    col: int
    stride: int


@dataclass
class _Stage:
    op: int
    ints: dict
    ptrs: dict    # slot name -> _Val | _Film | torch.Tensor (weights) | None
    writes: tuple
    sync: bool = False

    def reads(self):
        return {id(p.val if isinstance(p, _Film) else p) for p in self.ptrs.values()
                if isinstance(p, (_Val, _Film))} - {id(v) for v in self.writes}


@dataclass
class Plan:
    """A recorded stage table. ``table``: (n_stages, _ROW) int64 (columns
    ``INTS``, then the slots' offsets from ``OFF`` and bases from
    ``BASE``); ``stages``: the records (op codes in ``OP_NAMES`` order);
    ``workspace_bytes`` (its first ``n_counters`` int32 are the arrival
    counters); ``grid``: the CTAs the plan was made for; ``out_shape``;
    groups/heads/dim_head of the recorded net."""
    table: np.ndarray
    stages: list
    workspace_bytes: int
    n_counters: int
    grid: int
    in_shapes: tuple
    out_shape: tuple
    device: torch.device
    groups: int = 1
    heads: int = ka.KERNEL_HEADS
    dim_head: int = ka.KERNEL_DIM_HEAD
    device_table: Optional[torch.Tensor] = None
    map_specs: np.ndarray = field(default_factory=lambda: np.zeros((0, MAP_COLS), np.int64))

    @property
    def weight_dtype(self) -> torch.dtype:
        """The matmul weights' dtype (float32 when the plan holds none);
        :func:`check_kernel_plan` holds a plan for CUDA to one."""
        for st in self.stages:
            for slot in MATMUL_SLOTS.get(st.op, ()):
                return st.ptrs[slot].dtype
        return torch.float32

    def counts(self) -> dict:
        """Stages per op name."""
        out = dict.fromkeys(OP_NAMES, 0)
        for s in self.stages:
            out[OP_NAMES[s.op]] += 1
        return out

    def barriers(self) -> int:
        """Grid barriers per launch: the stages' and the one after the
        counters are zeroed."""
        return sum(s.sync for s in self.stages) + (self.n_counters > 0)


class _Recorder:
    """The kernel wrappers' signatures, recording stages instead of
    computing, with the tile, chunk and token-tile plans of a grid of
    `grid` CTAs. A plan for CUDA is held to what the kernel takes
    (:func:`check_kernel_plan`) when it is finished."""

    def __init__(self, device: torch.device, grid: int = kb.SM_COUNT):
        self.device = torch.device(device)
        self.grid = grid
        self.stages = []
        self.inputs = []
        self.n_counters = 0
        self.maps = []      # _Map records, in index order
        self._map_ids = {}  # (id of the target, spec) -> index

    def input(self, shape) -> _Val:
        self.inputs.append(_Val(shape, base=2 + len(self.inputs)))
        return self.inputs[-1]

    def _new(self, shape) -> _Val:
        return _Val(shape)

    def _counters(self, n: int) -> _Counters:
        c = _Counters(self.n_counters, n)
        self.n_counters += n
        return c

    def _stage(self, op, ptrs, writes, **ints):
        self.stages.append(_Stage(op, ints, ptrs, tuple(writes)))

    def _map(self, m: _Map) -> int:
        """The index of tensor map `m`, one record per (target, spec)."""
        key = (id(m.target), m.spec)
        if key not in self._map_ids:
            self._map_ids[key] = len(self.maps)
            self.maps.append(m)
        return self._map_ids[key]

    def _map_pair(self, a: _Map, b: _Map) -> int:
        """Two new adjacent records (K5b's wqkv and wo); the first's index."""
        self.maps += [a, b]
        return len(self.maps) - 2

    # -- the ops of unet2d_sequence / unet2d_blocks._resblock ---------------

    def _gemm(self, op, ptrs, out, m, k, grid_hw, scale, **ints):
        """A conv or down stage on the tile plan for this grid, one CTA per
        SM (``unet2d_blocks.pick_plan`` over MEGA_TILES, or for a bf16
        weight over MEGA_TILES_BF16 in the bf16 core's 64-deep stages); with
        a split, its partials (splits, m, co) and one arrival counter per
        tile. bf16: the weight's tensor map, and where
        ``unet2d_blocks.tma_boxes`` allows them for the tiles' grid
        ``grid_hw`` (traversal stride ``scale``), the A tile by TMA boxes
        and the sources' maps; through the upsample the tiles walk the
        source grid once per output parity class (4 ceil(B gh gw / 128)
        tile rows, as igemm_bf16::launch_mode)."""
        co = out.shape[-1]
        bf16 = ptrs["w"].dtype == torch.bfloat16
        x_a, x_b = ptrs["x"], ptrs.get("x2")
        box = kb.tma_boxes(128, *grid_hw, x_a.shape[3], 0 if x_b is None else x_b.shape[3],
                           scale) if bf16 else None
        if bf16:
            tiles = MEGA_TILES_BF16 if box is not None and op == CONV else _NARROW_BF16
            # by the modelled time alone, as K1 bf16's tile_plan: K8 bf16 at
            # batch 50 took 6.410 ms a launch so against 6.751 with plans that
            # fill one wave of the grid first (PERF.md section 6, PR 17)
            plan = kb.pick_plan(m, co, k, tiles, kb.SPLIT_US_PER_MFLOAT_BF16, sms=self.grid,
                                bk=kb.TC_BK_BF16, fill_first=False)
        else:
            plan = kb.pick_plan(m, co, k, tiles=MEGA_TILES, sms=self.grid)
        tiles_m = math.ceil(m / plan.bm)
        extra = {}
        if bf16:
            extra["map_w"] = self._map(_weight_map(ptrs["w"]))
            if box is not None:
                extra["boxes"] = 1
                extra["map_a"] = self._map(_source_map(x_a, box, scale))
                if x_b is not None:
                    extra["map_b"] = self._map(_source_map(x_b, box, scale))
                if ints.get("up"):
                    tiles_m = 4 * math.ceil(ints["B"] * grid_hw[0] * grid_hw[1] / plan.bm)
        writes = [out]
        if plan.splits > 1:
            ptrs["scr"] = self._new((plan.splits, m, co))
            ptrs["cnt"] = self._counters(tiles_m * math.ceil(co / plan.bn))
            writes.append(ptrs["scr"])
        self._stage(op, ptrs, writes, bm=plan.bm, bn=plan.bn, splits=plan.splits, per=plan.per,
                    **extra, **ints)

    def conv(self, x_a, w, b, x_b=None, k: int = 3, upsample: bool = False):
        B, hs, ws, ca = x_a.shape
        cb = 0 if x_b is None else x_b.shape[3]
        co = w.shape[-1]
        H, W = (2 * hs, 2 * ws) if upsample else (hs, ws)
        out = self._new((B, H, W, co))
        self._gemm(CONV, {"x": x_a, "x2": x_b, "w": w, "bias": b, "out": out}, out, B * H * W,
                   k * k * (ca + cb), (hs, ws), 1, B=B, H=H, W=W, ca=ca, cb=cb, co=co, ks=k,
                   up=int(upsample))
        return out

    def downsample(self, x, w, b):
        B, H, W, C = x.shape
        co = w.shape[-1]
        out = self._new((B, H // 2, W // 2, co))
        self._gemm(DOWN, {"x": x, "w": w, "bias": b, "out": out}, out, B * (H // 2) * (W // 2),
                   4 * C, (H // 2, W // 2), 2, B=B, H=H, W=W, ca=C, co=co)
        return out

    def group_norm_act(self, x, gamma, beta, groups: int = 1, ss=None, res=None):
        B, H, W, C = x.shape
        if C % groups:
            raise ValueError(f"unet2d_mega: C={C} in {groups} groups")
        chunk, S = chunking(B * groups, H * W * (C // groups))
        part = self._new((B * groups * S, 2))
        geo = dict(B=B, H=H, W=W, co=C, groups=groups, chunk=chunk, S=S)
        self._stage(GN_STATS, {"x": x, "scr": part}, [part], **geo)
        out = self._new(x.shape)
        self._stage(GN_APPLY, {"x": x, "scr": part, "w": gamma, "bias": beta, "aux": ss,
                               "res": res, "out": out}, [out],
                    ss_stride=0 if ss is None else ss.stride, **geo)
        return out

    def resblock(self, x_a, ss, p, x_b=None, groups: int = 1):
        return kb._resblock(self.conv, self.group_norm_act, x_a, x_b, ss, p, groups)

    def linear_attn(self, x, p, heads, dim_head):
        """K5a per (chunk, sample, head group), the merge by the last chunk
        of a sample to arrive, then K5b (bf16: over la_output_plan's tiles
        of the flattened tokens, in `ctas` work items)."""
        geo = _geometry(x)
        B, n, C = x.shape[0], x.shape[1] * x.shape[2], x.shape[3]
        bf16 = p["wqkv"].dtype == torch.bfloat16
        chunk, S = ka.la_chunk_plan(B, n, self.grid)
        hg = ka.la_head_groups(B, S, self.grid, C=C, bf16=bf16)
        hidden = ka.KERNEL_HEADS * ka.KERNEL_DIM_HEAD
        part = self._new((B, S, hidden, ka.LA_PART))
        ctx = self._new((B, ka.KERNEL_HEADS, ka.KERNEL_DIM_HEAD, ka.KERNEL_DIM_HEAD))
        common = {"x": x, "w": p["norm_g"], "aux": p["wqkv"]}
        maps_a, maps_b = {}, {}
        if bf16:
            maps_a = {"map_w": self._map(_weight_map(p["wqkv"]))}
            first = self._map_pair(_weight_map(p["wqkv"]), _weight_map(p["wo"]))
            tr, ctas = ka.la_output_plan(B, n, C, self.grid)
            maps_b = {"map_w": first, "map_a": first + 1, "tr": tr, "ctas": ctas}
        self._stage(LA_CONTEXT, {**common, "scr": part, "out": ctx, "cnt": self._counters(B)},
                    [part, ctx], chunk=chunk, S=S, hg=hg, **maps_a, **geo)
        out = self._new(x.shape)
        self._stage(LA_OUTPUT, {**common, "scr": ctx, "x2": p["wo"], "bias": p["bo"],
                                "res": p["out_g"], "out": out}, [out], **maps_b, **geo)
        return out

    def attn(self, x, p, heads, dim_head):
        """K6a (qkv of token tiles across samples), K6b (the online softmax),
        K6c (out-projection, bias, residual): any token count."""
        geo = _geometry(x)
        B, n = x.shape[0], x.shape[1] * x.shape[2]
        bf16 = p["wqkv"].dtype == torch.bfloat16
        tr = ka.attn_tile_rows(B, n, self.grid, bf16=bf16)
        hidden = ka.KERNEL_HEADS * ka.KERNEL_DIM_HEAD
        qkv = self._new((B * n, 3 * hidden))
        map_q = {"map_w": self._map(_weight_map(p["wqkv"]))} if bf16 else {}
        self._stage(ATT_QKV, {"x": x, "w": p["norm_g"], "aux": p["wqkv"], "out": qkv}, [qkv],
                    tr=tr, **map_q, **geo)
        o = self._new((B * n, hidden))
        self._stage(ATT_CORE, {"x": qkv, "out": o}, [o], **geo)
        out = self._new(x.shape)
        map_o = {"map_w": self._map(_weight_map(p["wo"]))} if bf16 else {}
        self._stage(ATT_OUT, {"x": x, "scr": o, "x2": p["wo"], "bias": p["bo"], "out": out},
                    [out], tr=tr, **map_o, **geo)
        return out

    @property
    def ops(self):
        return (self.resblock, self.downsample, self.conv, self.linear_attn, self.attn)

    # -- barriers, workspace, table -------------------------------------------

    def finish(self, out: _Val, **meta) -> Plan:
        """Place the barriers and the workspace buffers, bind ``out`` to the
        output base, and write the table."""
        stages = self.stages
        out.base = 2 + len(self.inputs)
        # a barrier before any stage that reads what its phase wrote, or
        # writes what its phase read or wrote
        phase_of, reads, writes, phase = [], set(), set(), 0
        for i, st in enumerate(stages):
            r, w = st.reads(), {id(v) for v in st.writes}
            if r & writes or w & (reads | writes):
                stages[i - 1].sync = True
                phase += 1
                reads, writes = set(), set()
            reads |= r
            writes |= w
            phase_of.append(phase)
        # workspace: a buffer is free again after the last phase that reads
        # it; reused by exact size (the UNet's shapes recur level by level)
        last = {}
        for st, ph in zip(stages, phase_of):
            for key in st.reads() | {id(v) for v in st.writes}:
                last[key] = ph
        # the arrival counters first, then the buffers
        counters_bytes = -(-4 * self.n_counters // _ALIGN) * _ALIGN
        free, top, by_phase = {}, counters_bytes, {}
        for st, ph in zip(stages, phase_of):
            for v in st.writes:
                by_phase.setdefault(ph, []).append(v)
        vals = {id(v): v for st in stages for v in st.writes}
        for ph in range(phase + 1):
            for v in by_phase.get(ph, ()):
                if v.base != 1:
                    continue
                size = -(-v.nbytes // _ALIGN) * _ALIGN
                if free.get(size):
                    v.off = free[size].pop()
                else:
                    v.off, top = top, top + size
            for key, ph_last in last.items():
                v = vals.get(key)
                if ph_last == ph and v is not None and v.base == 1:
                    free.setdefault(-(-v.nbytes // _ALIGN) * _ALIGN, []).append(v.off)
        table = np.zeros((len(stages), _ROW), np.int64)
        for i, st in enumerate(stages):
            ints = {"op": st.op, "sync": int(st.sync), **st.ints}
            for k, name in enumerate(INTS):
                table[i, k] = ints.get(name, 0)
            for name, p in st.ptrs.items():
                base, off = _resolve(p)
                table[i, OFF + SLOTS[name]] = off
                table[i, BASE + SLOTS[name]] = base
            for k, name in enumerate(EXTRA):
                table[i, EXT + k] = ints.get(name, -1 if name.startswith("map_") else 0)
        specs = np.zeros((len(self.maps), MAP_COLS), np.int64)
        for j, m in enumerate(self.maps):
            specs[j, :2] = m.spec[:2]
            specs[j, 2:4] = _resolve(m.target)
            specs[j, 4:] = m.spec[2:]
        plan = Plan(table, stages, max(top, _ALIGN), self.n_counters, self.grid,
                    tuple(v.shape for v in self.inputs), out.shape, self.device, **meta,
                    map_specs=specs)
        if self.device.type == "cuda":
            check_kernel_plan(plan)
        return plan


def _geometry(x: _Val) -> dict:
    B, H, W, C = x.shape
    return dict(B=B, H=H, W=W, co=C)


def check_kernel_plan(plan: Plan) -> None:
    """Hold a recorded plan to what the persistent kernel takes, or raise:
    weights on the plan's device, 16-byte aligned; the matmul weights
    (``MATMUL_SLOTS``) all float32 or all bfloat16 (one instantiation per
    launch; bf16 rows of a multiple of 8), every other weight float32; 3x3
    or 1x1 convs and downsamples of even sizes whose weights fit their
    channels; channel counts, and channels per GroupNorm group, multiples
    of 4; 4 heads of 32 and 4 to 512 channels in the attention stages; no
    buffer of more than 2^31-1 elements; 128 x 256 tiles for conv stages by
    TMA boxes alone; tensor maps on 16-byte aligned addresses and strides.
    A plan for CUDA is checked when it is recorded."""
    wdt = plan.weight_dtype
    if wdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unet2d_mega: matmul weights of dtype {wdt}; the kernel takes float32 "
                        "or bfloat16")
    for st in plan.stages:
        name = f"unet2d_mega {OP_NAMES[st.op]}"
        i = st.ints
        weights = [t for t in st.ptrs.values() if isinstance(t, torch.Tensor)]
        matmul = MATMUL_SLOTS.get(st.op, ())
        for slot, t in st.ptrs.items():
            if not isinstance(t, torch.Tensor):
                continue
            if t.device != plan.device:
                raise ValueError(f"{name}: a weight is on {t.device}, the input on {plan.device}")
            want = wdt if slot in matmul else torch.float32
            if t.dtype != want:
                raise TypeError(f"{name}: {slot} has dtype {t.dtype}, the plan's "
                                f"{'matmul weights' if slot in matmul else 'biases and norms'} "
                                f"{want} (no mixed float32 / bfloat16 plans)")
            if slot in matmul and wdt == torch.bfloat16 and t.shape[-1] % 8:
                raise ValueError(f"{name}: bfloat16 weights need rows of a multiple of 8, "
                                 f"got {tuple(t.shape)}")
            if slot in matmul and wdt == torch.bfloat16 and t.data_ptr() % 16:
                raise ValueError(f"{name}: {slot} must start 16-byte aligned (a TMA map's "
                                 "global address)")
        kb._check_vec4(name, (), weights)
        for v in st.writes:
            if int(np.prod(v.shape)) > kb._INT32_MAX:
                raise ValueError(f"{name}: intermediate {v.shape} exceeds 2^31-1 elements")
        if i.get("bn") == 256 and (st.op != CONV or not i.get("boxes")):
            raise ValueError(f"{name}: 128 x 256 tiles only for conv stages by TMA boxes "
                             "(the bf16 instance compiles them for no other)")
        if st.op == CONV:
            w, k = st.ptrs["w"], i["ks"]
            if k not in (1, 3) or w.shape != (k * k * (i["ca"] + i["cb"]), i["co"]):
                raise ValueError(f"{name}: weight {tuple(w.shape)} does not fit k={k}, "
                                 f"Ci={i['ca'] + i['cb']}")
            kb._check_vec4(name, (i["ca"], i["cb"], i["co"]), ())
        elif st.op == DOWN:
            w = st.ptrs["w"]
            if i["H"] % 2 or i["W"] % 2 or w.shape != (4 * i["ca"], i["co"]):
                raise ValueError(f"{name}: input {i['H']}x{i['W']}x{i['ca']}, weight "
                                 f"{tuple(w.shape)}")
            kb._check_vec4(name, (i["ca"], i["co"]), ())
        elif st.op == GN_STATS and (i["co"] // i["groups"]) % 4:
            raise ValueError(f"{name}: C={i['co']} in {i['groups']} groups; the kernel takes "
                             "groups of a multiple of 4 channels")
        elif st.op in (LA_CONTEXT, ATT_QKV):
            ka._check_heads(name, plan.heads, plan.dim_head)
            if not 4 <= i["co"] <= ka.MAX_CHANNELS or i["co"] % 4:
                raise ValueError(f"{name}: C={i['co']}; the kernel takes 4 to "
                                 f"{ka.MAX_CHANNELS} channels, a multiple of 4")
    for j, row in enumerate(plan.map_specs):  # TMA: 16-byte aligned addresses and strides
        if row[3] % 16 or any(row[8:11] % 16):
            raise ValueError(f"unet2d_mega: tensor map {j} has address offset {row[3]} or "
                             f"strides {row[8:11].tolist()} not 16-byte aligned")


def _resolve(p):
    """(base id, byte offset) of a pointer slot."""
    if p is None:
        return 0, 0
    if isinstance(p, torch.Tensor):
        return 0, p.data_ptr()
    if isinstance(p, _Film):
        return p.val.base, p.val.off + 4 * p.col
    if isinstance(p, _Counters):
        return 1, 4 * p.first
    return p.base, p.off


# ---------------------------------------------------------------------------
# launch
# ---------------------------------------------------------------------------


def grid_blocks(device) -> int:
    """CTAs of the persistent kernel's cooperative launch on a CUDA device
    (one per SM as the occupancy calculator finds it); ``SM_COUNT`` for a
    CPU plan."""
    device = torch.device(device)
    if device.type != "cuda":
        return kb.SM_COUNT
    return _cuda_grid(device.index if device.index is not None else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _cuda_grid(index: int) -> int:
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _build.load_library().unet2d_persistent_grid(ctypes.byref(blocks))
    _build.check(err, "unet2d_persistent_grid")
    return blocks.value


def _maps(plan: Plan, bases, stream: int, device, lib) -> torch.Tensor:
    """The plan's tensor maps encoded for `bases`, in a new device array
    written on `stream` (see the module docstring)."""
    maps = torch.empty(len(plan.map_specs) * MAP_BYTES, device=device, dtype=torch.uint8)
    err = lib.unet2d_persistent_maps(plan.map_specs.ctypes.data, len(plan.map_specs),
                                     (ctypes.c_int64 * _N_BASES)(*bases), maps.data_ptr(), stream)
    _build.check(err, "unet2d_persistent_maps")
    return maps


def _launch(plan: Plan, inputs, out, lib=None) -> int:
    """One cooperative launch of the plan on CUDA tensors; returns the grid
    size. The caller has checked ``inputs`` and ``out``. lib: the kernel
    library (a diagnostic build; the plain one by default)."""
    if plan.grid != grid_blocks(out.device):
        raise RuntimeError(f"unet2d_persistent: the card runs {grid_blocks(out.device)} CTAs, "
                           f"the plan was made for {plan.grid}")
    bf16 = plan.weight_dtype == torch.bfloat16
    if plan.device_table is None:  # the float instance's records end before EXTRA
        table = plan.table if bf16 else np.ascontiguousarray(plan.table[:, :EXT])
        plan.device_table = torch.from_numpy(table).to(out.device)
    ws = torch.empty(plan.workspace_bytes // 4, device=out.device, dtype=torch.float32)
    bases = [0, ws.data_ptr(), *(t.data_ptr() for t in inputs), out.data_ptr()]
    bases += [0] * (_N_BASES - len(bases))
    grid = ctypes.c_int(0)
    lib = _build.load_library() if lib is None else lib
    stream = kb._stream(out)
    args = (plan.device_table.data_ptr(), len(plan.stages), (ctypes.c_int64 * _N_BASES)(*bases),
            plan.n_counters, ctypes.byref(grid), stream)
    if bf16:
        maps = _maps(plan, bases, stream, out.device, lib)
        err = lib.unet2d_persistent_bf16(*args, maps.data_ptr())
    else:
        err = lib.unet2d_persistent_f32(*args)
    _build.check(err, "unet2d_persistent")
    return grid.value


def _check_inputs(name, plan: Plan, tensors):
    for t, shape in zip(tensors, plan.in_shapes):
        if t.device != plan.device:
            raise ValueError(f"{name}: an input is on {t.device}, the plan on {plan.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: input dtype {t.dtype}; the kernel takes float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: input {tuple(t.shape)}, the plan was recorded for {shape}")
        if t.data_ptr() % 16 or t.stride(-1) != 1 or t.stride(0) % 4:
            raise ValueError(f"{name}: inputs need unit channel stride, rows of a multiple "
                             "of 4 floats and 16-byte alignment")


def _forward_only(name, *tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} is forward-only (no backward kernel, as the Pallas call "
                           "has no VJP): call it under torch.no_grad()")


# ---------------------------------------------------------------------------
# K8: the whole forward
# ---------------------------------------------------------------------------


def mega_plan(packs, x_shape, groups: int, heads: int, dim_head: int, device,
              grid: Optional[int] = None) -> Plan:
    """K8's plan for init-conv outputs of ``x_shape`` (B, H, W, dim), built
    once and cached in ``packs`` (a cached ``UNet2D`` pack lives until a
    parameter changes). grid: the CTAs to plan for (default
    :func:`grid_blocks` of ``device``). A plan for CUDA passes
    :func:`check_kernel_plan` or raises."""
    device = torch.device(device)
    grid = grid_blocks(device) if grid is None else grid
    key = (tuple(x_shape), groups, heads, dim_head, str(device), grid)
    plans = packs.setdefault("mega_plans", {})
    if key not in plans:
        rec = _Recorder(device, grid)
        x0 = rec.input(x_shape)
        width = sum(packs["film_widths"])
        film_val = rec.input((x_shape[0], width))
        cols = np.cumsum([0, *packs["film_widths"]])[:-1]
        film = iter(_Film(film_val, int(c), width) for c in cols)
        out = unet2d_sequence(rec.ops, x0, film, packs, groups, heads, dim_head)
        plans[key] = rec.finish(out, groups=groups, heads=heads, dim_head=dim_head)
    return plans[key]


def unet2d_mega_plain(x0, film, packs, plan: Plan):
    """The plain versions through :func:`unet2d_sequence` (K8's reference)."""
    ss = iter(torch.split(film, packs["film_widths"], dim=1))
    return unet2d_sequence(PLAIN_OPS, x0, ss, packs, plan.groups, plan.heads, plan.dim_head)


def unet2d_mega(x0, film, packs, plan: Plan):
    """K8. x0: (B, H, W, dim) init-conv output; film: (B, F) every
    ResBlock's FiLM projection (``UNet2D`` order); packs: ``UNet2D.pack()``;
    plan: :func:`mega_plan`. Returns the input of the final 1x1 conv. A CPU
    tensor takes :func:`unet2d_mega_plain`; a CUDA tensor one launch of the
    persistent kernel, or the wrapper raises."""
    if x0.dtype == torch.bfloat16:
        raise NotImplementedError(BF16_ACT_REFUSED.format("unet2d_mega"))
    if not kb._dispatch("unet2d_mega", x0):
        return unet2d_mega_plain(x0, film, packs, plan)
    _forward_only("unet2d_mega", x0, film)
    _check_inputs("unet2d_mega", plan, (x0, film))
    if not (x0.is_contiguous() and film.is_contiguous()):
        raise ValueError("unet2d_mega: x0 and film must be contiguous")
    out = torch.empty(plan.out_shape, device=x0.device, dtype=torch.float32)
    unet2d_mega.grid = _launch(plan, (x0, film), out)  # blocks of the last launch
    unet2d_mega.launches += 1
    unet2d_mega.bf16_launches += int(plan.weight_dtype == torch.bfloat16)
    return out


register_launch_counters(unet2d_mega, "launches", "bf16_launches")


# ---------------------------------------------------------------------------
# K7: two ResnetBlocks in one launch
# ---------------------------------------------------------------------------


_PAIR_PLANS = {}  # K7 plans by (device, shapes, strides, weight addresses)


def _pair_plan(x_shape, ss_strides, groups, p_a, p_b, device) -> Plan:
    rec = _Recorder(device, grid_blocks(device))
    h = rec.input(x_shape)
    ss = [_Film(rec.input((x_shape[0], 2 * x_shape[3])), 0, st) for st in ss_strides]
    for s, p in zip(ss, (p_a, p_b)):
        h = rec.resblock(h, s, p, groups=groups)
    return rec.finish(h, groups=groups)


def resblock_pair_launch(x, ss_a, ss_b, p_a, p_b, groups: int):
    """One K7 launch on CUDA tensors (called by ``unet2d_blocks.resblock_pair``
    after its channel check); returns (out, the plan's weight dtype). bf16
    conv weights select the bf16 instantiation."""
    _forward_only("resblock_pair", x, ss_a, ss_b, *p_a.values(), *p_b.values())
    kb._check_cuda("resblock_pair", x=x)
    strides = (ss_a.stride(0), ss_b.stride(0))
    key = (str(x.device), tuple(x.shape), strides, groups,
           tuple((k, t.data_ptr(), tuple(t.shape), t.dtype)
                 for p in (p_a, p_b) for k, t in sorted(p.items())))
    if key not in _PAIR_PLANS:
        if len(_PAIR_PLANS) >= 32:
            _PAIR_PLANS.clear()
        _PAIR_PLANS[key] = _pair_plan(tuple(x.shape), strides, groups, p_a, p_b, x.device)
    plan = _PAIR_PLANS[key]
    _check_inputs("resblock_pair", plan, (x, ss_a, ss_b))
    out = torch.empty(plan.out_shape, device=x.device, dtype=torch.float32)
    _launch(plan, (x, ss_a, ss_b), out)
    return out, plan.weight_dtype
