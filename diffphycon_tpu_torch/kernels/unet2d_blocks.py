"""Kernel-backed UNet2D blocks and their plain PyTorch versions.

The port of ``diffphycon_tpu/research/pallas_unet2d.py``. Seven Pallas
kernels map onto four hand-written Hopper kernels (the attention blocks, K5
and K6, are in ``kernels/attention.py``):

===============================  ==========================================
Pallas kernel (pallas_unet2d.py)  Port
===============================  ==========================================
``_resblock_kernel`` :160         :func:`resblock`: K1, K3, K1, [K1], K3
``_downsample_kernel`` :259       K2 :func:`downsample_nhwc`
``_upsample_kernel`` :279         K1 :func:`conv2d_nhwc` ``upsample=True``
``_conv_kernel`` :288 (3x3)       K1 :func:`conv2d_nhwc`
``_matmul_bias_kernel`` :294      K1 :func:`conv2d_nhwc` ``k=1`` (x @ w + b)
``_concat_kernel`` :304           K1 reading two sources (``x_b``)
``_resblock_pair_kernel`` :170    K7 :func:`resblock_pair` (one launch)
===============================  ==========================================

K1 = csrc/conv2d_nhwc.cu, K2 = csrc/downsample_nhwc.cu (CUDA C++, sm_90a, on
the 3xTF32 tensor-core core csrc/igemm_tc.cuh; their bf16 variants on the
bf16 core csrc/igemm_bf16.cuh), K3 = csrc/group_norm_act.cu
(one thread-block cluster per GroupNorm row), K7 = csrc/unet2d_persistent.cu
(its stage tables in ``kernels/unet2d_mega.py``).

K1 and K2 on bf16 activations (K1c, K2c) run the persistent,
warp-specialised tile of csrc/igemm_bf16act.cuh (its grid :func:`act_ctas`,
how it moves its operands :func:`bf16act_layout`, its halo A tile
:func:`halo_boxes`, emulated by :func:`halo_im2col`).

K1 and K2 take a tile plan per GEMM shape from the host (:func:`tile_plan`:
tile size and split-K count, keyed on the weight's and the activation's
dtype), K3 its cluster
size (:func:`gn_cluster_plan`; the bf16-activation K3's :func:`gn_bf16_plan`).
:func:`tf32_split` is K1/K2's TF32 rounding in plain PyTorch, and
:func:`group_norm_cluster_emulated` K3's statistics merge, for the tests.

Every public wrapper dispatches on the device of its input: a CPU tensor goes
to the ``*_plain`` version, a CUDA tensor to the kernel (or the wrapper
raises). There is no fallback from one to the other. Each wrapper counts its
kernel launches in the int attribute ``launches`` (plus per-mode counts on
``conv2d_nhwc``), registered with the package's counter registry:
:func:`reset_launch_counts` and :func:`launch_counts` (from
``diffphycon_tpu_torch.kernels``) clear and read every registered counter.

Gradients: on a CUDA tensor each wrapper but the forward-only K7 is a ``torch.autograd.Function``
(:func:`with_plain_vjp`) whose forward launches the kernel and whose backward
is the VJP of the plain version, recomputed from the saved inputs: the
backward is plain PyTorch until backward kernels are written. ``resblock``
is differentiable through the Functions of the K1 and K3 launches it makes.
On a CPU tensor the plain version runs under ordinary autograd.

bf16 weights (the Pallas kernels under ``weight_dtype=bfloat16``): a
bfloat16 weight on a float32 activation selects K1's and K2's bf16 variants
(``conv2d_nhwc_bf16``, ``downsample_nhwc_bf16``: bf16 ``wgmma`` with the
float32 activation rounded to bfloat16 at the matmul and float32 sums, on
their own tile plan, ``tile_plan(..., bf16=True)``), and their plain
versions round the same operands (:func:`bf16_operands`). Activations,
biases and norms stay float32, so K3 has no variant of this mode.
``bf16_launches`` counts these launches among ``launches``.

bf16 activations (flax ``dtype=bfloat16``, the JAX ``UNet2D(dtype=
jnp.bfloat16)``): a bfloat16 activation (with bfloat16 weights,
:func:`act_is_bf16`) selects the bf16-activation variants of K1, K2 and K3
(``conv2d_nhwc_bf16act``, ``downsample_nhwc_bf16act``,
``group_norm_act_bf16act``), and the plain versions follow flax's rules,
each rounding where XLA rounds on the CPU (``tests/
test_torch_port_bf16_flax_unet2d.py`` holds them against flax): a conv sums
bf16 x bf16 products in float32, rounds once to bfloat16, adds the bias
rounded to bfloat16 and rounds again; GroupNorm takes float32 statistics
and a float32 affine and rounds once; FiLM ``x * (scale + 1) + shift``,
SiLU (``x * (1 / (1 + exp(-x)))``, the logistic as XLA expands it) and the
residual add round to bfloat16 after every op. Everything stored between
kernels is bfloat16. ``bf16act_launches`` counts these launches.

Layouts: activations NHWC fp32 (or bf16, above), contiguous. Conv weights are packed once
(see ``nets/unet2d.py``): a KxK conv as ``(K*K*Ci, Co)`` with row index
``(dy*K + dx)*Ci + c``; the downsample as ``(4*C, Co)`` with row index
``(p1*2 + p2)*C + c``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from diffphycon_tpu_torch.kernels import (  # noqa: F401 (counters re-exported)
    _build,
    launch_counts,
    register_launch_counters,
    reset_launch_counts,
)

GN_EPS = 1e-5
_INT32_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# checks shared by the CUDA paths
# ---------------------------------------------------------------------------


def _check_cuda(name: str, bf16=(), **tensors) -> None:
    """Each tensor on one CUDA device, float32 (bfloat16 also for the keys
    named in ``bf16``: the weights of the bf16 variants), contiguous."""
    # is_cuda and get_device(): reading t.device.type costs several times more
    # host time, on every launch
    dev = None
    for key, t in tensors.items():
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} is on {t.device}, expected cuda")
        if dev is None:
            dev = t.get_device()
        elif t.get_device() != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, others on cuda:{dev}")
        if t.dtype != torch.float32 and not (t.dtype == torch.bfloat16 and key in bf16):
            kinds = "float32 or bfloat16" if key in bf16 else "float32"
            raise TypeError(f"{name}: {key} has dtype {t.dtype}; the kernel takes {kinds}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.numel() > _INT32_MAX:
            raise ValueError(f"{name}: {key} has more than 2^31-1 elements")


def _check_bf16_channels(name: str, channels) -> None:
    """The bf16-activation kernels move 8 channels per 16-byte load."""
    if any(c % 8 for c in channels):
        raise ValueError(f"{name}: channel counts {list(channels)} must be multiples of 8 "
                         "for the bf16-activation kernel")


def _check_vec4(name: str, channels, tensors) -> None:
    """The CUDA convs move 4 channels per 16-byte load."""
    if any(c % 4 for c in channels):
        raise ValueError(f"{name}: channel counts {list(channels)} must be multiples "
                         "of 4 for the kernel")
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must start 16-byte aligned")


def weight_is_bf16(name: str, *ws) -> bool:
    """Whether the weights ``ws`` select the bf16 variant of a kernel (all
    bfloat16) or the 3xTF32 one (all float32). The bf16 variants move 8
    weights per 16-byte load, so each weight row holds a multiple of 8."""
    bf16 = ws[0].dtype == torch.bfloat16
    if any((w.dtype == torch.bfloat16) != bf16 for w in ws[1:]):
        raise TypeError(f"{name}: weights of mixed dtypes {[str(w.dtype) for w in ws]}")
    if not bf16:
        return False
    if any(w.shape[-1] % 8 for w in ws):
        raise ValueError(f"{name}: bfloat16 weights need rows of a multiple of 8, got "
                         f"{[tuple(w.shape) for w in ws]}")
    return True


def bf16_operands(x, w):
    """(x, w) as a matmul of the kernels takes them: a bfloat16 weight
    rounds the float32 activation to bfloat16 (to nearest even, as
    ``cvt.rn.bf16x2.f32``) and both go back to float32, where their product
    is exact and sums in float32 (the Pallas ``_matmul`` with
    ``weight_dtype=bfloat16``: ``x.astype(w.dtype)``, f32 accumulation); a
    float32 weight leaves both as they are."""
    if w.dtype == torch.bfloat16:
        return x.to(torch.bfloat16).float(), w.float()
    return x, w


def act_is_bf16(name: str, x, *ws) -> bool:
    """Whether activation ``x`` selects the bf16-activation variant of a
    kernel (flax ``dtype=bfloat16``): a bfloat16 activation, which takes
    bfloat16 weights only (:func:`weight_is_bf16`)."""
    if x.dtype != torch.bfloat16:
        return False
    if not weight_is_bf16(name, *ws):
        raise TypeError(f"{name}: bfloat16 activations take bfloat16 weights, got "
                        f"{[str(w.dtype) for w in ws]}")
    return True


def bf16_const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant as JAX's weak type gives it to a bfloat16 op: the
    constant rounded to bfloat16 (torch would keep a Python scalar in
    float32 inside the op)."""
    return torch.tensor(value, dtype=torch.bfloat16, device=like.device)


def silu_bf16(x):
    """flax ``nn.silu`` on bfloat16 as XLA computes it on the CPU:
    ``x * logistic(x)`` with the logistic expanded to ``1 / (1 + exp(-x))``,
    every op rounded to bfloat16."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def conv_bias_bf16(acc, b):
    """The end of a flax bf16 conv or Dense: the float32 sum rounded to
    bfloat16, plus the bias rounded to bfloat16, rounded again."""
    return acc.to(torch.bfloat16) + b.to(torch.bfloat16)


def matmul_w(x, w):
    """x @ w under :func:`bf16_operands`."""
    x, w = bf16_operands(x, w)
    return x @ w


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream on t's device (the same stream
    as ``torch.cuda.current_stream(t.device)``, without building its Python
    object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _dispatch(name: str, x: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the plain CPU version."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain path for device {x.device}")


class _PlainVJP(torch.autograd.Function):
    """Forward: ``launch(*inputs)`` (a kernel). Backward: the VJP of
    ``plain(*inputs)``, recomputed under autograd from the saved inputs."""

    @staticmethod
    def forward(ctx, launch, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return launch(*inputs)

    @staticmethod
    def backward(ctx, grad_out):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            out = ctx.plain(*inputs)
            wrt = [t for t, need in zip(inputs, needs) if need]
            grads = iter(torch.autograd.grad(out, wrt, grad_out))
        return (None, None, *(next(grads) if need else None for need in needs))


def with_plain_vjp(launch, plain, *inputs, **kw):
    """``launch(*inputs, **kw)``, differentiable through the plain version
    when grad is enabled and an input requires it (else the bare launch)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        if kw:
            launch, plain = functools.partial(launch, **kw), functools.partial(plain, **kw)
        return _PlainVJP.apply(launch, plain, *inputs)
    return launch(*inputs, **kw)


# ---------------------------------------------------------------------------
# K1 and K2's tensor-core cores (csrc/igemm_tc.cuh, csrc/igemm_bf16.cuh): tile plan,
# TF32 split
# ---------------------------------------------------------------------------

SM_COUNT = 132              # SMs of an H100 SXM: one wave of one CTA each
TC_BK = 32                  # K per ring stage (igemm_tc.cuh: BK)
TC_BK_BF16 = 64             # K per ring stage of the bf16 core (igemm_bf16.cuh: BK)
MIN_SLICES_PER_SPLIT = 4    # ring stages of K each split walks at least
# (BM, BN) -> (us per ring slice, us per CTA besides its slices, CTAs per
# SM), and us per million split-K partial floats: the `fit` line of
# `python3 -m diffphycon_tpu_torch.tools.sweep_igemm_tc`, which times every
# plan at the batch-50 shapes (on an NVIDIA H100 80GB HBM3 at 700 W)
TC_TILES = {(128, 128): (2.27, 1.94, 1), (128, 64): (1.57, 1.43, 1),
            (64, 64): (1.59, 1.79, 2)}
SPLIT_US_PER_MFLOAT = 1.82
# the same for the bf16 core (64-deep stages, device times): the mean of
# two `fit` lines of `sweep_igemm_tc --bf16` (NVIDIA H100 80GB HBM3, 700 W)
TC_TILES_BF16 = {(128, 256): (0.75, 8.87, 1), (128, 128): (0.64, 5.18, 1),
                 (128, 64): (0.59, 3.27, 1), (64, 64): (0.64, 3.03, 2)}
SPLIT_US_PER_MFLOAT_BF16 = 0.84


# the same for K1c and K2c on bf16 activations (csrc/igemm_bf16act.cuh: the
# persistent tile, BM = 128): (BM, BN) -> (us per stage, us per tile, 1), us
# per million split-K floats; the `fit` line of `sweep_igemm_tc --bf16act
# --plans` (device times; NVIDIA H100 80GB HBM3, 700 W)
TC_TILES_BF16ACT = {(128, 256): (0.580, 4.175, 1), (128, 128): (0.380, 1.437, 1),
                    (128, 64): (0.283, 0.612, 1)}
SPLIT_US_PER_MFLOAT_BF16ACT = 1.501
# a launch of the persistent tile may let a halo A tile serve its 3x3 convs
# (the tests turn it off to compare the halo views with per-tap boxes)
BF16ACT_HALO = True


class TilePlan(NamedTuple):
    bm: int
    bn: int
    splits: int  # split-K count (blockIdx.z)
    per: int     # ring stages of K per split; the last split may take fewer

    def ctas(self, m: int, n: int) -> int:
        return math.ceil(m / self.bm) * math.ceil(n / self.bn) * self.splits

    def workspace_floats(self, m: int, n: int) -> int:
        """Floats of the split-K partials (none without a split)."""
        return self.splits * m * n if self.splits > 1 else 0


def plan_candidates(n: int, k: int, tiles=None, bk: int = TC_BK):
    """Every plan :func:`tile_plan` weighs for a GEMM of n columns and depth
    k in stages of `bk`, each once: every tile of `tiles` (TC_TILES by
    default; BN columns only when n > BN / 2) with every split count that
    keeps MIN_SLICES_PER_SPLIT stages of K per split."""
    slices = math.ceil(k / bk)
    for bm, bn in TC_TILES if tiles is None else tiles:
        if bn > 64 and n <= bn // 2:
            continue
        seen = set()
        for want in range(1, max(1, slices // MIN_SLICES_PER_SPLIT) + 1):
            per = math.ceil(slices / want)
            if per not in seen:
                seen.add(per)
                yield TilePlan(bm, bn, math.ceil(slices / per), per)


def plan_waves(plan: TilePlan, m: int, n: int, tiles=None, sms: int = SM_COUNT) -> int:
    """Waves of `sms` SMs, each holding the tile's CTAs per SM (from
    `tiles`, TC_TILES by default)."""
    per_sm = (TC_TILES if tiles is None else tiles)[plan.bm, plan.bn][2]
    return math.ceil(plan.ctas(m, n) / (sms * per_sm))


def pick_plan(m: int, n: int, k: int, tiles=None, split_us: float | None = None,
              sms: int = SM_COUNT, bk: int = TC_BK, fill_first: bool = True) -> TilePlan:
    """The plan of :func:`tile_plan` under the costs `tiles` (as TC_TILES)
    and `split_us` (as SPLIT_US_PER_MFLOAT), the module's by default, for
    a card of `sms` SMs (the persistent kernel passes its grid and its
    128-row tiles, one CTA per SM) and stages of `bk`; ``fill_first``:
    plans of at least `sms` CTAs before the others, else the modelled time
    alone."""
    tiles = TC_TILES if tiles is None else tiles
    split_us = SPLIT_US_PER_MFLOAT if split_us is None else split_us
    best = None
    for plan in plan_candidates(n, k, tiles, bk):
        slice_us, cta_us, _ = tiles[plan.bm, plan.bn]
        us = plan_waves(plan, m, n, tiles, sms) * (plan.per * slice_us + cta_us)
        us += split_us * plan.workspace_floats(m, n) / 1e6
        key = (fill_first and plan.ctas(m, n) < sms, us)  # a full wave first, then the time
        if best is None or key < best[0]:
            best = (key, plan)
    return best[1]


def act_ctas(plan: TilePlan, m: int, n: int, sms: int = SM_COUNT) -> int:
    """CTAs of one launch of the persistent tile (csrc/igemm_bf16act.cuh):
    its column groups (N tiles x splits) times the CTAs each gets, at most
    one CTA an SM and never more than the group's row tiles."""
    groups = math.ceil(n / plan.bn) * plan.splits
    return groups * max(1, min(math.ceil(m / plan.bm), sms // groups))


def act_rounds(plan: TilePlan, m: int, n: int, sms: int = SM_COUNT) -> int:
    """Tiles the busiest CTA of :func:`act_ctas`'s grid walks one after the
    other, times the grid's waves of `sms` CTAs."""
    ctas = act_ctas(plan, m, n, sms)
    per_group = ctas // (math.ceil(n / plan.bn) * plan.splits)
    return math.ceil(ctas / sms) * math.ceil(math.ceil(m / plan.bm) / per_group)


def pick_act_plan(m: int, n: int, k: int, tiles=None, split_us: float | None = None,
                  sms: int = SM_COUNT) -> TilePlan:
    """The plan of ``tile_plan(..., act=True)`` under the costs `tiles` (as
    TC_TILES_BF16ACT) and `split_us`: the least modelled time of the
    persistent walk, rounds * (stages per split * us per stage + us per
    tile) plus the split-K pass."""
    tiles = TC_TILES_BF16ACT if tiles is None else tiles
    split_us = SPLIT_US_PER_MFLOAT_BF16ACT if split_us is None else split_us
    best = None
    for plan in plan_candidates(n, k, tiles, TC_BK_BF16):
        stage_us, tile_us, _ = tiles[plan.bm, plan.bn]
        us = act_rounds(plan, m, n, sms) * (plan.per * stage_us + tile_us)
        us += split_us * plan.workspace_floats(m, n) / 1e6
        if best is None or us < best[0]:
            best = (us, plan)
    return best[1]


@functools.lru_cache(maxsize=None)
def tile_plan(m: int, n: int, k: int, bf16: bool = False, act: bool = False) -> TilePlan:
    """Tile and split-K of one (m, n, k) GEMM of K1 or K2, among
    :func:`plan_candidates`, by the modelled time: waves * (stages per
    split * us per stage + us per CTA) plus the split-K pass. 3xTF32: the
    plans that fill one wave of SM_COUNT CTAs come first. ``bf16`` (the
    bf16 variants): the bf16 core's costs and 64-deep stages, and the
    modelled time alone (over the batch-50 forward its picks took 1.983 ms
    of device time against 1.978 for the fastest plan of each GEMM, and
    2.153 with the full wave first: ``sweep_igemm_tc --bf16``). ``act``
    (with ``bf16``; K1c and K2c on bf16 activations): the persistent tile's
    plan, :func:`pick_act_plan` over TC_TILES_BF16ACT."""
    if act:
        return pick_act_plan(m, n, k)
    if bf16:
        return pick_plan(m, n, k, TC_TILES_BF16, SPLIT_US_PER_MFLOAT_BF16, bk=TC_BK_BF16,
                         fill_first=False)
    return pick_plan(m, n, k)


def tma_boxes(bm: int, gh: int, gw: int, ca: int, cb: int, scale: int = 1):
    """(bw, bh, bb) where the bf16 core (``csrc/igemm_bf16.cuh``) reads the A
    tile of a bm-row tile as TMA boxes of 32 channels x bw columns x bh rows
    x bb images of a grid of gh x gw pixels (the output's, or through the
    upsample the source's; K2's at traversal stride ``scale`` 2), else None
    (the cp.async gather). The rule of ``igemm_bf16::launch`` (the `boxes`
    condition, igemm_bf16.cuh:610-623): bm grid pixels that are part of one
    row, whole rows of one image, or whole images; every 64-channel block
    from one source (ca and cb multiples of TC_BK_BF16); at most 256
    pixels a box side. (Through the upsample the launch also wants the output
    exactly twice the source, which every caller's shapes are.)"""
    if gw % bm == 0:
        bw, bh, bb = bm, 1, 1
    elif bm % gw == 0 and gh % (bm // gw) == 0:
        bw, bh, bb = gw, bm // gw, 1
    elif bm % (gh * gw) == 0:
        bw, bh, bb = gw, gh, bm // (gh * gw)
    else:
        return None
    if ca % TC_BK_BF16 or cb % TC_BK_BF16 or bw * scale > 256 or bh * scale > 256:
        return None
    return bw, bh, bb


def halo_boxes(gh: int, gw: int, ca: int, cb: int, k: int = 3, up: bool = False):
    """(bw, bh) of the halo A tile the persistent tile (csrc/igemm_bf16act.cuh:
    make_layout) may take for a conv over a grid of gh x gw pixels, else
    None: a 3x3 conv, not upsampled, whose 128-row tile is TMA boxes
    (:func:`tma_boxes`) of whole rows or part of one (one image, bw a
    multiple of 64, so that each warpgroup's 64 rows are one run of pixels),
    at most 4 64-channel blocks. Whether the halos fit in shared memory
    is :func:`bf16act_layout`'s."""
    boxes = tma_boxes(128, gh, gw, ca, cb)
    if k != 3 or up or boxes is None:
        return None
    bw, bh, bb = boxes
    if bb != 1 or bw % 64 or bw + 2 > 256 or bh + 2 > 256 or (ca + cb) // TC_BK_BF16 > 4:
        return None
    return bw, bh


# the persistent tile's shared memory (csrc/igemm_bf16act.cuh): what a layout
# may use (less the alignment slack, the mbarriers and the bias), the A part
# of a ring slot, and its limits
_ACT_AVAIL = 232448 - 1024 - 8 * (2 * 8 + 2 * 8 + 32 + 2) - 256 * 2
_ACT_A_STAGE = 128 * 128
_ACT_RING_MAX, _ACT_HALO_MAX, _ACT_HELD_MAX = 8, 8, 32


def bf16act_layout(kind: str, args: tuple, plan: TilePlan, halo: bool = True) -> dict:
    """How one K1c / K2c launch (``conv2d_nhwc`` / ``downsample_nhwc``
    arguments as ``chip_smoke.main_path_calls`` gives them) moves its
    operands: ``make_layout`` and the ping-pong rule of ``launch`` in
    csrc/igemm_bf16act.cuh. ``mode``: "halo" (one (bh + 2) x (bw + 2) box a
    64-channel block a tile, the nine taps views into it; ``hsets`` tiles'
    halos in shared memory), "boxes" (a TMA box a tap and 64 channels) or
    "gather" (cp.async chunks); ``hold``: the split's weight slice held for
    every tile (else streamed); ``ring``: ring slots; ``pingpong``: the two
    consumer warpgroups take turns at whole tiles (else both work on every
    tile)."""
    if kind == "downsample_nhwc":
        b_, h, w, ca, _ = args
        cb, k, up, gh, gw, scale = 0, 2, False, h // 2, w // 2, 2
    else:
        b_, h, w, ca, cb, _, k, up = args
        gh, gw, scale = h, w, 1
    m, n, _ = _act_gemm(kind, args)
    boxes = tma_boxes(128, gh, gw, ca, cb, scale)
    w_stage = plan.bn * 128
    held = plan.per * w_stage
    can_hold = plan.per <= _ACT_HELD_MAX
    lay = None
    hb = halo_boxes(gh, gw, ca, cb, k, up) if halo and scale == 1 else None
    if hb is not None:
        bw, bh = hb
        cblocks = (ca + cb) // TC_BK_BF16
        box = math.ceil((bw + 2) * (bh + 2) * 128 / 1024) * 1024
        # held with halos only at bn <= 128 (two accumulator sets), where a
        # tile's halo (one channel block) holds its staged epilogue
        for hsets in (3, 2):
            if (can_hold and plan.bn <= 128 and cblocks == 1 and 128 * plan.bn * 2 <= box
                    and hsets * cblocks <= _ACT_HALO_MAX
                    and hsets * cblocks * box + held <= _ACT_AVAIL):
                lay = {"mode": "halo", "hold": True, "ring": 0, "hsets": hsets, "box": [bw, bh]}
                break
        # where the weights cannot stay beside the halos but can beside
        # per-tap boxes, the boxes and held weights
        if (lay is None and not (can_hold and held + 4 * _ACT_A_STAGE <= _ACT_AVAIL)
                and 2 * cblocks * box + 3 * w_stage <= _ACT_AVAIL):
            ring = (_ACT_AVAIL - 2 * cblocks * box) // w_stage
            lay = {"mode": "halo", "hold": False, "ring": min(_ACT_RING_MAX, ring), "hsets": 2,
                   "box": [bw, bh]}
    if lay is None:
        mode = "gather" if boxes is None else "boxes"
        if can_hold and held + 4 * _ACT_A_STAGE <= _ACT_AVAIL:
            ring = (_ACT_AVAIL - held) // _ACT_A_STAGE
            lay = {"mode": mode, "hold": True, "ring": min(_ACT_RING_MAX, ring)}
        else:
            ring = _ACT_AVAIL // (_ACT_A_STAGE + w_stage)
            lay = {"mode": mode, "hold": False, "ring": min(_ACT_RING_MAX, ring)}
    tiles_m = (4 * math.ceil(b_ * gh * gw / 128) if lay["mode"] == "boxes" and up
               else math.ceil(m / 128))
    step = act_ctas(plan, m, n) // (math.ceil(n / plan.bn) * plan.splits)
    lay["pingpong"] = plan.bn <= 128 and ((lay["mode"] == "halo" and lay["hold"])
                                          or math.ceil(tiles_m / step) >= 2)
    return lay


def _act_gemm(kind: str, args: tuple):
    """(m, n, k) of one K1 / K2 signature (``chip_smoke.gemm_dims``)."""
    if kind == "conv2d_nhwc":
        b_, h, w, ca, cb, co, k, up = args
        return b_ * h * w * (4 if up else 1), co, k * k * (ca + cb)
    b_, h, w, c, co = args
    return b_ * (h // 2) * (w // 2), co, 4 * c


def bf16act_path(kind: str, args: tuple, plan: TilePlan) -> str:
    """The path one K1c / K2c launch takes, as a word: "halo", "boxes" or
    "gather", with "+held" where its weights are held per CTA and
    "+pingpong" where the consumer warpgroups take turns at tiles."""
    lay = bf16act_layout(kind, args, plan)
    return lay["mode"] + ("+held" if lay["hold"] else "") + ("+pingpong" if lay["pingpong"] else "")


def halo_view_start(wg: int, dy: int, dx: int, bw: int) -> int:
    """The first pixel of warpgroup `wg`'s 64 A rows of tap (dy, dx) inside
    a halo box of (bh + 2) x (bw + 2) pixels (igemm_bf16act.cuh's consumer)."""
    return (wg * 64 // bw + dy) * (bw + 2) + wg * 64 % bw + dx


def halo_im2col(x_a, x_b, bw: int, bh: int):
    """The (M, 9 Ci) A matrix of a same-padded 3x3 conv of x_a [| x_b]
    (B, H, W, C), as the persistent tile reads it through halo boxes: per
    128-row tile (bh rows of bw pixels of one image) and 64-channel block,
    one box of (bh + 2) x (bw + 2) pixels from (y0 - 1, x0 - 1), zeros
    outside the image, flattened to pixels; tap t = 3 dy + dx of warpgroup
    wg is the 64 pixels from :func:`halo_view_start`. Columns in the
    kernels' k order, (dy * 3 + dx) * Ci + c."""
    x = x_a if x_b is None else torch.cat([x_a, x_b], dim=-1)
    B, H, W, ci = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    rows = []
    for b in range(B):
        for y0 in range(0, H, bh):
            for x0 in range(0, W, bw):
                box = xp[b, y0:y0 + bh + 2, x0:x0 + bw + 2, :].reshape(-1, ci)
                taps = []
                for t in range(9):
                    dy, dx = divmod(t, 3)
                    taps.append(torch.cat([box[halo_view_start(wg, dy, dx, bw):][:64]
                                           for wg in range(2)]))
                rows.append(torch.cat(taps, dim=1))
    return torch.cat(rows)


def tf32_split(x: torch.Tensor):
    """(hi, lo) of a float32 tensor as the kernels split it: hi = x rounded
    to TF32 (10 explicit mantissa bits) to nearest with ties away from zero
    (``cvt.rna.tf32.f32``), lo = the same rounding of x - hi (exact in fp32).
    Plain integer ops, for the tests and ``chip_smoke.py``; the kernels split
    on the card."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


# int tuple -> (address, C int array): K1-K3 and K5 take their shape and
# plan as one `const int*`, since a ctypes call converts every argument in
# Python, on the host's time before the launch
_INT_ARRAYS: dict = {}


def int_array(ints: tuple) -> int:
    """Address of a C int array holding ``ints``, built once per tuple."""
    found = _INT_ARRAYS.get(ints)
    if found is None:
        arr = (ctypes.c_int * len(ints))(*ints)
        found = _INT_ARRAYS[ints] = (ctypes.addressof(arr), arr)
    return found[0]


def _plan_args(x, gemm, shape_ints, bf16, act=False):
    """(split-K workspace or None, address of the kernel's int arguments:
    its shape ints, then the plan) of one K1 or K2 launch of GEMM (m, n, k)
    on input x (``bf16``: the bf16 variants' plan; ``act``: the
    bf16-activation variants', then the persistent grid and whether a halo
    may serve)."""
    plan = tile_plan(*gemm, bf16, True) if act else tile_plan(*gemm, bf16)
    ws = None
    if plan.splits > 1:  # float32 partials, whatever the activation's dtype
        ws = x.new_empty(plan.workspace_floats(gemm[0], gemm[1]), dtype=torch.float32)
    if act:
        return ws, int_array(shape_ints + tuple(plan) + (act_ctas(plan, gemm[0], gemm[1]),
                                                         int(BF16ACT_HALO)))
    return ws, int_array(shape_ints + plan)


# ---------------------------------------------------------------------------
# K1: KxK conv, optional second source (skip concat) and nearest-2x upsample
# ---------------------------------------------------------------------------


def _conv_input(x_a, x_b, upsample):
    x = x_a if x_b is None else torch.cat([x_a, x_b], dim=-1)
    if upsample:  # nearest 2x == repeat by 2 (nets/blocks.py:238)
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return x


def conv2d_nhwc_plain(x_a, w, b, x_b=None, k: int = 3, upsample: bool = False):
    """Same-padded k x k conv as k*k shifted matmuls, the arithmetic of the
    Pallas ``_conv2d`` (pallas_unet2d.py:61-95); a bfloat16 weight takes
    the input rounded to bfloat16 (:func:`bf16_operands`). A bfloat16 input
    (bf16 activations) gives flax's bf16 conv (:func:`conv_bias_bf16`)."""
    if act_is_bf16("conv2d_nhwc", x_a, w):
        x = _conv_input(x_a, x_b, upsample).float()
        return conv_bias_bf16(_conv_sum(x, w.float(), k), b)
    x, w = bf16_operands(_conv_input(x_a, x_b, upsample), w)
    return _conv_sum(x, w, k) + b


def _conv_sum(x, w, k):
    """The bias-free sum of the same-padded k x k conv of x (B, H, W, Ci)."""
    B, H, W, ci = x.shape
    p = (k - 1) // 2
    xp = F.pad(x, (0, 0, p, k - 1 - p, p, k - 1 - p))
    w3 = w.reshape(k * k, ci, -1)
    acc = None
    for tap in range(k * k):
        dy, dx = divmod(tap, k)
        xs = xp[:, dy:dy + H, dx:dx + W, :].reshape(B * H * W, ci)
        term = xs @ w3[tap]
        acc = term if acc is None else acc + term
    return acc.reshape(B, H, W, -1)


def conv2d_nhwc(x_a, w, b, x_b=None, k: int = 3, upsample: bool = False):
    """K1. x_a: (B, H, W, Ca) [, x_b: (B, H, W, Cb)]; w: (k*k*(Ca+Cb), Co),
    float32 (3xTF32) or bfloat16 (the bf16 variant); b: (Co,). With
    ``upsample`` the output is (B, 2H, 2W, Co). bfloat16 x_a and x_b (with a
    bfloat16 w) select the bf16-activation variant and give bfloat16."""
    if not _dispatch("conv2d_nhwc", x_a):
        return conv2d_nhwc_plain(x_a, w, b, x_b=x_b, k=k, upsample=upsample)
    return with_plain_vjp(_conv2d_launch, conv2d_nhwc_plain, x_a, w, b, x_b, k=k,
                          upsample=upsample)


@functools.lru_cache(maxsize=None)
def _conv2d_shapes(xa_shape, xb_shape, w_shape, b_shape, k, upsample):
    """The checks of one K1 call that depend on shapes alone, once per
    shape: (output shape, GEMM (m, n, k), the kernel's shape ints)."""
    if k not in (1, 3):
        raise ValueError(f"conv2d_nhwc: k={k}; the kernel takes 1 or 3")
    if len(xa_shape) != 4:
        raise ValueError(f"conv2d_nhwc: x_a must be NHWC, got {tuple(xa_shape)}")
    B, Hs, Ws, ca = xa_shape
    cb = 0
    if xb_shape is not None:
        if len(xb_shape) != 4 or xb_shape[:3] != xa_shape[:3]:
            raise ValueError(f"conv2d_nhwc: x_b {tuple(xb_shape)} does not "
                             f"match x_a {tuple(xa_shape)}")
        cb = xb_shape[3]
    co = w_shape[-1]
    if len(w_shape) != 2 or w_shape[0] != k * k * (ca + cb) or b_shape != (co,):
        raise ValueError(f"conv2d_nhwc: weight {tuple(w_shape)} / bias "
                         f"{tuple(b_shape)} do not fit k={k}, Ci={ca + cb}")
    _check_vec4("conv2d_nhwc", (ca, cb, co), ())
    H, W = (2 * Hs, 2 * Ws) if upsample else (Hs, Ws)
    if B * H * W * co > _INT32_MAX:
        raise ValueError("conv2d_nhwc: output too large for int32 indexing")
    return ((B, H, W, co), (B * H * W, co, k * k * (ca + cb)),
            (B, H, W, ca, cb, co, k, int(upsample)))


def _conv2d_launch(x_a, w, b, x_b, k, upsample):
    act = act_is_bf16("conv2d_nhwc", x_a, w)
    _check_cuda("conv2d_nhwc", bf16=("w", "x_a", "x_b") if act else ("w",), x_a=x_a, x_b=x_b,
                w=w, b=b)
    if act and x_b is not None and x_b.dtype != torch.bfloat16:
        raise TypeError("conv2d_nhwc: x_a is bfloat16, x_b is not")
    out_shape, gemm, ints = _conv2d_shapes(x_a.shape, None if x_b is None else x_b.shape,
                                           w.shape, b.shape, k, bool(upsample))
    _check_vec4("conv2d_nhwc", (), (x_a, x_b, w, b))
    if act:
        _check_bf16_channels("conv2d_nhwc", ints[3:5])
    bf16 = weight_is_bf16("conv2d_nhwc", w)
    out = x_a.new_empty(out_shape)
    ws, args = _plan_args(x_a, gemm, ints, bf16, act)
    lib = _build.load_library()
    fn = lib.conv2d_nhwc_bf16act if act else lib.conv2d_nhwc_bf16 if bf16 else lib.conv2d_nhwc_f32
    err = fn(
        x_a.data_ptr(), x_b.data_ptr() if x_b is not None else None,
        w.data_ptr(), b.data_ptr(), out.data_ptr(), ws.data_ptr() if ws is not None else None,
        args, _stream(x_a))
    _build.check(err, "conv2d_nhwc")
    conv2d_nhwc.launches += 1
    conv2d_nhwc.dual_launches += int(x_b is not None)
    conv2d_nhwc.upsample_launches += int(bool(upsample))
    conv2d_nhwc.bf16_launches += int(bf16 and not act)
    conv2d_nhwc.bf16act_launches += int(act)
    return out


register_launch_counters(conv2d_nhwc, "launches", "dual_launches", "upsample_launches",
                         "bf16_launches", "bf16act_launches")


# ---------------------------------------------------------------------------
# K2: 2x2 stride-2 conv (space-to-depth + 1x1)
# ---------------------------------------------------------------------------


def downsample_nhwc_plain(x, w, b):
    """Space-to-depth in (p1 p2 c) order + one matmul
    (``_downsample_kernel``, pallas_unet2d.py:259-276); a bfloat16 input
    (bf16 activations) gives flax's bf16 conv (:func:`conv_bias_bf16`)."""
    act = act_is_bf16("downsample_nhwc", x, w)
    x, w = (x.float(), w.float()) if act else bf16_operands(x, w)
    B, H, W, C = x.shape
    x6 = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    acc = (x6.reshape(B * (H // 2) * (W // 2), 4 * C) @ w).reshape(B, H // 2, W // 2, -1)
    return conv_bias_bf16(acc, b) if act else acc + b


def downsample_nhwc(x, w, b):
    """K2. x: (B, H, W, C) with even H, W; w: (4*C, Co), float32 or
    bfloat16 (the bf16 variant); b: (Co,). A bfloat16 x (with a bfloat16
    w) selects the bf16-activation variant and gives bfloat16."""
    if not _dispatch("downsample_nhwc", x):
        return downsample_nhwc_plain(x, w, b)
    return with_plain_vjp(_downsample_launch, downsample_nhwc_plain, x, w, b)


@functools.lru_cache(maxsize=None)
def _downsample_shapes(x_shape, w_shape, b_shape):
    """The shape checks of one K2 call, once per shape: (output shape, GEMM
    (m, n, k), the kernel's shape ints)."""
    if len(x_shape) != 4 or x_shape[1] % 2 or x_shape[2] % 2:
        raise ValueError(f"downsample_nhwc: x must be NHWC with even H, W, "
                         f"got {tuple(x_shape)}")
    B, H, W, C = x_shape
    co = w_shape[-1]
    if len(w_shape) != 2 or w_shape[0] != 4 * C or b_shape != (co,):
        raise ValueError(f"downsample_nhwc: weight {tuple(w_shape)} / bias "
                         f"{tuple(b_shape)} do not fit C={C}")
    _check_vec4("downsample_nhwc", (C, co), ())
    m = B * (H // 2) * (W // 2)
    return (B, H // 2, W // 2, co), (m, co, 4 * C), (B, H, W, C, co)


def _downsample_launch(x, w, b):
    act = act_is_bf16("downsample_nhwc", x, w)
    _check_cuda("downsample_nhwc", bf16=("w", "x") if act else ("w",), x=x, w=w, b=b)
    out_shape, gemm, ints = _downsample_shapes(x.shape, w.shape, b.shape)
    _check_vec4("downsample_nhwc", (), (x, w, b))
    if act:
        _check_bf16_channels("downsample_nhwc", ints[3:4])
    bf16 = weight_is_bf16("downsample_nhwc", w)
    out = x.new_empty(out_shape)
    ws, args = _plan_args(x, gemm, ints, bf16, act)
    lib = _build.load_library()
    fn = (lib.downsample_nhwc_bf16act if act else lib.downsample_nhwc_bf16 if bf16
          else lib.downsample_nhwc_f32)
    err = fn(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, args, _stream(x))
    _build.check(err, "downsample_nhwc")
    downsample_nhwc.launches += 1
    downsample_nhwc.bf16_launches += int(bf16 and not act)
    downsample_nhwc.bf16act_launches += int(act)
    return out


register_launch_counters(downsample_nhwc, "launches", "bf16_launches", "bf16act_launches")


# ---------------------------------------------------------------------------
# K3: GroupNorm (+ FiLM) + SiLU (+ residual)
# ---------------------------------------------------------------------------


def group_norm_act_plain(x, gamma, beta, groups: int = 1, ss=None, res=None,
                         eps: float = GN_EPS):
    """SiLU(GN(x) [* (scale+1) + shift]) [+ res]; GN per (sample, group) over
    (H, W, C/groups) with biased variance (flax GroupNorm). ss: (B, 2C) FiLM
    scale | shift. A bfloat16 x (bf16 activations; ss and res bfloat16
    too) takes :func:`group_norm_act_bf16_plain`."""
    if x.dtype == torch.bfloat16:
        return group_norm_act_bf16_plain(x, gamma, beta, groups, ss=ss, res=res, eps=eps)
    B, H, W, C = x.shape
    g = x.reshape(B, H * W, groups, C // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = ((g - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((g - mean) * torch.rsqrt(var + eps)).reshape(B, H, W, C) * gamma + beta
    if ss is not None:
        y = y * (ss[:, None, None, :C] + 1.0) + ss[:, None, None, C:]
    y = y * torch.sigmoid(y)
    if res is not None:
        y = y + res
    return y


def group_norm_act_bf16_plain(x, gamma, beta, groups: int = 1, ss=None, res=None,
                              eps: float = GN_EPS):
    """The bf16-activation K3 as flax computes it: GroupNorm of bfloat16 x
    with float32 statistics and the float32 affine ``(x - mean) * (rstd *
    gamma) + beta`` (flax ``_normalize``), rounded once to bfloat16; then
    FiLM ``y * (scale + 1) + shift`` on the bfloat16 ss, :func:`silu_bf16`
    and ``+ res`` (bfloat16), each op rounded to bfloat16."""
    B, H, W, C = x.shape
    g = x.float().reshape(B, H * W, groups, C // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = ((g - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    mul = (torch.rsqrt(var + eps) * gamma.reshape(groups, C // groups)).reshape(B, 1, C)
    y = (((g - mean).reshape(B, H * W, C) * mul).reshape(B, H, W, C) + beta)
    y = y.to(torch.bfloat16)
    if ss is not None:
        y = y * (ss[:, None, None, :C] + 1.0) + ss[:, None, None, C:]
    y = silu_bf16(y)
    if res is not None:
        y = y + res
    return y


def group_norm_act(x, gamma, beta, groups: int = 1, ss=None, res=None,
                   eps: float = GN_EPS):
    """K3. x, res: (B, H, W, C); gamma, beta: (C,); ss: (B, 2C), rows may be
    strided (a column slice of the batched FiLM projection). A bfloat16 x
    (with bfloat16 ss and res) selects the bf16-activation variant and
    gives bfloat16."""
    if not _dispatch("group_norm_act", x):
        return group_norm_act_plain(x, gamma, beta, groups, ss=ss, res=res, eps=eps)
    return with_plain_vjp(_group_norm_launch, _group_norm_plain, x, gamma, beta, ss, res,
                          groups=groups, eps=eps)


def _group_norm_plain(x, gamma, beta, ss, res, groups, eps):
    return group_norm_act_plain(x, gamma, beta, groups, ss=ss, res=res, eps=eps)


GN_MAX_CLUSTER = 8       # the portable thread-block cluster size
GN_HELD_FLOATS = 13312   # the most of its slice a CTA holds (group_norm_act.cu: kHeldFloats)
GN_MAX_GROUP_CHANNELS = 2048  # channels per group (group_norm_act.cu: kMaxGroupChannels)
# one wave: below 128 KB rows, 4-CTA clusters timed faster than 8-CTA ones
# (tools/sweep_gn_cluster.py on an H100)
GN_MIN_CTAS = SM_COUNT


@functools.lru_cache(maxsize=None)
def gn_cluster_plan(rows: int, length: int) -> int:
    """CTAs per cluster of the fp32 K3 for `rows` GroupNorm rows of `length`
    values: the fewest of 1, 2, 4, 8 that give GN_MIN_CTAS CTAs (one per SM)
    with each CTA's slice (at most ceil(length / cluster) values) held in
    shared memory; else 8 (a CTA then holds what fits of its slice and reads
    the rest from device memory in each pass)."""
    for cs in (1, 2, 4, GN_MAX_CLUSTER):
        if rows * cs >= GN_MIN_CTAS and math.ceil(length / cs) <= GN_HELD_FLOATS:
            return cs
    return GN_MAX_CLUSTER


def gn_bf16_plan(rows: int, length: int) -> int:
    """CTAs per cluster of the bf16-activation K3 (256 threads a CTA) for
    `rows` GroupNorm rows of `length` values: the fewest of 1, 2, 4, 8 that
    give GN_MIN_CTAS CTAs, else 8. A CTA holds up to 100 KB of its slice
    (group_norm_act.cu: kHeldVecsBf16) and re-reads the rest. Fitted on
    device times at batch 50 (tools/sweep_gn_cluster.py --bf16act on an
    H100; PERF.md also has the sweep over 128 and 512 threads a CTA and
    clusters of up to 16): 4-CTA clusters gave the least time summed over a
    forward, within 2% of the best plan per signature; 8-CTA clusters at the
    widest level take 400 CTAs where at most 264 fit at once (up to 128
    registers a thread)."""
    return next((c for c in (1, 2, 4) if rows * c >= GN_MIN_CTAS), GN_MAX_CLUSTER)


def group_norm_cluster_emulated(x, groups: int, cluster: int, eps: float = GN_EPS,
                                vec: int = 4):
    """K3's statistics in plain PyTorch: (mean, rstd) per (sample, group)
    row, (B, groups) each. Each row is cut into `cluster` slices of whole
    `vec`-value vectors as the CTAs cut it (4 fp32 values; 8 bf16 values in
    the bf16-activation K3); each slice gives (count, mean, sum of squared
    deviations from its own mean) and the slices merge with Chan's formula
    in rank order. For the tests."""
    B, H, W, C = x.shape
    rows = x.reshape(B, H * W, groups, C // groups).permute(0, 2, 1, 3).reshape(B, groups, -1)
    nvec = rows.shape[-1] // vec
    n = x.new_zeros(B, groups)
    mean, m2 = torch.zeros_like(n), torch.zeros_like(n)
    for r in range(cluster):
        v0, v1 = nvec * r // cluster, nvec * (r + 1) // cluster
        if v1 == v0:
            continue
        sl = rows[..., vec * v0:vec * v1]
        nb = float(sl.shape[-1])
        mb = sl.mean(dim=-1)
        m2b = ((sl - mb[..., None]) ** 2).sum(dim=-1)
        nab = n + nb
        delta = mb - mean
        mean = mean + delta * (nb / nab)
        m2 = m2 + m2b + delta * delta * (n * nb / nab)
        n = nab
    return mean, torch.rsqrt(m2 / n + eps)


@functools.lru_cache(maxsize=None)
def _gn_plan(x_shape, groups, bf16=False):
    """The checks of one K3 call that depend on x's shape, the groups and
    the activation's dtype alone, once per shape: (B, H*W, C, cluster
    size)."""
    if len(x_shape) != 4:
        raise ValueError(f"group_norm_act: x must be NHWC, got {tuple(x_shape)}")
    B, H, W, C = x_shape
    if C % groups or (C // groups) % 4 or C // groups > GN_MAX_GROUP_CHANNELS:
        raise ValueError(f"group_norm_act: C={C} in {groups} groups; the kernel takes "
                         f"groups of a multiple of 4 channels, at most {GN_MAX_GROUP_CHANNELS}")
    if B * groups > 65535:
        raise ValueError(f"group_norm_act: {B * groups} rows; the kernel takes at most 65535")
    plan = gn_bf16_plan if bf16 else gn_cluster_plan
    return B, H * W, C, plan(B * groups, H * W * (C // groups))


def _group_norm_launch(x, gamma, beta, ss, res, groups, eps):
    act = x.dtype == torch.bfloat16
    _check_cuda("group_norm_act", bf16=("x", "res") if act else (), x=x, gamma=gamma,
                beta=beta, res=res)
    if act and res is not None and res.dtype != torch.bfloat16:
        raise TypeError("group_norm_act: x is bfloat16, res is not")
    B, hw, C, cs = _gn_plan(x.shape, groups, act)
    if gamma.shape != (C,) or beta.shape != (C,):
        raise ValueError("group_norm_act: gamma/beta must be (C,)")
    if res is not None and res.shape != x.shape:
        raise ValueError(f"group_norm_act: res {tuple(res.shape)} != x {tuple(x.shape)}")
    ss_stride = 0
    if ss is not None:
        # a column slice of the batched FiLM matmul: any row stride
        if (not ss.is_cuda or ss.get_device() != x.get_device() or ss.dtype != x.dtype
                or ss.shape != (B, 2 * C) or ss.stride(1) != 1):
            raise ValueError(f"group_norm_act: ss must be a {x.dtype} (B, 2C) tensor on "
                             "x's device with unit column stride")
        ss_stride = ss.stride(0)
    _check_vec4("group_norm_act", (), (x, res))
    if act and (C // groups) % 8:
        raise ValueError(f"group_norm_act: C={C} in {groups} groups; the bf16-activation "
                         "kernel takes groups of a multiple of 8 channels")
    out = torch.empty_like(x)
    lib = _build.load_library()
    err = (lib.group_norm_act_bf16act if act else lib.group_norm_act_f32)(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        ss.data_ptr() if ss is not None else None, res.data_ptr() if res is not None else None,
        out.data_ptr(), int_array((B, hw, C, groups, ss_stride, cs)), eps, _stream(x))
    _build.check(err, "group_norm_act")
    group_norm_act.launches += 1
    group_norm_act.bf16act_launches += int(act)
    return out


register_launch_counters(group_norm_act, "launches", "bf16act_launches")


# ---------------------------------------------------------------------------
# ResBlock (port of _resblock_kernel) as a fixed launch sequence
# ---------------------------------------------------------------------------


def _resblock(conv, gn, x_a, x_b, ss, p, groups):
    """conv3x3 -> GN+FiLM+SiLU -> conv3x3 -> GN+SiLU + (x | res_conv(x)).

    p: w1 (9*Ci, Co), b1, gs1, gb1, w2 (9*Co, Co), b2, gs2, gb2 [, wr (Ci, Co),
    br]; ss: (B, 2*Co). x_b, when given, is the skip tensor concatenated
    after x_a on the channel axis (read in place, never concatenated)."""
    h = conv(x_a, p["w1"], p["b1"], x_b=x_b, k=3)
    h = gn(h, p["gs1"], p["gb1"], groups, ss=ss)
    h = conv(h, p["w2"], p["b2"], k=3)
    if "wr" in p:
        res = conv(x_a, p["wr"], p["br"], x_b=x_b, k=1)
    elif x_b is None:
        res = x_a
    else:
        raise ValueError("resblock: a two-source input needs a residual conv "
                         "(Ci = Ca + Cb differs from Co on every UNet2D level)")
    return gn(h, p["gs2"], p["gb2"], groups, res=res)


def resblock(x_a, ss, p, x_b=None, groups: int = 1):
    """One UNet2D ResnetBlock through the kernel wrappers."""
    return _resblock(conv2d_nhwc, group_norm_act, x_a, x_b, ss, p, groups)


def resblock_plain(x_a, ss, p, x_b=None, groups: int = 1):
    """The same block from the plain versions only."""
    return _resblock(conv2d_nhwc_plain, group_norm_act_plain, x_a, x_b, ss, p,
                     groups)


# ---------------------------------------------------------------------------
# K7: two ResBlocks in one launch (port of _resblock_pair_kernel)
# ---------------------------------------------------------------------------


def _check_pair(x, p_a, p_b) -> None:
    chans = (x.shape[-1], p_a["w1"].shape[-1], p_b["w1"].shape[-1])
    if len(set(chans)) != 1:
        raise ValueError(f"resblock_pair: the pair takes equal channels (input, block a, "
                         f"block b), got {chans}")


def resblock_pair_plain(x, ss_a, ss_b, p_a, p_b, groups: int = 1):
    """:func:`resblock_plain` twice; equal channels only, as the Pallas pair
    (pallas_unet2d.py:424)."""
    _check_pair(x, p_a, p_b)
    return resblock_plain(resblock_plain(x, ss_a, p_a, groups=groups), ss_b, p_b,
                          groups=groups)


def resblock_pair(x, ss_a, ss_b, p_a, p_b, groups: int = 1):
    """K7: two ResnetBlocks of equal channels (B, H, W, C) in one launch of
    the persistent kernel (``kernels/unet2d_mega.py``); ss_a, ss_b: (B, 2C)
    FiLM. Forward-only. Refuses bfloat16 activations (no such K7 instance:
    ``unet2d_mega.BF16_ACT_REFUSED``)."""
    _check_pair(x, p_a, p_b)
    from diffphycon_tpu_torch.kernels import unet2d_mega  # it imports this module

    if x.dtype == torch.bfloat16:
        raise NotImplementedError(unet2d_mega.BF16_ACT_REFUSED.format("resblock_pair"))
    if not _dispatch("resblock_pair", x):
        return resblock_pair_plain(x, ss_a, ss_b, p_a, p_b, groups)
    out, wdt = unet2d_mega.resblock_pair_launch(x, ss_a, ss_b, p_a, p_b, groups)
    resblock_pair.launches += 1
    resblock_pair.bf16_launches += int(wdt == torch.bfloat16)
    return out


register_launch_counters(resblock_pair, "launches", "bf16_launches")

