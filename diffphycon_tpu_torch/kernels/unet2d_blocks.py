"""Kernel-backed UNet2D blocks and their plain PyTorch versions.

The port of ``diffphycon_tpu/research/pallas_unet2d.py``. Six Pallas kernels
map onto three hand-written Hopper kernels (the attention blocks, K5 and K6,
are in ``kernels/attention.py``):

===============================  ==========================================
Pallas kernel (pallas_unet2d.py)  Port
===============================  ==========================================
``_resblock_kernel`` :160         :func:`resblock`: K1, K3, K1, [K1], K3
``_downsample_kernel`` :259       K2 :func:`downsample_nhwc`
``_upsample_kernel`` :279         K1 :func:`conv2d_nhwc` ``upsample=True``
``_conv_kernel`` :288 (3x3)       K1 :func:`conv2d_nhwc`
``_matmul_bias_kernel`` :294      K1 :func:`conv2d_nhwc` ``k=1`` (x @ w + b)
``_concat_kernel`` :304           K1 reading two sources (``x_b``)
===============================  ==========================================

K1 = csrc/conv2d_nhwc.cu, K2 = csrc/downsample_nhwc.cu (CUDA C++, sm_90a),
K3 = group_norm_triton.py (Triton).

Every public wrapper dispatches on the device of its input: a CPU tensor goes
to the ``*_plain`` version, a CUDA tensor to the kernel (or the wrapper
raises). There is no fallback from one to the other. Each wrapper counts its
kernel launches in the int attribute ``launches`` (plus per-mode counts on
``conv2d_nhwc``), registered with the package's counter registry:
:func:`reset_launch_counts` and :func:`launch_counts` (from
``diffphycon_tpu_torch.kernels``) clear and read every registered counter.

Gradients: on a CUDA tensor each wrapper is a ``torch.autograd.Function``
(:func:`with_plain_vjp`) whose forward launches the kernel and whose backward
is the VJP of the plain version, recomputed from the saved inputs: the
backward is plain PyTorch until backward kernels are written. ``resblock``
is differentiable through the Functions of the K1 and K3 launches it makes.
On a CPU tensor the plain version runs under ordinary autograd.

Layouts: activations NHWC fp32, contiguous. Conv weights are packed once
(see ``nets/unet2d.py``): a KxK conv as ``(K*K*Ci, Co)`` with row index
``(dy*K + dx)*Ci + c``; the downsample as ``(4*C, Co)`` with row index
``(p1*2 + p2)*C + c``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from diffphycon_tpu_torch.kernels import (  # noqa: F401 (counters re-exported)
    _build,
    group_norm_triton,
    launch_counts,
    register_launch_counters,
    reset_launch_counts,
)

GN_EPS = 1e-5
_INT32_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# checks shared by the CUDA paths
# ---------------------------------------------------------------------------


def _check_cuda(name: str, **tensors) -> None:
    dev = None
    for key, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}, expected cuda")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, others on {dev}")
        dev = t.device
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} has dtype {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.numel() > _INT32_MAX:
            raise ValueError(f"{name}: {key} has more than 2^31-1 elements")


def _check_vec4(name: str, channels, tensors) -> None:
    """The CUDA convs move 4 channels per 16-byte load."""
    if any(c % 4 for c in channels):
        raise ValueError(f"{name}: channel counts {list(channels)} must be multiples "
                         "of 4 for the kernel")
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must start 16-byte aligned")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _dispatch(name: str, x: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the plain CPU version."""
    if x.device.type == "cuda":
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


def with_plain_vjp(launch, plain, *inputs):
    """``launch(*inputs)``, differentiable through the plain version when
    grad is enabled and an input requires it (else the bare launch)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return _PlainVJP.apply(launch, plain, *inputs)
    return launch(*inputs)


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
    Pallas ``_conv2d`` (pallas_unet2d.py:61-95)."""
    x = _conv_input(x_a, x_b, upsample)
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
    return (acc + b).reshape(B, H, W, -1)


def conv2d_nhwc(x_a, w, b, x_b=None, k: int = 3, upsample: bool = False):
    """K1. x_a: (B, H, W, Ca) [, x_b: (B, H, W, Cb)]; w: (k*k*(Ca+Cb), Co);
    b: (Co,). With ``upsample`` the output is (B, 2H, 2W, Co)."""
    if not _dispatch("conv2d_nhwc", x_a):
        return conv2d_nhwc_plain(x_a, w, b, x_b=x_b, k=k, upsample=upsample)
    return with_plain_vjp(functools.partial(_conv2d_launch, k=k, upsample=upsample),
                          functools.partial(conv2d_nhwc_plain, k=k, upsample=upsample),
                          x_a, w, b, x_b)


def _conv2d_launch(x_a, w, b, x_b, k, upsample):
    _check_cuda("conv2d_nhwc", x_a=x_a, x_b=x_b, w=w, b=b)
    if k not in (1, 3):
        raise ValueError(f"conv2d_nhwc: k={k}; the kernel takes 1 or 3")
    if x_a.dim() != 4:
        raise ValueError(f"conv2d_nhwc: x_a must be NHWC, got {tuple(x_a.shape)}")
    B, Hs, Ws, ca = x_a.shape
    cb = 0
    if x_b is not None:
        if x_b.dim() != 4 or x_b.shape[:3] != x_a.shape[:3]:
            raise ValueError(f"conv2d_nhwc: x_b {tuple(x_b.shape)} does not "
                             f"match x_a {tuple(x_a.shape)}")
        cb = x_b.shape[3]
    co = w.shape[-1]
    if w.dim() != 2 or w.shape[0] != k * k * (ca + cb) or b.shape != (co,):
        raise ValueError(f"conv2d_nhwc: weight {tuple(w.shape)} / bias "
                         f"{tuple(b.shape)} do not fit k={k}, Ci={ca + cb}")
    _check_vec4("conv2d_nhwc", (ca, cb, co), (x_a, x_b, w, b))
    H, W = (2 * Hs, 2 * Ws) if upsample else (Hs, Ws)
    out = torch.empty((B, H, W, co), device=x_a.device, dtype=torch.float32)
    if out.numel() > _INT32_MAX:
        raise ValueError("conv2d_nhwc: output too large for int32 indexing")
    lib = _build.load_library()
    err = lib.conv2d_nhwc_f32(
        x_a.data_ptr(), x_b.data_ptr() if x_b is not None else None,
        w.data_ptr(), b.data_ptr(), out.data_ptr(),
        B, H, W, ca, cb, co, k, int(upsample), _stream(x_a))
    _build.check(err, "conv2d_nhwc")
    conv2d_nhwc.launches += 1
    conv2d_nhwc.dual_launches += int(x_b is not None)
    conv2d_nhwc.upsample_launches += int(bool(upsample))
    return out


register_launch_counters(conv2d_nhwc, "launches", "dual_launches", "upsample_launches")


# ---------------------------------------------------------------------------
# K2: 2x2 stride-2 conv (space-to-depth + 1x1)
# ---------------------------------------------------------------------------


def downsample_nhwc_plain(x, w, b):
    """Space-to-depth in (p1 p2 c) order + one matmul
    (``_downsample_kernel``, pallas_unet2d.py:259-276)."""
    B, H, W, C = x.shape
    x6 = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    out = x6.reshape(B * (H // 2) * (W // 2), 4 * C) @ w + b
    return out.reshape(B, H // 2, W // 2, -1)


def downsample_nhwc(x, w, b):
    """K2. x: (B, H, W, C) with even H, W; w: (4*C, Co); b: (Co,)."""
    if not _dispatch("downsample_nhwc", x):
        return downsample_nhwc_plain(x, w, b)
    return with_plain_vjp(_downsample_launch, downsample_nhwc_plain, x, w, b)


def _downsample_launch(x, w, b):
    _check_cuda("downsample_nhwc", x=x, w=w, b=b)
    if x.dim() != 4 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"downsample_nhwc: x must be NHWC with even H, W, "
                         f"got {tuple(x.shape)}")
    B, H, W, C = x.shape
    co = w.shape[-1]
    if w.dim() != 2 or w.shape[0] != 4 * C or b.shape != (co,):
        raise ValueError(f"downsample_nhwc: weight {tuple(w.shape)} / bias "
                         f"{tuple(b.shape)} do not fit C={C}")
    _check_vec4("downsample_nhwc", (C, co), (x, w, b))
    out = torch.empty((B, H // 2, W // 2, co), device=x.device, dtype=torch.float32)
    lib = _build.load_library()
    err = lib.downsample_nhwc_f32(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                  out.data_ptr(), B, H, W, C, co, _stream(x))
    _build.check(err, "downsample_nhwc")
    downsample_nhwc.launches += 1
    return out


register_launch_counters(downsample_nhwc, "launches")


# ---------------------------------------------------------------------------
# K3: GroupNorm (+ FiLM) + SiLU (+ residual)
# ---------------------------------------------------------------------------


def group_norm_act_plain(x, gamma, beta, groups: int = 1, ss=None, res=None,
                         eps: float = GN_EPS):
    """SiLU(GN(x) [* (scale+1) + shift]) [+ res]; GN per (sample, group) over
    (H, W, C/groups) with biased variance (flax GroupNorm). ss: (B, 2C) FiLM
    scale | shift."""
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


def group_norm_act(x, gamma, beta, groups: int = 1, ss=None, res=None,
                   eps: float = GN_EPS):
    """K3. x, res: (B, H, W, C); gamma, beta: (C,); ss: (B, 2C), rows may be
    strided (a column slice of the batched FiLM projection)."""
    if not _dispatch("group_norm_act", x):
        return group_norm_act_plain(x, gamma, beta, groups, ss=ss, res=res, eps=eps)

    def plain(x, gamma, beta, ss, res):
        return group_norm_act_plain(x, gamma, beta, groups, ss=ss, res=res, eps=eps)

    return with_plain_vjp(functools.partial(_group_norm_launch, groups=groups, eps=eps),
                          plain, x, gamma, beta, ss, res)


def _group_norm_launch(x, gamma, beta, ss, res, groups, eps):
    _check_cuda("group_norm_act", x=x, gamma=gamma, beta=beta, res=res)
    if x.dim() != 4:
        raise ValueError(f"group_norm_act: x must be NHWC, got {tuple(x.shape)}")
    B, H, W, C = x.shape
    if C % groups:
        raise ValueError(f"group_norm_act: C={C} not divisible by groups={groups}")
    if gamma.shape != (C,) or beta.shape != (C,):
        raise ValueError("group_norm_act: gamma/beta must be (C,)")
    # ss is a column slice of the batched FiLM matmul: any row stride
    if ss is not None and (ss.device != x.device or ss.dtype != torch.float32
                           or ss.shape != (B, 2 * C) or ss.stride(1) != 1):
        raise ValueError("group_norm_act: ss must be a float32 (B, 2C) tensor on "
                         "x's device with unit column stride")
    if res is not None and res.shape != x.shape:
        raise ValueError(f"group_norm_act: res {tuple(res.shape)} != x {tuple(x.shape)}")
    out = torch.empty_like(x)
    group_norm_triton.launch(x, gamma, beta, groups, eps, ss, res, out)
    group_norm_act.launches += 1
    return out


register_launch_counters(group_norm_act, "launches")


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

