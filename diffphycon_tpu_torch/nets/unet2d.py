"""UNet2D denoiser for Burgers, channels-last (B, T, X, C) at the boundary.

Port of ``diffphycon_tpu/nets/unet2d.py``, with the block sequence of the
kernel-backed forward ``unet2d_pallas_apply``
(diffphycon_tpu/research/pallas_unet2d.py:769-812):

- time MLP, and every ResBlock's FiLM projection batched into ONE matmul
  (``_film_all``), in plain torch;
- init 7x7 and final 1x1 convs as ``F.conv2d`` (XLA ops on the TPU too);
- each ResBlock through :func:`kernels.unet2d_blocks.resblock` (K1/K3),
  skip concats read in place by K1's second source;
- downsample through K2, upsample and the last-level 3x3 convs through K1;
- the 8 linear-attention blocks through K5, the bottleneck attention
  through K6 (``kernels/attention.py``).

:meth:`UNet2D.forward` is that kernel-backed path (on a CPU tensor each
wrapper takes its plain version). :meth:`UNet2D.forward_plain` runs the same
sequence (``kernels.unet2d_mega.unet2d_sequence``) from the plain versions
only; the tests and ``chip_smoke.py`` hold one against the other.

Two bf16 modes. ``UNet2D(dtype=torch.bfloat16)`` is the JAX
``UNet2D(dtype=jnp.bfloat16)``, flax's compute dtype (what the JAX
Burgers bench, ``infer_burgers --impl xla`` and ``train_burgers --bf16
True`` run): every activation between blocks is bfloat16 and each block
follows flax's rounding (the bf16-activation variants of K1/K2, K3, K5 and
K6 on the card, their plain versions here); the time MLP, the FiLM
projection and the init and final convs are bfloat16 torch ops with the
same rules; the output is bfloat16. ``UNet2D(weight_dtype=torch.bfloat16)``
is the Pallas forward under bf16 weight packs (JAX's ``infer_burgers --impl
pallas``): float32 activations, each matmul rounding its operand. Both
forwards are differentiable: the kernel wrappers are autograd Functions whose
backward is the VJP of their plain versions. :meth:`UNet2D.forward_mega` runs
everything between the init conv and the final conv as ONE launch of K8
(``kernels/unet2d_mega.py``, the port of ``unet2d_mega_apply``); it is
forward-only. For inference the kernel-layout weights (and K8's stage plans)
are cached; when a gradient can reach a parameter they are rebuilt under
autograd at every forward.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from diffphycon_tpu_torch.device import fp32_convs
from diffphycon_tpu_torch.kernels import unet2d_blocks as kb
from diffphycon_tpu_torch.kernels import unet2d_mega as kmega
from diffphycon_tpu_torch.nets.blocks import (
    AttentionBlock,
    Downsample,
    LinearAttentionBlock,
    ResnetBlock,
    Upsample,
    conv_pack,
    time_mlp,
)
from diffphycon_tpu_torch.utils.profiling import span


def _conv_nchw(x, conv: nn.Conv2d, weight_dtype=torch.float32):
    """NHWC in and out through F.conv2d on the channels-last view, in full
    fp32 forward and backward (see ``fp32_convs``). A bfloat16
    ``weight_dtype`` rounds the weight to bfloat16 values and leaves the
    input float32 (the Pallas forward's ``_conv_xla``, pallas_unet2d.py:755)."""
    fp32_convs()
    w = conv.weight if weight_dtype == torch.float32 else conv.weight.to(weight_dtype).float()
    out = F.conv2d(x.permute(0, 3, 1, 2), w, conv.bias, padding=conv.padding)
    return out.permute(0, 2, 3, 1).contiguous()


def _conv_bf16(x, conv: nn.Conv2d):
    """flax's bf16 ``nn.Conv`` on NHWC: input and weight rounded to
    bfloat16, the products summed in float32 (an fp32 conv of the rounded
    values, TF32 off), rounded, plus the bias rounded to bfloat16, rounded
    again; bfloat16 out."""
    fp32_convs()
    acc = F.conv2d(x.to(torch.bfloat16).float().permute(0, 3, 1, 2),
                   conv.weight.to(torch.bfloat16).float(), None, padding=conv.padding)
    return kb.conv_bias_bf16(acc.permute(0, 2, 3, 1), conv.bias).contiguous()


def _linear_bf16(x, lin: nn.Linear):
    """flax's bf16 ``nn.Dense``, as :func:`_conv_bf16`."""
    acc = x.to(torch.bfloat16).float() @ lin.weight.to(torch.bfloat16).float().t()
    return kb.conv_bias_bf16(acc, lin.bias)


def gelu_bf16(x):
    """``jax.nn.gelu(approximate=False)`` on bfloat16, every op rounded:
    ``0.5 * x * erfc(-x * sqrt(1/2))``, sqrt(1/2) rounded to bfloat16."""
    return (x * 0.5) * torch.erfc(-x * kb.bf16_const(0.5 ** 0.5, x))

class UNet2D(nn.Module):
    """``self_condition``: the input is ``x_self_cond`` (zeros when not
    given) concatenated before x on the channel axis, so the init conv takes
    2 * channels (JAX ``nets/unet2d.py:53-56``); the output keeps
    ``out_dim or channels`` channels.

    ``weight_dtype``: the dtype of the matmul weights in the kernel packs,
    float32 or bfloat16 (the Pallas forward under
    ``pack_unet2d_params(..., weight_dtype=jnp.bfloat16)``): every K1/K2
    conv weight and the attention blocks' ``wqkv`` and ``wo`` are rounded to
    bfloat16 (and run through the kernels' bf16 variants), the init and
    final convs take bfloat16-rounded weights on a float32 input, and
    everything else (biases, norms, FiLM, the time MLP, activations) stays
    float32. Parameters are float32 either way.

    ``dtype``: the compute dtype, flax's ``UNet2D(dtype=...)``: float32, or
    bfloat16 for bfloat16 activations under flax's rules (see the module
    docstring; its packs hold bfloat16 matmul weights, so ``weight_dtype``
    defaults to ``dtype`` and may not be float32 under it). The output is
    in ``dtype``."""

    def __init__(self, dim: int = 64, out_dim: Optional[int] = None,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), channels: int = 2,
                 resnet_block_groups: int = 1, attn_dim_head: int = 32,
                 attn_heads: int = 4, sinusoidal_pos_emb_theta: float = 10000.0,
                 self_condition: bool = False, weight_dtype: Optional[torch.dtype] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        weight_dtype = dtype if weight_dtype is None else weight_dtype
        if weight_dtype not in (torch.float32, torch.bfloat16) or dtype not in (
                torch.float32, torch.bfloat16):
            raise ValueError(f"UNet2D: weight_dtype {weight_dtype}, dtype {dtype}; float32 "
                             "or bfloat16")
        if dtype == torch.bfloat16 and weight_dtype != torch.bfloat16:
            raise ValueError("UNet2D: dtype bfloat16 (flax's compute dtype) rounds every "
                             "weight to bfloat16; weight_dtype float32 does not exist in it")
        self.weight_dtype = weight_dtype
        self.dtype = dtype
        self.dim = dim
        self.dim_mults = tuple(dim_mults)
        self.channels = channels
        self.self_condition = self_condition
        self.groups = groups = resnet_block_groups
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        time_dim = dim * 4
        heads, dh = attn_heads, attn_dim_head

        self.init_conv = nn.Conv2d(channels * (2 if self_condition else 1), dim, 7, padding=3)
        self.time_mlp = time_mlp(dim, time_dim, sinusoidal_pos_emb_theta)

        self.downs = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(in_out):
            last = i == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ResnetBlock(d_in, d_in, time_dim, groups),
                ResnetBlock(d_in, d_in, time_dim, groups),
                LinearAttentionBlock(d_in, heads, dh),
                nn.Conv2d(d_in, d_out, 3, padding=1) if last else Downsample(d_in, d_out),
            ]))
        mid = dims[-1]
        self.mid_block1 = ResnetBlock(mid, mid, time_dim, groups)
        self.mid_attn = AttentionBlock(mid, heads, dh)
        self.mid_block2 = ResnetBlock(mid, mid, time_dim, groups)
        self.ups = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(reversed(in_out)):
            last = i == len(in_out) - 1
            self.ups.append(nn.ModuleList([
                ResnetBlock(d_out + d_in, d_out, time_dim, groups),
                ResnetBlock(d_out + d_in, d_out, time_dim, groups),
                LinearAttentionBlock(d_out, heads, dh),
                nn.Conv2d(d_out, d_in, 3, padding=1) if last else Upsample(d_out, d_in),
            ]))
        self.final_res_block = ResnetBlock(dim * 2, dim, time_dim, groups)
        self.final_conv = nn.Conv2d(dim, out_dim or channels, 1)
        self.attn_heads, self.attn_dim_head = heads, dh
        self._pack_cache = None

    # -- weights in kernel layout --------------------------------------------

    def res_blocks(self):
        """ResBlocks in forward order (the order of the FiLM columns)."""
        blocks = [b for lvl in self.downs for b in lvl[:2]]
        blocks += [self.mid_block1, self.mid_block2]
        blocks += [b for lvl in self.ups for b in lvl[:2]]
        return blocks + [self.final_res_block]

    def pack(self) -> dict:
        """All kernel-layout weights, built from the current parameters, the
        matmul weights in ``weight_dtype``."""
        wd = self.weight_dtype
        res = self.res_blocks()
        packs = {"res": [b.pack(wd) for b in res],
                 "film_w": torch.cat([b.mlp[1].weight for b in res], 0).t().contiguous(),
                 "film_b": torch.cat([b.mlp[1].bias for b in res], 0),
                 "film_widths": [b.mlp[1].out_features for b in res]}
        packs["down"] = [lvl[3].pack(wd) if isinstance(lvl[3], Downsample)
                         else conv_pack(lvl[3], wd) for lvl in self.downs]
        packs["up"] = [lvl[3].pack(wd) if isinstance(lvl[3], Upsample)
                       else conv_pack(lvl[3], wd) for lvl in self.ups]
        packs["down_attn"] = [lvl[2].pack(wd) for lvl in self.downs]
        packs["up_attn"] = [lvl[2].pack(wd) for lvl in self.ups]
        packs["mid_attn"] = self.mid_attn.pack(wd)
        return packs

    def _kernel_pack(self) -> dict:
        """pack(). When grad is enabled and a parameter requires it, built
        afresh under autograd, so the loss reaches the parameters. Otherwise
        cached until any parameter is replaced or edited in place
        (load_state_dict, optimizer steps and .to() all bump the key)."""
        if torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters()):
            self._pack_cache = None  # parameters are about to change: free the copy
            return self.pack()
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._pack_cache is None or self._pack_cache[0] != key:
            with torch.no_grad():
                self._pack_cache = (key, self.pack())
        return self._pack_cache[1]

    # -- forwards ----------------------------------------------------------

    def forward(self, x, time, x_self_cond=None):
        """Kernel-backed forward. x: (B, T, X, C) float32; time: (B,). The
        output is in ``dtype``."""
        with span("nets.unet2d.forward"):
            return self._forward(self._input(x, x_self_cond), time, self._kernel_pack(),
                                 kmega.KERNEL_OPS)

    def forward_plain(self, x, time, x_self_cond=None):
        """The same block sequence from the plain versions only."""
        with span("nets.unet2d.forward"):
            return self._forward(self._input(x, x_self_cond), time, self.pack(),
                                 kmega.PLAIN_OPS)

    def forward_mega(self, x, time, x_self_cond=None):
        """The forward with one K8 launch between the init conv and the final
        conv (time MLP, FiLM matmul and both convs in torch, as JAX runs them
        outside its kernel). Forward-only: raises when a gradient could reach
        the input or a parameter. A CPU input takes the plain versions. A
        bfloat16 ``weight_dtype`` runs K8's bf16 instantiation on the bf16
        packs (and the init and final convs on bf16-rounded weights, as
        :meth:`forward`). Under ``dtype`` bfloat16 it raises: K8 has no
        bf16-activation instance (ROADMAP, queue 2 item 10)."""
        if self.dtype == torch.bfloat16:
            raise NotImplementedError(kmega.BF16_ACT_REFUSED.format("UNet2D.forward_mega"))
        if torch.is_grad_enabled():  # (walking the parameters costs ~1 ms of host time)
            kmega._forward_only("UNet2D.forward_mega", x, time, *self.parameters())
        with span("nets.unet2d.forward"):
            packs = self._kernel_pack()
            film = self._film(time, packs)
            x0 = _conv_nchw(self._input(x, x_self_cond), self.init_conv, self.weight_dtype)
            plan = kmega.mega_plan(packs, x0.shape, self.groups, self.attn_heads,
                                   self.attn_dim_head, x0.device)
            return _conv_nchw(kmega.unet2d_mega(x0, film, packs, plan), self.final_conv,
                              self.weight_dtype)

    def _input(self, x, x_self_cond):
        """x, checked, with the self-conditioning channels in front."""
        if x.dim() != 4:
            raise ValueError(f"UNet2D expects (B, T, X, C), got {tuple(x.shape)}")
        if not self.self_condition:
            return x
        if x_self_cond is None:
            x_self_cond = torch.zeros_like(x)
        return torch.cat([x_self_cond, x], dim=-1)

    def _film(self, time, packs):
        """Every ResBlock's FiLM projection as one (B, sum of 2*Co) matmul
        (under ``dtype`` bfloat16 the time MLP, the SiLU and the projection
        by flax's bf16 rules; each column is its block's own Dense)."""
        if self.dtype == torch.bfloat16:
            emb, fc1, _, fc2 = self.time_mlp
            t = _linear_bf16(gelu_bf16(_linear_bf16(emb(time), fc1)), fc2)
            acc = kb.silu_bf16(t).float() @ packs["film_w"].to(torch.bfloat16).float()
            return kb.conv_bias_bf16(acc, packs["film_b"])
        return F.silu(self.time_mlp(time)) @ packs["film_w"] + packs["film_b"]

    def _conv_io(self, x, conv):
        """The init or final conv in this net's mode."""
        if self.dtype == torch.bfloat16:
            return _conv_bf16(x, conv)
        return _conv_nchw(x, conv, self.weight_dtype)

    def _forward(self, x, time, packs, ops):
        film = iter(torch.split(self._film(time, packs), packs["film_widths"], dim=1))
        x = self._conv_io(x, self.init_conv)
        x = kmega.unet2d_sequence(ops, x, film, packs, self.groups, self.attn_heads,
                                  self.attn_dim_head)
        return self._conv_io(x, self.final_conv)
