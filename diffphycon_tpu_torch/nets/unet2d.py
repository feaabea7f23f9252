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
sequence from the plain versions only; the tests and ``chip_smoke.py`` hold
one against the other. Both forwards are differentiable: the kernel wrappers
are autograd Functions whose backward is the VJP of their plain versions.
For inference the kernel-layout weights are cached; when a gradient can reach
a parameter they are rebuilt under autograd at every forward.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from diffphycon_tpu_torch.kernels import attention as ka
from diffphycon_tpu_torch.kernels import unet2d_blocks as kb
from diffphycon_tpu_torch.nets.blocks import (
    AttentionBlock,
    Downsample,
    LinearAttentionBlock,
    ResnetBlock,
    Upsample,
    conv_pack,
    time_mlp,
)

_KERNEL_OPS = (kb.resblock, kb.downsample_nhwc, kb.conv2d_nhwc, ka.linear_attention_block,
               ka.attention_block)
_PLAIN_OPS = (kb.resblock_plain, kb.downsample_nhwc_plain, kb.conv2d_nhwc_plain,
              ka.linear_attention_block_plain, ka.attention_block_plain)


def _conv_nchw(x, conv: nn.Conv2d):
    """NHWC in and out through F.conv2d on the channels-last view (full fp32:
    cuDNN would otherwise run a float32 conv in TF32)."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias,
                       padding=conv.padding)
    return out.permute(0, 2, 3, 1).contiguous()


class UNet2D(nn.Module):
    def __init__(self, dim: int = 64, out_dim: Optional[int] = None,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), channels: int = 2,
                 resnet_block_groups: int = 1, attn_dim_head: int = 32,
                 attn_heads: int = 4, sinusoidal_pos_emb_theta: float = 10000.0):
        super().__init__()
        self.dim = dim
        self.dim_mults = tuple(dim_mults)
        self.channels = channels
        self.groups = groups = resnet_block_groups
        dims = [dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        time_dim = dim * 4
        heads, dh = attn_heads, attn_dim_head

        self.init_conv = nn.Conv2d(channels, dim, 7, padding=3)
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
        """All kernel-layout weights, built from the current parameters."""
        res = self.res_blocks()
        packs = {"res": [b.pack() for b in res],
                 "film_w": torch.cat([b.mlp[1].weight for b in res], 0).t().contiguous(),
                 "film_b": torch.cat([b.mlp[1].bias for b in res], 0),
                 "film_widths": [b.mlp[1].out_features for b in res]}
        packs["down"] = [lvl[3].pack() if isinstance(lvl[3], Downsample)
                         else conv_pack(lvl[3]) for lvl in self.downs]
        packs["up"] = [lvl[3].pack() if isinstance(lvl[3], Upsample)
                       else conv_pack(lvl[3]) for lvl in self.ups]
        packs["down_attn"] = [lvl[2].pack() for lvl in self.downs]
        packs["up_attn"] = [lvl[2].pack() for lvl in self.ups]
        packs["mid_attn"] = self.mid_attn.pack()
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

    def forward(self, x, time):
        """Kernel-backed forward. x: (B, T, X, C) float32; time: (B,)."""
        return self._forward(x, time, self._kernel_pack(), _KERNEL_OPS)

    def forward_plain(self, x, time):
        """The same block sequence from the plain versions only."""
        return self._forward(x, time, self.pack(), _PLAIN_OPS)

    def _forward(self, x, time, packs, ops):
        resblock, downsample, conv, linear_attn, attn = ops
        if x.dim() != 4:
            raise ValueError(f"UNet2D expects (B, T, X, C), got {tuple(x.shape)}")
        g, heads, dh = self.groups, self.attn_heads, self.attn_dim_head
        temb = self.time_mlp(time)
        ss_all = F.silu(temb) @ packs["film_w"] + packs["film_b"]
        film = iter(torch.split(ss_all, packs["film_widths"], dim=1))
        res_p = iter(packs["res"])

        def block(x_a, x_b=None):
            return resblock(x_a, next(film), next(res_p), x_b=x_b, groups=g)

        x = _conv_nchw(x, self.init_conv)
        r = x
        h = []
        for i, lvl in enumerate(self.downs):
            x = block(x)
            h.append(x)
            x = block(x)
            x = linear_attn(x, packs["down_attn"][i], heads, dh)
            h.append(x)
            p = packs["down"][i]
            if isinstance(lvl[3], Downsample):
                x = downsample(x, p["w"], p["b"])
            else:
                x = conv(x, p["w"], p["b"], k=3)

        x = block(x)
        x = attn(x, packs["mid_attn"], heads, dh)
        x = block(x)

        for i, lvl in enumerate(self.ups):
            x = block(x, h.pop())
            x = block(x, h.pop())
            x = linear_attn(x, packs["up_attn"][i], heads, dh)
            p = packs["up"][i]
            x = conv(x, p["w"], p["b"], k=3, upsample=isinstance(lvl[3], Upsample))

        x = block(x, r)
        return _conv_nchw(x, self.final_conv)
