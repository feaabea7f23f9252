"""The FLOP counters of portbench/flops.py against hand counts at tiny
widths, and against torch's FlopCounterMode over the plain references."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops as pf
from portbench.reference import unet2d as r2
from portbench.reference import unet3d as r3
from portbench.weights import make_params

BASE2 = {"channels": 1, "out_dim": 1, "resnet_block_groups": 1, "attn_heads": 1,
         "attn_dim_head": 2, "sinusoidal_pos_emb_theta": 10000.0, "dtype": "float32",
         "group_norm_eps": 1e-5, "chan_layer_norm_eps": 1e-5}
BASE3 = {"attn_heads": 1, "attn_dim_head": 2, "resnet_groups": 8, "init_kernel_size": 3,
         "dtype": "float32", "group_norm_eps": 1e-5, "chan_layer_norm_eps": 1e-5}


def test_unet2d_hand_count():
    # dim 2, one level, 2 x 2 input, batch 1: multiply-adds by layer
    cfg = dict(BASE2, dim=2, dim_mults=[1])
    macs = (392          # init conv 7x7, 1 -> 2
            + 80 + 224   # time MLP (2x8, 8x8); FiLM of 7 blocks (8 x 28)
            + 288 * 2    # downs.0.0, downs.0.1: two 3x3 2 -> 2 convs each
            + 96 + 144   # linear attention (qkv 48, core 32, out 16); 3x3 conv
            + 576 + 128  # mid blocks; full attention (qkv 48, core 64, out 16)
            + 464 * 2    # ups.0.0/1: 3x3 4 -> 2, 3x3 2 -> 2, 1x1 4 -> 2
            + 96 + 144   # linear attention; 3x3 conv
            + 464 + 8)   # final block (4 -> 2); final 1x1
    assert pf.totals(pf.unet2d_layers(cfg, 1, 2, 2))[0] == 2 * macs == 7712


def test_unet3d_hand_count():
    # dim 8, one level, 2 frames of 2 x 2, one channel, batch 1
    cfg = dict(BASE3, dim=8, dim_mults=[1], frames=2, image_size=2)
    macs = (1728                # init conv 3^3, 1 -> 8
            + 576               # init temporal attention (4 sequences of 2 frames)
            + 1280 + 3072       # time MLP; FiLM of 6 blocks (32 x 96)
            + 27648 * 2         # downs.0.0/1: two 3^3 8 -> 8 convs each
            + 576 + 576         # spatial linear, temporal attention
            + 55296 + 640 + 576  # mid blocks; spatial full attention; temporal
            + 42496 + 27648     # ups.0.0 (16 -> 8 with 1^3 res conv), ups.0.1
            + 576 + 576         # spatial linear, temporal
            + 42496 + 64)       # final block (16 -> 8, no FiLM); final 1^3 conv
    assert pf.totals(pf.unet3d_layers(cfg, 1, 1))[0] == 2 * macs == 466944


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("dim,mults,h,w,batch", [(4, [1], 2, 2, 1), (8, [1, 2], 16, 32, 2),
                                                 (8, [1, 2, 4, 8], 16, 32, 1)])
def test_unet2d_counter_matches_the_reference_ops(dim, mults, h, w, batch):
    cfg = dict(BASE2, dim=dim, dim_mults=mults, attn_heads=4, attn_dim_head=32, channels=2,
               out_dim=2)
    P = make_params(r2.param_shapes(cfg), 1, 1, "cpu")
    x, t = torch.randn(batch, h, w, 2), torch.full((batch,), 5.0)
    counted = _counted(lambda: r2.forward(P, x, t, cfg))
    assert pf.totals(pf.unet2d_layers(cfg, batch, h, w))[0] == counted


@pytest.mark.parametrize("dim,mults,frames,size,ch", [(8, [1], 2, 2, 1), (8, [1, 2], 4, 8, 6),
                                                      (16, [1, 2, 4], 4, 16, 2)])
def test_unet3d_counter_matches_the_reference_ops(dim, mults, frames, size, ch):
    cfg = dict(BASE3, dim=dim, dim_mults=mults, frames=frames, image_size=size,
               attn_heads=4, attn_dim_head=32, init_kernel_size=7)
    P = make_params(r3.param_shapes(cfg, ch), 1, 1, "cpu")
    x, t = torch.randn(2, frames, size, size, ch), torch.full((2,), 5.0)
    counted = _counted(lambda: r3.forward(P, x, t, cfg))
    assert pf.totals(pf.unet3d_layers(cfg, 2, ch))[0] == counted


def test_full_size_step_flops():
    """One guided Burgers step (two forwards at batch 50) is ~0.75 TFLOP."""
    import json
    from pathlib import Path

    cfg = json.loads((Path(pf.__file__).parent / "configs" /
                      "burgers-unet2d-flax-bf16.json").read_text())
    flops, bound = pf.totals(pf.unet2d_layers(cfg, 50, 16, 128))
    assert 0.3e12 < flops < 0.45e12 and bound > flops / pf.PEAKS["bf16"]
