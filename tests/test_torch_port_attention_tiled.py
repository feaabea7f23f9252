"""The arithmetic of K6 (the full-attention block split over the card) on
the CPU:

- ``attention_tiled_emulated`` (the softmax taken online over 64-key tiles,
  the out-projection as the four heads' partials summed in head order)
  against ``attention_block_plain`` and the Pallas ``attention_block`` in
  interpret mode, at token counts of one ragged tile, one full tile, two
  tiles and four with a ragged last one, at C = 64 and 512;
- the 3-level dim-16 UNet2D (a 4x32 = 128-token bottleneck) with that
  arithmetic in its attention block, against the JAX net;
- ``attn_tile_rows``, K6's token tile.

Tolerance: max |port - ref| <= 1e-5 * max(1, max |ref|), float32 on every
side, sums in another order only (the net: 1e-4, compounded over its
blocks as in test_torch_port_nets.py). The kernel itself runs on the card
(test_torch_port_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.nets.unet2d import UNet2D as JaxUNet2D
from diffphycon_tpu.research import pallas_unet2d as pu
from diffphycon_tpu_torch.kernels import attention as ka
from diffphycon_tpu_torch.kernels import unet2d_blocks as kb
from diffphycon_tpu_torch.kernels import unet2d_mega as kmega
from diffphycon_tpu_torch.nets.unet2d import UNet2D
from diffphycon_tpu_torch.utils import convert
from torch_port_helpers import assert_close, flax_tree, rand

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _interpret():
    pu.set_interpret(True)
    yield
    pu.set_interpret(False)


def _params(c, seed=0):
    p = {"norm_g": 1 + 0.1 * rand(c, seed=seed), "wqkv": rand(c, 384, seed=seed + 1) / np.sqrt(c),
         "wo": rand(128, c, seed=seed + 2) / np.sqrt(128), "bo": 0.1 * rand(c, seed=seed + 3)}
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("c", [64, 512])
@pytest.mark.parametrize("hw", [(4, 7), (2, 16), (4, 32), (10, 20)])
def test_port_tiled_attention_matches_plain_and_pallas(hw, c):
    """n = 28, 32, 128, 200 tokens. The last tokens are shifted so that the
    running max moves between key tiles and the merge must rescale."""
    x = 2 * rand(2, *hw, c, seed=5) + 0.3
    x[:, -1] += 3.0
    p = _params(c)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    out = ka.attention_tiled_emulated(torch.from_numpy(x), tp)
    assert_close(out, ka.attention_block_plain(torch.from_numpy(x), tp), RTOL)
    ref = pu.attention_block(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    assert_close(out, ref, RTOL)


def test_port_unet2d_tiled_attention_at_a_128_token_bottleneck():
    """The port's UNet2D block sequence with K6's tiled arithmetic in its
    bottleneck attention, against the JAX net (input (2, 16, 128, 2): the
    bottleneck is 4 x 32 = 128 tokens at 64 channels)."""
    net = JaxUNet2D(dim=16, dim_mults=(1, 2, 4), channels=2, out_dim=2, resnet_block_groups=1)
    x, t = rand(2, 16, 128, 2, seed=9), np.array([5.0, 800.0], np.float32)
    params = flax_tree(net, jnp.asarray(x), jnp.asarray(t), seed=3)
    ref = np.asarray(jax.jit(net.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    port = UNet2D(dim=16, dim_mults=(1, 2, 4), channels=2, out_dim=2)
    convert.load_flax_unet2d(port, params)
    seen = []

    def tiled(h, p, heads, dim_head):
        seen.append(tuple(h.shape))
        return ka.attention_tiled_emulated(h, p)

    ops = kmega.PLAIN_OPS[:4] + (tiled,)
    with torch.no_grad():
        out = port._forward(torch.from_numpy(x), torch.from_numpy(t), port.pack(), ops)
        fwd = port(torch.from_numpy(x), torch.from_numpy(t))
    assert seen == [(2, 4, 32, 64)]
    assert_close(out, ref, 1e-4)
    assert_close(out, fwd, 1e-4)


def test_port_attention_tile_rows():
    """32-token tiles where 64-token ones would give K6a's three passes
    fewer CTAs than SMs; at the Burgers bottleneck (batch 50, 32 tokens):
    25 tiles of 64, so 50 of 32 (150 CTAs)."""
    assert ka.attn_tile_rows(50, 32) == 32
    assert ka.attn_tile_rows(16, 32) == 32
    assert ka.attn_tile_rows(2, 2048) == 64
    for B, n in [(1, 1), (3, 28), (50, 32), (4, 128), (2, 2048), (50, 2048)]:
        rows = ka.attn_tile_rows(B, n)
        assert rows in (32, 64)
        assert (rows == 64) == (3 * -(-B * n // 64) >= kb.SM_COUNT)


@pytest.mark.parametrize("B,n", [(1, 1), (3, 28), (50, 32), (4, 128), (50, 2048)])
def test_port_attention_tile_rows_bf16(B, n):
    """The bf16 variant's K6a and K6c take 64 tokens of the flattened (B n)
    tokens everywhere: its wgmma products are 64 rows; the shapes' checks
    hand the kernel that tile."""
    assert ka.attn_tile_rows(B, n, bf16=True) == 64
    assert ka._full_shapes((B, 1, n, 64), True)[0] == (B, n, 64, 64)
    assert ka._full_shapes((B, 1, n, 64), False)[0][3] == ka.attn_tile_rows(B, n)
