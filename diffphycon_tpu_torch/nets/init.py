"""Seeded random weights for the port's nets (no trained meaning: they make
the main paths runnable and repeatable without a checkpoint)."""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def seeded_init_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Convolutions (transposed too) and linears U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) for weights and biases, fan_in as torch computes it
    (weight dim 1 times the kernel size); GroupNorm at ones/zeros; channel
    LayerNorm gains (``.g``, ``.gamma``) at ones; embeddings N(0, 1), flax's
    init of the relative position table."""
    for m in net.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
                          nn.ConvTranspose3d, nn.Linear)):
            fan_in = m.weight.shape[1] * m.weight[0, 0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
    for name, p in net.named_parameters():
        if name.endswith((".g", ".gamma")):
            p.fill_(1.0)
    return net
