"""Seeded weights made on the device in one draw (no host init, no copy).

A net's parameters are named by its plain reference (``param_shapes``). All
of them come from ONE uniform draw of a ``torch.Generator`` on the device,
cut in name order and scaled in place: convolutions and linears U(-1, 1) /
sqrt(fan_in) (weights and biases; fan_in as torch counts it, weight dim 1
times the kernel size), GroupNorm and channel-LayerNorm gains 1 + 0.1 U,
GroupNorm shifts 0.1 U, the relative position table U(-sqrt 3, sqrt 3)
(unit variance). The program's module and the reference receive the same
values: the program by one fused copy into its parameters, the reference by
drawing again from the seed after the program is gone.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit generator seed for (seed, stream...) (any whole seed)."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), *stream]).generate_state(
        1, np.uint64)[0]
    return int(state) >> 1


def make_params(shapes: dict, seed: int, stream: int, device) -> dict:
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 0, stream))
    flat = torch.rand(sum(sizes), generator=g, device=device).mul_(2.0).sub_(1.0)
    out = {}
    for name, part in zip(names, torch.split(flat, sizes)):
        v = part.view(shapes[name])
        if name.endswith((".g", ".gamma", ".norm.weight")):
            v.mul_(0.1).add_(1.0)
        elif name.endswith(".norm.bias"):
            v.mul_(0.1)
        elif name.endswith("relative_attention_bias.weight"):
            v.mul_(math.sqrt(3.0))
        else:
            w = shapes[name[: -len("bias")] + "weight"] if name.endswith("bias") else shapes[name]
            v.mul_(1.0 / math.sqrt(w[1] * math.prod(w[2:])))
        out[name] = v
    return out


@torch.no_grad()
def load_into(module: torch.nn.Module, params: dict) -> None:
    """Write ``params`` into ``module`` (its names and shapes must be the
    reference's, one for one) with one fused copy."""
    named = dict(module.named_parameters())
    if set(named) != set(params):
        raise ValueError("the program's parameters differ from the reference's: "
                         f"only program {sorted(set(named) - set(params))[:5]}, "
                         f"only reference {sorted(set(params) - set(named))[:5]}")
    bad = [n for n, p in named.items() if tuple(p.shape) != tuple(params[n].shape)]
    if bad:
        raise ValueError(f"parameter shapes differ from the reference's: {bad[:5]}")
    if list(module.buffers()):
        raise ValueError("the module holds buffers that the benchmark does not make")
    names = sorted(named)
    torch._foreach_copy_([named[n] for n in names], [params[n] for n in names])


def build_module(factory, shapes: dict, seed: int, stream: int, device):
    """factory() -> an nn.Module, constructed on the meta device, then
    allocated on ``device`` and given the seeded parameters."""
    with torch.device("meta"):
        module = factory()
    module = module.to_empty(device=device)
    load_into(module, make_params(shapes, seed, stream, device))
    return module
