"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``, Triton here) and
their plain PyTorch versions.

Launch counters of the UNet2D kernels: each wrapper module registers its
wrappers' int counter attributes with :func:`register_launch_counters`;
:func:`launch_counts` reads them all and :func:`reset_launch_counts` clears
them. A wrapper adds one to its counter only where it launches its kernel.
"""

_COUNTERS = []  # (wrapper, counter attribute names), in registration order


def register_launch_counters(fn, *attrs: str) -> None:
    """Zero the counters ``attrs`` of wrapper ``fn`` ("launches", or a
    "<mode>_launches" sub-count) and list them."""
    for a in attrs:
        setattr(fn, a, 0)
    _COUNTERS.append((fn, attrs))


def launch_counts() -> dict:
    """{'conv2d_nhwc': n, 'conv2d_nhwc.dual': n, ...} since the last reset."""
    out = {}
    for fn, attrs in _COUNTERS:
        for a in attrs:
            key = fn.__name__ if a == "launches" else f"{fn.__name__}.{a[:-9]}"
            out[key] = getattr(fn, a)
    return out


def reset_launch_counts() -> None:
    for fn, attrs in _COUNTERS:
        for a in attrs:
            setattr(fn, a, 0)
