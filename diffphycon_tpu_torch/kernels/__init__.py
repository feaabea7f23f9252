"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) and
their plain PyTorch versions.

Launch counters of the UNet2D kernels: each wrapper module registers its
wrappers' int counter attributes with :func:`register_launch_counters`;
:func:`launch_counts` reads them all and :func:`reset_launch_counts` clears
them. A wrapper adds one to its counter only where it launches its kernel.

Work counters (:data:`COUNTERS`): :func:`count` adds to one only while a
``torch.profiler`` records, as the spans of ``utils/profiling.py`` do. It
keeps a reference to the tensor the work already wrote and sums it only when
:func:`counters` reads it, so counting launches nothing and waits for
nothing inside a traced window. :func:`reset_counters` clears them.
"""

from diffphycon_tpu_torch.utils.profiling import recording

_COUNTERS = []  # (wrapper, counter attribute names), in registration order

# counter name -> what it counts
COUNTERS = {
    "solver.cg_iterations": "K4's CG iterations, summed over the elements solved",
    "solver.cg_solves": "elements (fields) K4 solved",
}
_ADDED = {}  # counter name -> [tensors or ints added since the last read]


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


def count(name: str, value) -> None:
    """Add ``value`` (an int, or a tensor whose elements are summed when
    read) to the counter ``name`` of :data:`COUNTERS`, while a profiler
    records."""
    if recording():
        _ADDED.setdefault(name, []).append(value)


def counters() -> dict:
    """{counter name: int} of every counter added to since the last reset
    (this synchronises with the device that holds the tensors)."""
    out = {}
    for name, values in _ADDED.items():
        total = sum(int(v.sum()) if hasattr(v, "sum") else int(v) for v in values)
        _ADDED[name] = [total]
        out[name] = total
    return out


def reset_counters() -> None:
    _ADDED.clear()
