"""Build and load the hand-written CUDA kernels of the port.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``. The library lands in
``build/diffphycon_tpu_torch/<hash of the sources>/`` at the checkout root, so
a change to any source rebuilds and an unchanged tree reuses the build.

Nothing here runs at import time: the first kernel launch calls
:func:`load_library`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "diffphycon_tpu_torch"
LIB_NAME = "libdiffphycon_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: name -> argtypes (every function returns cudaError_t as int)
SIGNATURES = {
    "conv2d_nhwc_f32": [_P] * 8,  # ..., const int dims[12], stream
    "conv2d_nhwc_bf16": [_P] * 8,  # the same, w bf16
    "conv2d_nhwc_bf16act": [_P] * 8,  # the same, xa, xb, w and out bf16
    "downsample_nhwc_f32": [_P] * 7,  # ..., const int dims[9], stream
    "downsample_nhwc_bf16": [_P] * 7,  # the same, w bf16
    "downsample_nhwc_bf16act": [_P] * 7,  # the same, x, w and out bf16
    "cg_pressure_f32": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    "cg_cluster_occupancy": [_I, _I, _I, _P],
    "cg_barrier_probe": [_I, _I, _P, _P],
    "group_norm_act_f32": [_P] * 7 + [_F, _P],  # ..., const int dims[6], eps, stream
    "group_norm_act_bf16act": [_P] * 7 + [_F, _P],  # the same, x, ss, res and out bf16
    # tests: y, scale, shift, res, flags, n, fast, exact, stream (n vectors of 8 bf16)
    "group_norm_bf16act_update_check": [_P] * 4 + [_I, _I] + [_P] * 3,
    "group_norm_bf16act_exp_ulps": [_P] * 3,  # out (device), guard (host), stream
    "linear_attention_tc_f32": [_P] * 10,  # ..., const int dims[7], stream
    "linear_attention_tc_bf16": [_P] * 10,  # the same, wqkv and wo bf16
    "attention_f32": [_P] * 9,  # ..., scratch, const int dims[4], stream
    "attention_bf16": [_P] * 9,  # the same, wqkv and wo bf16
    # x, norm_g, wqkv, wo, bo, out_g, scratch, out, const int dims[7], stream; bf16 x, out
    "linear_attention_bf16act": [_P] * 10,
    "attention_bf16act": [_P] * 9,  # x, norm_g, wqkv, wo, bo, out, scratch, dims[3], stream
    "unet2d_persistent_f32": [_P, _I, _P, _I, _P, _P],  # ..., n_counters, grid_out, stream
    "unet2d_persistent_bf16": [_P, _I, _P, _I, _P, _P, _P],  # the same, bf16; ..., maps
    "unet2d_persistent_maps": [_P, _I, _P, _P, _P],  # specs, n_maps, bases, maps, stream
    "unet2d_persistent_grid": [_P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    cus, hdrs = _sources()
    for p in cus + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(nvcc on PATH or under /usr/local/cuda/bin)")


def build(defines: tuple[str, ...] = (), only: tuple[str, ...] = ()) -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library path. ``defines`` (macro names passed as ``-D``) build a
    variant into a directory of its own, for diagnostic tools; ``only``
    (``.cu`` file names) builds that variant from those sources alone."""
    out_dir = BUILD_ROOT / "-".join((source_hash(), *defines, *only))
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    cus = [cu for cu in _sources()[0] if not only or cu.name in only]
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT))
    try:
        procs = []
        for cu in cus:
            obj = tmp / (cu.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *(f"-D{d}" for d in defines), "-std=c++17", "-O3",
                   "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c", str(cu), "-o", str(obj)]
            procs.append((cu, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for cu, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {cu.name}\n{out}")
            if proc.returncode != 0:
                failed.append(cu.name)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                               + "\n".join(logs))
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout)
        (tmp / "ptxas.log").write_text("\n".join(logs))
        try:
            os.replace(tmp, out_dir)  # atomic; a concurrent build may have won
        except OSError:
            if not lib.exists():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
