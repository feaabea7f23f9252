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
    "conv2d_nhwc_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "downsample_nhwc_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "cg_pressure_f32": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "linear_attention_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "attention_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
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


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library path."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT))
    try:
        procs = []
        for cu in cus:
            obj = tmp / (cu.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-c", str(cu), "-o", str(obj)]
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
