"""ctypes wrapper of the native threaded .npy / .npz batch loader
(``native/io/npy_loader.cc``): a pthread pool that parses the headers and
reads or inflates a batch of same-shaped files into one float32 buffer.

The library is built with ``g++ -O3 -shared -fPIC -std=c++17 ... -lz
-lpthread`` at first use into ``build/diffphycon_tpu_torch/native_io/<hash
of the source>/`` at the checkout root (nothing happens at import). A build
that fails raises with the command; a file the loader cannot read raises
too (no fallback to numpy).
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
from typing import Optional, Sequence

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "io" / "npy_loader.cc"
BUILD_ROOT = REPO / "build" / "diffphycon_tpu_torch" / "native_io"
LIB_NAME = "libdiffphycon_io.so"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LINK_FLAGS = ["-lz", "-lpthread"]
# npy dtype codes of the loader's header parser
DTYPES = {1: np.float32, 2: np.float64, 3: np.int64, 4: np.float16}


def build() -> Path:
    """Compile the loader if this source has no library yet; its path."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native loader is built with g++")
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT))
    try:
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp / LIB_NAME), str(SOURCE), *LINK_FLAGS]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the native loader failed: {' '.join(cmd)}\n"
                               + proc.stdout)
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
    """Build (once per source) and load the loader."""
    lib = ctypes.CDLL(str(build()))
    lib.dpc_npy_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                                 ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.dpc_load_npy_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                       ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_long]
    lib.dpc_load_npz_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_char_p,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_float), ctypes.c_long]
    for fn in (lib.dpc_npy_info, lib.dpc_load_npy_batch, lib.dpc_load_npz_batch):
        fn.restype = ctypes.c_int
    return lib


def npy_info(path) -> tuple:
    """(shape tuple, numpy dtype) of an .npy file from its header."""
    shape = (ctypes.c_long * 8)()
    ndim, code = ctypes.c_int(), ctypes.c_int()
    rc = load_library().dpc_npy_info(str(path).encode(), shape, ctypes.byref(ndim),
                                     ctypes.byref(code))
    if rc != 0:
        raise OSError(f"native loader: cannot read the .npy header of {path} (code {rc})")
    return tuple(shape[: ndim.value]), DTYPES[code.value]


def _batch(fn, paths: Sequence, extra: tuple, shape, n_threads: Optional[int]) -> np.ndarray:
    n = len(paths)
    out = np.empty((n,) + tuple(shape), np.float32)
    encoded = [str(p).encode() for p in paths]  # kept alive across the call
    c_paths = (ctypes.c_char_p * n)(*encoded)
    threads = n_threads or min(os.cpu_count() or 8, 16)
    rc = fn(c_paths, *extra, n, threads, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            int(np.prod(shape)))
    if rc != 0:
        raise OSError(f"native loader failed (code {rc}) on a batch of {n} files "
                      f"starting with {paths[0]}: a file is missing, of another shape, "
                      "or in a layout the loader does not read (Fortran order)")
    return out


def load_npy_batch(paths: Sequence, shape, n_threads: Optional[int] = None) -> np.ndarray:
    """N same-shaped .npy files -> one (N, *shape) float32 array."""
    return _batch(load_library().dpc_load_npy_batch, paths, (), shape, n_threads)


def load_npz_batch(paths: Sequence, member: str, shape,
                   n_threads: Optional[int] = None) -> np.ndarray:
    """Member ``member`` of N same-shaped .npz archives (stored or deflated)
    -> one (N, *shape) float32 array."""
    return _batch(load_library().dpc_load_npz_batch, paths, (member.encode(),), shape,
                  n_threads)
