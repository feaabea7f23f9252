#!/usr/bin/env python
"""Where a kernel's register spills are, on a machine with the CUDA
toolkit: one ``csrc/*.cu`` compiled to a cubin with the library's flags
plus ``-lineinfo``, disassembled with ``nvdisasm``, and the local-memory
loads and stores (``LDL``, ``STL``: ptxas's spills and the stack frame) of
each function counted by the source line they come from (the innermost
file and line of the line table, so an inlined body's lines count as that
body's).

``ptxas -v`` says how many bytes a function spills; this says where, so
that a spill on a hot loop (a conv tile's ring) can be told from one on a
cold path (a stage's setup).

Prints one JSON line per function whose name contains ``--function`` (and
``--instance``, e.g. ``13__nv_bfloat16``): its LDL and STL instruction
counts and the ``--top`` source lines by count.

Run from the repository root:
``python3 -m diffphycon_tpu_torch.tools.ptxas_spills [--source unet2d_persistent_bf16.cu]
[--function persistent_kernel] [--instance NAME] [--top 30]``.
"""

import argparse
import collections
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from diffphycon_tpu_torch.kernels import _build

_FUNC = re.compile(r"^\s*(?:\.section\s+)?\.text\.([^,:\s]+)[,:]")
_LINE = re.compile(r'//## File "([^"]+)", line (\d+)')
_LOCAL = re.compile(r"\b(LDL|STL)(\.[A-Z0-9.]+)?\s")


def spills(disasm: str, function: str, instance: str, top: int):
    """Per matching function: LDL / STL counts and the top source lines."""
    out, cur, where = {}, None, "?"
    for line in disasm.splitlines():
        m = _FUNC.match(line)
        if m:
            name = m.group(1)
            cur = name if function in name and instance in name else None
            if cur is not None:
                out[cur] = {"LDL": 0, "STL": 0, "lines": collections.Counter()}
            where = "?"
            continue
        if cur is None:
            continue
        m = _LINE.search(line)
        if m:
            where = f"{Path(m.group(1)).name}:{m.group(2)}"
            continue
        m = _LOCAL.search(line)
        if m:
            out[cur][m.group(1)] += 1
            out[cur]["lines"][where] += 1
    return [{"function": name, "LDL": r["LDL"], "STL": r["STL"],
             "top_lines": r["lines"].most_common(top)} for name, r in out.items()]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default="unet2d_persistent_bf16.cu")
    ap.add_argument("--function", default="persistent_kernel")
    ap.add_argument("--instance", default="")
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args()
    nvcc = _build._nvcc()
    nvdisasm = str(Path(nvcc).with_name("nvdisasm"))
    src = _build.CSRC / args.source
    _build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
        cubin = Path(tmp) / "k.cubin"
        subprocess.run([nvcc, *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-lineinfo", "-cubin",
                        str(src), "-o", str(cubin)], check=True)
        disasm = subprocess.run([nvdisasm, "-g", "-c", str(cubin)], check=True,
                                capture_output=True, text=True).stdout
    for row in spills(disasm, args.function, args.instance, args.top):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
