"""What the benchmark loads: the port and never JAX or the JAX package; the
reference nothing of the port; no result without a card or without the
program."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import harness

PB = Path(harness.__file__).resolve().parent
ROOT = PB.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "diffphycon_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_and_the_reference_no_port():
    for path in PB.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path
    for path in (PB / "reference").glob("*.py"):
        assert "diffphycon_tpu_torch" not in set(_imports(path)), path


def test_forbidden_modules_compare_whole_top_level_names():
    sys.modules.setdefault("diffphycon_tpu_torch_probe", type(sys)("x"))
    assert "diffphycon_tpu_torch_probe" not in harness.forbidden_modules()


def _python(code, cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_tiny_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, 'portbench/tests');"
            "from tiny import tiny_run; from portbench import harness;"
            "run, res = tiny_run('burgers-guided-ddpm-b50');"
            "print(harness.forbidden_modules(), res['correct'])")
    out = _python(code, ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("[] True")


def test_no_result_without_a_card():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "burgers-guided-ddpm-b50", "--seed", "3000000001", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, 'portbench/tests');"
            "from tiny import tiny_run; tiny_run('burgers-guided-ddpm-b50')")
    out = _python(code, tmp_path)
    assert out.returncode != 0 and "diffphycon_tpu_torch" in out.stderr
