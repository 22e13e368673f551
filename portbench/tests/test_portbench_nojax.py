"""A run loads no JAX and no JAX package, and the harness reads nothing of
the JAX package's benchmark. The check compares top-level names whole:
deepsolid_tpu_torch is the port, deepsolid_tpu the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench import run

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("deepsolid_tpu_torch", "deepsolid_tpu_torch.ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not [m for m in run.forbidden_modules() if m.startswith(("deepsolid", "jaxt", "flaxe"))]
    for name in ("jax.numpy", "jaxlib", "flax", "deepsolid_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert set(run.forbidden_modules()) >= {"jax.numpy", "jaxlib", "flax", "deepsolid_tpu.ops"}


def test_sources_import_no_jax_and_read_no_jax_benchmark():
    for path in HERE.rglob("*.py"):
        text = path.read_text()
        for node in ast.walk(ast.parse(text)):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "deepsolid_tpu",
                                                  "bench", "benchmarks", "chip_smoke"), (path, name)
        if path.parent.name != "tests":
            for word in ("BENCH_r", "bench.py", "benchmarks/"):
                assert word not in text, (path, word)


def test_harness_and_port_import_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'deepsolid_tpu'): sys.modules[m] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import portbench.harness, portbench.run, portbench.calibrate\n"
        "import deepsolid_tpu_torch.train.process, deepsolid_tpu_torch.optim.kfac\n"
        "from portbench import run\n"
        "assert not run.forbidden_modules(), run.forbidden_modules()\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
