"""The port stands alone: no JAX, nothing of deepsolid_tpu.

Every module of deepsolid_tpu_torch and chip_smoke.py import in a
process where `jax` and `deepsolid_tpu` cannot be imported at all.
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "deepsolid_tpu_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
sys.modules["deepsolid_tpu"] = None  # and so does the JAX package
# the port uses torch, numpy, scipy (the SCF's Gaussian integrals) and the
# standard library only
for name in ("ml_collections", "absl", "chex", "optax"):
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
import deepsolid_tpu_torch
names = [m.name for m in pkgutil.walk_packages(deepsolid_tpu_torch.__path__,
                                               "deepsolid_tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
for needed in ("deepsolid_tpu_torch.parallel", "deepsolid_tpu_torch.optim",
               "deepsolid_tpu_torch.optim.adam", "deepsolid_tpu_torch.optim.kfac",
               "deepsolid_tpu_torch.train.pretrain", "deepsolid_tpu_torch.scf.hf",
               "deepsolid_tpu_torch.scf.gto", "deepsolid_tpu_torch.scf.interface",
               "deepsolid_tpu_torch.system.poscar", "deepsolid_tpu_torch.configs.read_poscar",
               "deepsolid_tpu_torch.scf.etdz", "deepsolid_tpu_torch.cli"):
    assert needed in names, needed
print(len(names))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_every_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL.format(repo=str(REPO))],
                         capture_output=True, text=True, cwd=REPO, env=_env(),
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 51


def test_sources_name_no_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax\b|deepsolid_tpu\b(?!_torch))",
                         re.MULTILINE)
    files = list(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_no_kernel_wrapper_catches_an_exception_around_a_launch():
    """On a CUDA tensor a wrapper launches its kernel or raises: the
    wrapper modules of ops/cuda hold no `try` at all, so nothing can catch
    a failed launch and fall back, and every call of a plain version sits
    in a branch taken for CPU tensors only."""
    import ast

    modules = sorted((PACKAGE / "ops" / "cuda").glob("*_kernels.py"))
    assert len(modules) >= 2
    for path in modules:
        tree = ast.parse(path.read_text())
        assert "_launch" in path.read_text(), f"{path.name} launches no kernel"
        tries = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Try)]
        assert not tries, f"{path.name}: try/except at lines {tries}"
        guarded = {id(call) for branch in ast.walk(tree)
                   if isinstance(branch, ast.If) and "cpu" in ast.unparse(branch.test)
                   for stmt in branch.body for call in ast.walk(stmt)}
        for call in ast.walk(tree):
            if (isinstance(call, ast.Call) and isinstance(call.func, ast.Name)
                    and call.func.id.endswith("_plain")):
                assert id(call) in guarded, (
                    f"{path.name}:{call.lineno} calls {call.func.id} outside "
                    "a CPU-tensor branch")


def test_chip_smoke_fails_without_a_gpu_or_the_repo(tmp_path):
    """No GPU here: the script exits non-zero and prints no result, in the
    repository and in a directory that holds nothing but the script."""
    runs = [REPO]
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(REPO / "chip_smoke.py", alone / "chip_smoke.py")
    runs.append(alone)
    for cwd in runs:
        out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                             text=True, cwd=cwd, env=_env(), timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
