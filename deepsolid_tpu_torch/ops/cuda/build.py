"""Builds the hand-written CUDA kernels and loads them with ctypes.

Each source in csrc/ compiles with nvcc into its own shared library with
a plain C interface, for sm_90a. No PyTorch header is compiled: on an
H100 machine the first two sources built in 5.6 s, where a torch/extension.h
binding alone took 33.6 s through torch.utils.cpp_extension
(time_builds.py). Device, dtype and shape checks live in the Python
wrappers, and every launcher returns cudaGetLastError() right after its
launches, which `check` turns into an exception (the role of
C10_CUDA_KERNEL_LAUNCH_CHECK). Libraries go to `_build/` beside this file,
named by a hash of their source, so an edited source rebuilds and an
unchanged one is reused. Nothing is compiled at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

HERE = Path(__file__).resolve().parent
CSRC = HERE / "csrc"
BUILD_DIR = HERE / "_build"
SOURCES = ("gj_inverse", "dense_tanh_jet", "dethead_trace")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME:
            cand = os.path.join(CUDA_HOME, "bin", "nvcc")
            path = cand if os.path.exists(cand) else None
    if path is None:
        raise RuntimeError(
            "nvcc was not found (neither on PATH nor under CUDA_HOME); the "
            "CUDA toolkit is needed to build the port's kernels"
        )
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Iterable[str] = SOURCES, ptxas_verbose: bool = False
          ) -> Tuple[float, str]:
    """Compile the named sources that are not built yet, one nvcc each,
    all started together. Returns (seconds, compiler output)."""
    start = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = list(NVCC_FLAGS) + (["-Xptxas", "-v"] if ptxas_verbose else [])
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for name, out, tmp, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"[{name}] {text.strip()}")
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    return time.perf_counter() - start, log


def resources(log: str) -> list:
    """Registers, spills and shared memory of every kernel in the output
    of a build made with `ptxas_verbose`: one dict per compiled entry
    function, named by the kernel and its template arguments as mangled."""
    out = []
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            k = re.search(r"\d+([a-z_]+_kernel)(\w*?)E(?:v|PK)", mangled)
            entry = {"kernel": k.group(1) + k.group(2) if k else mangled}
            out.append(entry)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            entry["spill_store_bytes"] = int(m.group(1))
            entry["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            entry["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def library(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use.

    `signatures` maps each exported function to (restype, argtypes).
    """
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
