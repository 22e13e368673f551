"""Native (C++) kernels for host-side SCF setup hot spots.

The same C++ as deepsolid_tpu/native (the short-range ERI quartet engine
and the pair-FT moment table), compiled with g++ on first use into
deepsolid_tpu_torch/native/_build/ (named by a hash of the source) and
loaded with ctypes. The numpy implementations in scf/eri.py and
scf/hf.py stay the fallback: a failed compile never breaks the Python
path. Host code only; nothing here runs on the GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

_LIB = None
_TRIED = False


def _source_path(name: str = "sr_eri") -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), f"{name}.cpp")


def _build(name: str = "sr_eri") -> str:
    src = _source_path(name)
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"{name}_{tag}.so")
    if os.path.exists(out):
        return out
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    flags = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17"]
    # -march=native vectorizes the image-lane FMAs of the quartet
    # contraction; the library is built on the machine that loads it.
    # Toolchains without OpenMP or -march support take the next set.
    try:
        for extra in (["-march=native", "-fopenmp"], ["-fopenmp"],
                      ["-march=native"], []):
            try:
                subprocess.run(flags + extra + [src, "-o", tmp], check=True,
                               capture_output=True)
                break
            except subprocess.CalledProcessError:
                if not extra:
                    raise
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load():
    """ctypes handle to the short-range ERI library, or None if it does
    not build here."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(_build())
        d = ctypes.POINTER(ctypes.c_double)
        i32 = ctypes.POINTER(ctypes.c_int32)
        lib.sr_eri_block.restype = ctypes.c_int
        lib.sr_eri_block.argtypes = [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, d, d, d, d, d, d,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, d, d, d, d, d, d,
            ctypes.c_int64, d, ctypes.c_int64, d,
            ctypes.c_double, ctypes.c_double, d, d,
        ]
        lib.sr_eri_block2.restype = ctypes.c_int
        lib.sr_eri_block2.argtypes = [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, d, d, d, d, i32, d,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, d, d, d, d, i32, d,
            ctypes.c_int64, d, i32, ctypes.c_int64, d, d,
            ctypes.c_double, ctypes.c_double, d, d,
        ]
        _LIB = lib
    except Exception as e:  # noqa: BLE001 — the numpy path takes over
        logging.info("native sr_eri unavailable (%s); using numpy path", e)
        _LIB = None
    return _LIB


_PAIR_FT = None
_PAIR_FT_TRIED = False


def load_pair_ft():
    """ctypes handle to the pair-FT moment-table library, or None."""
    global _PAIR_FT, _PAIR_FT_TRIED
    if _PAIR_FT_TRIED:
        return _PAIR_FT
    _PAIR_FT_TRIED = True
    try:
        lib = ctypes.CDLL(_build("pair_ft"))
        d = ctypes.POINTER(ctypes.c_double)
        lib.pair_ft_r_table.restype = ctypes.c_int
        lib.pair_ft_r_table.argtypes = [
            ctypes.c_int, ctypes.c_int, d, d, d, d, ctypes.c_int64,
            d, d, d, ctypes.c_int64,
            ctypes.c_int, ctypes.c_double, d, d,
        ]
        _PAIR_FT = lib
    except Exception as e:  # noqa: BLE001 — the numpy path takes over
        logging.info("native pair_ft unavailable (%s); using numpy path", e)
        _PAIR_FT = None
    return _PAIR_FT
