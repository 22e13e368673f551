"""Device selection, the float32 matmul policy, and device constants."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=512)
def _constant(data: bytes, shape, np_dtype: str, dtype, device) -> torch.Tensor:
    arr = np.frombuffer(data, dtype=np_dtype).reshape(shape)
    return torch.tensor(arr, dtype=dtype, device=device)


def constant(a, like: torch.Tensor) -> torch.Tensor:
    """Host array `a` as a tensor with like's dtype and device.

    Each distinct value is uploaded once per (dtype, device) and reused:
    a copy from pageable host memory synchronizes the GPU stream, so
    re-uploading lattice vectors or k-points on every call would stall
    the card between its kernels. Callers must not modify the result.
    """
    if isinstance(a, torch.Tensor):
        return a.to(dtype=like.dtype, device=like.device)
    arr = np.ascontiguousarray(a)
    return _constant(arr.tobytes(), arr.shape, arr.dtype.str, like.dtype, like.device)


def rank_device(local_rank: int, device_count: int) -> torch.device:
    """The GPU of the rank `local_rank` on a host with `device_count`
    GPUs: ranks take the cards in turn, so each rank owns one where there
    are enough, and ranks beyond the count share (two ranks on a one-GPU
    host both land on cuda:0)."""
    return torch.device("cuda", local_rank % device_count)


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.

    Entry points default to 'cuda'; asking for it without a visible GPU
    raises instead of quietly running on the CPU. Tests pass 'cpu'. A
    'cuda' without an index is the current card: a rank that
    `parallel.run_ranks` started has already made its own card
    (`rank_device`) current.
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was requested but no CUDA GPU is available; "
                "pass device='cpu' to run on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def set_full_precision() -> None:
    """Full-float32 matmuls: no TF32 anywhere.

    The reference measured a -3.7 mHa/atom kinetic-energy bias with
    3-pass TF32-class products and +0.200 Ha/atom with 1-pass bf16
    (deepsolid_tpu/config.py, matmul_precision); only full f32 is safe.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
