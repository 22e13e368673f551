"""Batched complex Gauss-Jordan inverse + slogdet: CUDA kernel and plain version.

Counterpart of deepsolid_tpu/ops/pallas/det_kernels.py. The source
(csrc/gj_inverse.cu) holds two kernels, chosen by the matrix size alone
(`variant`): one that keeps a matrix in the registers of one warp, for
the sizes it is instantiated for, and one that keeps it in the shared
memory of one block, for any other size up to the card's shared-memory
limit. Every leading batch axis (walkers x determinants) goes into one
launch. The plain PyTorch version performs the same elimination with the
same pivot rule, vectorised over the batch; the wrapper takes it only
for tensors on the CPU.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Tuple

import torch

from deepsolid_tpu_torch.ops.cuda import build

LAUNCHES = {"gj_inverse_slogdet": 0}
# launches by (kernel, (matrices, n, n), variant), counted beside LAUNCHES
SHAPES = collections.Counter()

_P = ctypes.c_void_p
_SIGNATURES = {
    "gj_inverse_slogdet_launch": (
        ctypes.c_int, [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P]),
    "gj_uses_registers": (ctypes.c_int, [ctypes.c_int]),
    "gj_smem_bytes": (ctypes.c_longlong, [ctypes.c_int]),
    "gj_max_smem_optin": (ctypes.c_int, [ctypes.c_int]),
}


def gj_inverse_slogdet_plain(a: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(A^-1, sign, log|det|) of (..., n, n) complex matrices.

    In-place Gauss-Jordan with partial pivoting: the pivot is the largest
    |A[r, k]|^2 among rows r >= k, the first such row on a tie; column k
    keeps the multipliers and the columns are unscrambled at the end.
    """
    lead, n = a.shape[:-2], a.shape[-1]
    m = a.reshape(-1, n, n).clone()
    nb = m.shape[0]
    rows = torch.arange(nb, device=a.device)
    logdet = torch.zeros(nb, dtype=a.real.dtype, device=a.device)
    sign = torch.ones(nb, dtype=a.dtype, device=a.device)
    perm = []
    for k in range(n):
        colk = m[:, k:, k]
        p = k + torch.argmax(colk.real**2 + colk.imag**2, dim=1)
        piv = m[rows, p, k]
        den = piv.real**2 + piv.imag**2
        swap = torch.where(p == k, 1.0, -1.0).to(den.dtype)
        sign = sign * piv * (torch.rsqrt(den) * swap)
        logdet = logdet + 0.5 * torch.log(den)
        inv_den = 1.0 / den
        d = torch.complex(piv.real * inv_den, -piv.imag * inv_den)
        rowk = m[:, k].clone()
        m[:, k] = m[rows, p]
        m[rows, p] = rowk
        f = m[:, :, k].clone()
        prow = m[:, k] * d[:, None]
        m = m - f[:, :, None] * prow[:, None, :]
        m[:, k] = prow
        m[:, :, k] = -f * d[:, None]
        m[:, k, k] = d
        perm.append(p)
    for j in reversed(range(n)):
        q = perm[j]
        colj = m[:, :, j].clone()
        m[:, :, j] = m[rows, :, q]
        m[rows, :, q] = colj
    return m.reshape(a.shape), sign.reshape(lead), logdet.reshape(lead)


def _lib():
    return build.library("gj_inverse", _SIGNATURES)


def variant(lib, n: int, device: torch.device) -> str:
    """Which kernel serves n x n matrices, by n alone: "registers" for a
    size the register kernel is instantiated for, else "shared", which
    raises for a matrix that does not fit the card's shared memory."""
    if lib.gj_uses_registers(n):
        return "registers"
    need = lib.gj_smem_bytes(n)
    limit = lib.gj_max_smem_optin(device.index or 0)
    if need > limit:
        raise ValueError(
            f"{n}x{n} matrices need {need} bytes of shared memory per block; "
            f"this card allows {limit}. Larger matrices are not supported.")
    return "shared"


def _gj_cuda(a: torch.Tensor):
    if a.device.type != "cuda":
        raise ValueError(f"gj_inverse_slogdet kernel needs a CUDA tensor, "
                         f"got device {a.device}")
    if a.dtype != torch.complex64:
        raise TypeError(f"gj_inverse_slogdet kernel takes complex64, got {a.dtype}")
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (..., n, n) matrices, got {tuple(a.shape)}")
    lib = _lib()
    n = a.shape[-1]
    body = variant(lib, n, a.device)  # the launcher takes the same branch by n
    lead = a.shape[:-2]
    a2 = a.reshape(-1, n, n).contiguous()  # copies only a strided input
    nb = a2.shape[0]
    ainv = torch.empty_like(a2)
    sign = torch.empty(nb, dtype=torch.complex64, device=a.device)
    logdet = torch.empty(nb, dtype=torch.float32, device=a.device)
    if nb:
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            code = lib.gj_inverse_slogdet_launch(
                a2.data_ptr(), ainv.data_ptr(), sign.data_ptr(),
                logdet.data_ptr(), nb, n, stream)
        build.check(lib, code, "gj_inverse_slogdet")
        LAUNCHES["gj_inverse_slogdet"] += 1
        SHAPES["gj_inverse_slogdet", (nb, n, n), body] += 1
    return ainv.reshape(a.shape), sign.reshape(lead), logdet.reshape(lead)


def gj_inverse_slogdet(a: torch.Tensor):
    """(A^-1, sign, log|det|) of (..., n, n) complex matrices.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (complex64 only) or raise.
    """
    if a.device.type == "cpu":
        return gj_inverse_slogdet_plain(a)
    return _gj_cuda(a)
