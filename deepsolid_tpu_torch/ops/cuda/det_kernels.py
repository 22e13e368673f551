"""Batched complex Gauss-Jordan inverse + slogdet: CUDA kernel and plain version.

Counterpart of deepsolid_tpu/ops/pallas/det_kernels.py. The source
(csrc/gj_inverse.cu) holds five complex64 kernel bodies, chosen by the
matrix size alone (`variant`, which asks the library's gj_body): four
keep a matrix in registers, "warp" (n <= 32, one lane per row, two
matrices per warp for n <= 16), "registers" (n = 48, one warp per matrix),
"mid" (49 <= n <= 96, a block of 8 warps per matrix) and "mid, wide"
(97 <= n <= 128, the same with 8 x 8 entries a lane); "shared" keeps
it in the shared memory of one block, for any other size up to the
card's shared-memory limit. complex128 (precision='float64') has the
same four bodies in double, chosen by n alone (`variant_c128`, which asks
gj_body_c128): "warp, complex128" (n <= 32), "registers, complex128" (n
= 48, two warps per matrix), "mid, complex128" (49 <= n <= 96, one block
per SM) and the shared-memory body in double at every other n it fits
(n <= 118 on an H100). Every leading batch axis (walkers x determinants) goes into
one launch. The plain PyTorch version performs the same elimination with
the same pivot rule, vectorised over the batch, in either type; the
wrapper takes it only for tensors on the CPU.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Tuple

import torch

from deepsolid_tpu_torch.ops.cuda import build
from deepsolid_tpu_torch.utils import profiling

# the kernel bodies by the code gj_body returns
BODIES = ("shared", "warp", "registers", "mid", "mid, wide")
# the complex128 bodies by the code gj_body_c128 returns: the
# shared-memory one in double, the register one at n = 48, the warp one at
# n <= 32 and the mid one at 49-96
BODY_C128 = "shared, complex128"
BODY_C128_REGISTERS = "registers, complex128"
BODY_C128_WARP = "warp, complex128"
BODY_C128_MID = "mid, complex128"
BODIES_C128 = (BODY_C128, BODY_C128_REGISTERS, BODY_C128_WARP, BODY_C128_MID)
# launches by (kernel, (matrices, n, n), variant): every launch, counted once
SHAPES = collections.Counter()

_P = ctypes.c_void_p
_SIGNATURES = {
    "gj_inverse_slogdet_launch": (
        ctypes.c_int, [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P]),
    "gj_body": (ctypes.c_int, [ctypes.c_int]),
    "gj_smem_bytes": (ctypes.c_longlong, [ctypes.c_int]),
    "gj_max_smem_optin": (ctypes.c_int, [ctypes.c_int]),
    "gj_inverse_slogdet_launch_c128": (
        ctypes.c_int, [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P]),
    "gj_smem_bytes_c128": (ctypes.c_longlong, [ctypes.c_int]),
    "gj_body_c128": (ctypes.c_int, [ctypes.c_int]),
}
_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}


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


def _fits(lib, n, need, device):
    if need:
        limit = lib.gj_max_smem_optin(device.index or 0)
        if need > limit:
            raise ValueError(
                f"{n}x{n} matrices need {need} bytes of shared memory per block; "
                f"this card allows {limit}. Larger matrices are not supported.")


def variant(lib, n: int, device: torch.device) -> str:
    """Which complex64 kernel body serves n x n matrices, by n alone (one
    of BODIES); raises for a size whose body needs more shared memory than
    the card allows a block."""
    body = BODIES[lib.gj_body(n)]
    _fits(lib, n, lib.gj_smem_bytes(n), device)
    return body


def variant_c128(lib, n: int, device: torch.device) -> str:
    """Which complex128 body serves n x n matrices, by n alone (one of
    BODIES_C128); raises, as `variant` does, where the matrix does not fit
    a block's shared memory."""
    body = BODIES_C128[lib.gj_body_c128(n)]
    _fits(lib, n, lib.gj_smem_bytes_c128(n), device)
    return body


def launcher(lib, dtype, n: int, device: torch.device):
    """(body, the library's launch entry) for n x n matrices of `dtype`:
    complex64 takes the body `variant` names, complex128 the one
    `variant_c128` names (each launcher branches on n the same way)."""
    if dtype == torch.complex128:
        return variant_c128(lib, n, device), lib.gj_inverse_slogdet_launch_c128
    return variant(lib, n, device), lib.gj_inverse_slogdet_launch


def _gj_cuda(a: torch.Tensor):
    # one wrapper call, from its checks to its count: the host's cost
    with profiling.annotate("op.gj_inverse_slogdet"):
        if a.device.type != "cuda":
            raise ValueError(f"gj_inverse_slogdet kernel needs a CUDA tensor, "
                             f"got device {a.device}")
        if a.dtype not in _REAL:
            raise TypeError(f"gj_inverse_slogdet kernel takes complex64 or complex128, "
                            f"got {a.dtype}")
        if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
            raise ValueError(f"expected (..., n, n) matrices, got {tuple(a.shape)}")
        lib = _lib()
        n = a.shape[-1]
        body, launch = launcher(lib, a.dtype, n, a.device)
        lead = a.shape[:-2]
        a2 = a.reshape(-1, n, n).contiguous()  # copies only a strided input
        nb = a2.shape[0]
        ainv = torch.empty_like(a2)
        sign = torch.empty(nb, dtype=a.dtype, device=a.device)
        logdet = torch.empty(nb, dtype=_REAL[a.dtype], device=a.device)
        if nb:
            with torch.cuda.device(a.device):
                stream = torch.cuda.current_stream(a.device).cuda_stream
                code = launch(
                    a2.data_ptr(), ainv.data_ptr(), sign.data_ptr(),
                    logdet.data_ptr(), nb, n, stream)
            build.check(lib, code, "gj_inverse_slogdet")
            SHAPES["gj_inverse_slogdet", (nb, n, n), body] += 1
        return ainv.reshape(a.shape), sign.reshape(lead), logdet.reshape(lead)


def gj_inverse_slogdet(a: torch.Tensor):
    """(A^-1, sign, log|det|) of (..., n, n) complex matrices.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (complex64 or complex128) or raise.
    """
    if a.device.type == "cpu":
        return gj_inverse_slogdet_plain(a)
    return _gj_cuda(a)
