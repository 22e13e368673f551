"""The determinant head's tangent stream: CUDA kernel and plain version.

No TPU kernel stands behind it: the JAX package leaves this stream to XLA
(fl.mul_row, then slogdet_jet's product and trace contractions). The
kernel (csrc/dethead_trace.cu) takes the orbital GEMM's tangent products
of one spin channel as they leave the products, in the precision's real
type, and returns slogdet_jet's tangent outputs of the envelope-phase
product's matrices A = orb * ep without any complex copy of the orbital
Jacobian:

  J_t = complex(jr_t + jbc_t) * ep_val  (+ the slab row: orb_val0 * ep_jac3)
  trb[t] = tr(A^-1 J_t),   l2 = sum_t tr((A^-1 J_t)^2)

Layouts, for B walkers, D determinants, n electrons of the channel (= n
orbitals), P = D n, a window of T_loc tangents starting at global tangent
t0 (0 without a shard), the channel's first electron `offset`:
  jr (T_loc, B, n, 2P) real, P real parts then P imaginary ones;
  jbc (T_loc, B, 2P) real or None, the row-constant block's tangents;
  ep_val, orb_val0, a_inv (B, D, n, n) complex; ep_jac3 (3, B, D, n, n);
  trb (T_loc, B, D) complex; l2 (B, D) complex, this window's sum.
float32 products take complex64 factors, float64 complex128. The wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from deepsolid_tpu_torch.ops.cuda import build
from deepsolid_tpu_torch.utils import profiling

KERNEL = "dethead_traces"
# the kernel body by the products' dtype and dethead_tile_cols in the
# source: complex64 by the columns of a thread's tile of M_t, keeping M_t
# in a buffer of its own at 4 and 6 columns (n <= 96) and staging it over
# J_t at 8 (97 <= n <= 119); complex128 on the FP64 tensor cores (16, the
# side of a warp's blocks of M_t) at n = 46-49 and 58-84, and on FP64 FMA
# at 4 columns for the other n, where the card timed it faster
BODY_C64, BODY_C64_STAGED = "complex64", "complex64, staged"
BODY_C128_FMA, BODY_C128 = "complex128", "complex128, tensor cores"
BODIES = {(torch.float32, 4): BODY_C64, (torch.float32, 6): BODY_C64,
          (torch.float32, 8): BODY_C64_STAGED, (torch.float64, 4): BODY_C128_FMA,
          (torch.float64, 16): BODY_C128}
# launches by (kernel, (matrices, n, T_loc), body): every launch, counted once
SHAPES = collections.Counter()
# a matrix's tangents go to at most MAX_SPLITS blocks of at least
# MIN_TANGENTS_PER_BLOCK each (the split the card timed fastest; see
# csrc/dethead_trace.cu)
MAX_SPLITS = 8
MIN_TANGENTS_PER_BLOCK = 16

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "dethead_trace_launch": (_I, [_P] * 8 + [_I] * 7 + [_P]),
    "dethead_trace_launch_c128": (_I, [_P] * 8 + [_I] * 7 + [_P]),
    "dethead_max_n": (_I, [_I]),
    "dethead_tile_cols": (_I, [_I, _I]),
    "dethead_blocks_per_sm": (_I, [_I, _I]),
    "dethead_smem_bytes": (_I, [_I, _I]),
}
_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}
# largest n each products' dtype serves (dethead_max_n in the source), both
# held there by a block's shared memory
MAX_N = {torch.float32: 119, torch.float64: 84}


def slab(t0: int, t_loc: int, offset: int, rows: int, device=None):
    """The tangents of the window [t0, t0 + t_loc) that move an electron of
    the channel [offset, offset + rows): (tangent index in the window, row,
    Cartesian component), each a tensor of one entry per such tangent, in
    the order of the global tangents."""
    lo = max(3 * offset, t0)
    hi = max(lo, min(3 * (offset + rows), t0 + t_loc))  # lo == hi: no overlap
    g = torch.arange(lo, hi, device=device)
    return g - t0, g // 3 - offset, g % 3


def dethead_traces_plain(jr, jbc, ep_val, ep_jac3, orb_val0, a_inv, offset, t0):
    """(trb, l2) of the channel's matrices; see the module docstring."""
    t_loc, batch, n, two_p = jr.shape
    ndet, p = ep_val.shape[1], two_p // 2
    if jbc is not None:
        jr = jr + jbc[:, :, None, :]
    jc = torch.complex(jr[..., :p], jr[..., p:])
    # (T, B, n, D n) -> (T, B, D, n, n)
    jac = jc.unflatten(-1, (ndet, n)).transpose(2, 3) * ep_val
    tl, i, c = slab(t0, t_loc, offset, n, jr.device)
    jac[tl, :, :, i, :] = (jac[tl, :, :, i, :]
                           + orb_val0[:, :, i, :].permute(2, 0, 1, 3) * ep_jac3[c, :, :, i, :])
    m = a_inv @ jac
    trb = torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)
    l2 = torch.sum(m * m.transpose(-1, -2), dim=(-1, -2)).sum(0)
    return trb, l2


def _lib():
    return build.library("dethead_trace", _SIGNATURES)


def body(n: int, dtype: torch.dtype) -> str:
    """The body that launches for n x n matrices with `dtype` products (one
    of BODIES), as the library's dispatch picks it."""
    return BODIES[dtype, _lib().dethead_tile_cols(n, int(dtype == torch.float64))]


def occupancy(n: int, dtype: torch.dtype) -> dict:
    """The body n takes with `dtype` products on the current card: its
    dynamic shared memory a block and the blocks that fit an SM."""
    lib, is_double = _lib(), int(dtype == torch.float64)
    return {"smem_bytes": lib.dethead_smem_bytes(n, is_double),
            "blocks_per_sm": lib.dethead_blocks_per_sm(n, is_double)}


def splits(t_loc: int) -> int:
    """Blocks a matrix's t_loc tangents are split over: up to MAX_SPLITS,
    each keeping at least MIN_TANGENTS_PER_BLOCK; never an empty block."""
    s = max(1, min(MAX_SPLITS, t_loc // MIN_TANGENTS_PER_BLOCK))
    per = -(-t_loc // s)
    return -(-t_loc // per)


def serves(n: int, dtype: torch.dtype, device: torch.device) -> bool:
    """Whether `dethead_traces` takes one channel's n x n matrices whose
    products are of `dtype` on `device`: always on the CPU (the plain
    version); on the card for float32 or float64 up to MAX_N."""
    if device.type == "cpu":
        return True
    return dtype in MAX_N and n <= MAX_N[dtype]


def _check(jr, jbc, ep_val, ep_jac3, orb_val0, a_inv):
    named = dict(jr=jr, ep_val=ep_val, ep_jac3=ep_jac3, orb_val0=orb_val0, a_inv=a_inv)
    if jbc is not None:
        named["jbc"] = jbc
    for key, x in named.items():
        if x.device.type != "cuda":
            raise ValueError(f"{KERNEL} kernel needs CUDA tensors; {key} is on {x.device}")
        if x.device != jr.device:
            raise ValueError(f"{KERNEL} kernel takes one device; {key} is on {x.device}, "
                             f"jr on {jr.device}")
    if jr.dtype not in _COMPLEX:
        raise TypeError(f"{KERNEL} kernel takes float32 or float64 products; jr is {jr.dtype}")
    if jbc is not None and jbc.dtype != jr.dtype:
        raise TypeError(f"{KERNEL} kernel: jbc is {jbc.dtype}, jr {jr.dtype}")
    want = _COMPLEX[jr.dtype]
    for key in ("ep_val", "ep_jac3", "orb_val0", "a_inv"):
        if named[key].dtype != want:
            raise TypeError(f"{KERNEL} kernel: {key} must be {want} beside {jr.dtype} "
                            f"products, got {named[key].dtype}")
    if jr.ndim != 4:
        raise ValueError(f"{KERNEL} kernel: jr must be (T_loc, B, n, 2P), got {tuple(jr.shape)}")
    t_loc, batch, n, two_p = jr.shape
    ndet = ep_val.shape[1] if ep_val.ndim == 4 else 0
    mat = (batch, ndet, n, n)
    if ndet < 1 or two_p != 2 * ndet * n or ep_val.shape != mat:
        raise ValueError(f"{KERNEL} kernel: ep_val must be (B, D, n, n) with jr's "
                         f"last axis 2 D n; got jr {tuple(jr.shape)}, ep_val "
                         f"{tuple(ep_val.shape)}")
    for key in ("orb_val0", "a_inv"):
        if named[key].shape != mat:
            raise ValueError(f"{KERNEL} kernel: {key} must be {mat}, got "
                             f"{tuple(named[key].shape)}")
    if ep_jac3.shape != (3,) + mat:
        raise ValueError(f"{KERNEL} kernel: ep_jac3 must be {(3,) + mat}, got "
                         f"{tuple(ep_jac3.shape)}")
    if jbc is not None and jbc.shape != (t_loc, batch, two_p):
        raise ValueError(f"{KERNEL} kernel: jbc must be {(t_loc, batch, two_p)}, got "
                         f"{tuple(jbc.shape)}")
    if n > MAX_N[jr.dtype]:
        raise ValueError(f"{KERNEL} kernel serves n <= {MAX_N[jr.dtype]} with "
                         f"{jr.dtype} products, got n = {n}")


def _cuda(jr, jbc, ep_val, ep_jac3, orb_val0, a_inv, offset, t0):
    # one wrapper call, from its checks to its count: the host's cost
    with profiling.annotate("op." + KERNEL):
        _check(jr, jbc, ep_val, ep_jac3, orb_val0, a_inv)
        t_loc, batch, n, _ = jr.shape
        ndet = ep_val.shape[1]
        matrices = batch * ndet
        cdtype = ep_val.dtype
        trb = torch.empty((t_loc, batch, ndet), dtype=cdtype, device=jr.device)
        if t_loc == 0 or matrices == 0:
            return trb, torch.zeros((batch, ndet), dtype=cdtype, device=jr.device)
        # the kernel reads every tensor dense and row-major; the factors
        # arrive as transposed views and are small beside jr
        jr, ep_val, ep_jac3, orb_val0, a_inv = (
            x.contiguous() for x in (jr, ep_val, ep_jac3, orb_val0, a_inv))
        jbc = None if jbc is None else jbc.contiguous()
        lib = _lib()
        s = splits(t_loc)
        l2_part = torch.empty((s, batch, ndet), dtype=cdtype, device=jr.device)
        entry = (lib.dethead_trace_launch_c128 if jr.dtype == torch.float64
                 else lib.dethead_trace_launch)
        with torch.cuda.device(jr.device):
            stream = torch.cuda.current_stream(jr.device).cuda_stream
            code = entry(jr.data_ptr(), None if jbc is None else jbc.data_ptr(),
                         ep_val.data_ptr(), ep_jac3.data_ptr(), orb_val0.data_ptr(),
                         a_inv.data_ptr(), trb.data_ptr(), l2_part.data_ptr(),
                         n, ndet, batch, t_loc, s, offset, t0, stream)
        build.check(lib, code, KERNEL)
        SHAPES[KERNEL, (matrices, n, t_loc), body(n, jr.dtype)] += 1
        # the split's partial sums, closed in a fixed order
        return trb, (l2_part[0] if s == 1 else l2_part.sum(0))


def dethead_traces(jr, jbc, ep_val, ep_jac3, orb_val0, a_inv, offset: int, t0: int):
    """(trb (T_loc, B, D), l2 (B, D)) of one spin channel's determinant
    head; see the module docstring.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if jr.device.type == "cpu":
        return dethead_traces_plain(jr, jbc, ep_val, ep_jac3, orb_val0, a_inv, offset, t0)
    return _cuda(jr, jbc, ep_val, ep_jac3, orb_val0, a_inv, offset, t0)
