"""Forward-Laplacian jet algebra.

Mirrors deepsolid_tpu/ops/fwdlap.py. A jet carries (value, Jacobian,
Laplacian) through the network in one forward pass:

  val: tensor of shape S
  jac: tensor of shape (T,) + S - derivatives along T tangent directions
       (T = 3N dense, 3 electron-sparse, 6 pair-sparse)
  lap: tensor of shape S - the full Laplacian over all 3N coordinates

The port writes the walker batch out: S begins with the walker axis B
where the JAX package vmapped over walkers, so e.g. a one-electron layer
has val (B, n, f) and jac (T, B, n, f). Functions that index electron
rows say which axis holds them.

The fused dense+tanh rules (`dense_tanh`, `dense_tanh_mix`), the
determinant factorization (`det_factor`) and the determinant head's
tangent stream (`det_head_jet`) go through the kernel wrappers of
ops/cuda: the CUDA kernels on the card, their plain versions for CPU
tensors; `det_head_jet` takes the plain version on the card for matrices
past the kernel's largest n.

Tangent sharding: functions that contract over the tangent axis take
`shard` (a parallel.TangentShard, or None), the counterpart of the JAX
package's `axis_name`. With a shard, a dense jac holds this rank's
T_local = 3N / size tangents and every cross-tangent contraction is
summed over the ranks (`_tsum`); the reduced tensors keep their walker
axis.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import torch
from torch.func import jvp

from deepsolid_tpu_torch.ops.cuda import dethead_kernels, det_kernels, jet_kernels


def _tsum(x, shard=None):
    """Sum over the tangent axis, across the deriv ranks when it is
    sharded."""
    out = torch.sum(x, dim=0)
    return out if shard is None else shard.all_sum(out)


@dataclasses.dataclass(frozen=True)
class Jet:
    val: torch.Tensor
    jac: torch.Tensor  # (T,) + val.shape
    lap: torch.Tensor  # val.shape


# ---------------------------------------------------------------------------
# linear ops (same op on val/lap; applied per tangent to jac)
# ---------------------------------------------------------------------------


def linear_op(op: Callable, *jets: Jet, **kwargs) -> Jet:
    """Applies a linear op to every component; `op` must act on trailing
    axes, so the leading tangent axis of jac passes through."""
    return Jet(
        val=op(*[j.val for j in jets], **kwargs),
        jac=op(*[j.jac for j in jets], **kwargs),
        lap=op(*[j.lap for j in jets], **kwargs),
    )


def add(a: Jet, b: Jet) -> Jet:
    return Jet(a.val + b.val, a.jac + b.jac, a.lap + b.lap)


def scale(a: Jet, c) -> Jet:
    return Jet(a.val * c, a.jac * c, a.lap * c)


def _jac_axis(axis: int) -> int:
    return axis + 1 if axis >= 0 else axis


def concat(jets: Sequence[Jet], axis: int) -> Jet:
    return Jet(
        torch.cat([j.val for j in jets], dim=axis),
        torch.cat([j.jac for j in jets], dim=_jac_axis(axis)),
        torch.cat([j.lap for j in jets], dim=axis),
    )


def slice_axis(a: Jet, axis: int, start: int, stop: int) -> Jet:
    return Jet(
        a.val.narrow(axis, start, stop - start),
        a.jac.narrow(_jac_axis(axis), start, stop - start),
        a.lap.narrow(axis, start, stop - start),
    )


def mean_axis(a: Jet, axis: int, keepdims: bool = False) -> Jet:
    return Jet(
        torch.mean(a.val, dim=axis, keepdim=keepdims),
        torch.mean(a.jac, dim=_jac_axis(axis), keepdim=keepdims),
        torch.mean(a.lap, dim=axis, keepdim=keepdims),
    )


# ---------------------------------------------------------------------------
# nonlinear ops
# ---------------------------------------------------------------------------


def dense(a: Jet, w, b=None) -> Jet:
    """y = x @ w (+ b); the Jacobian is one batched matmul."""
    val = a.val @ w
    if b is not None:
        val = val + b
    return Jet(val, a.jac @ w, a.lap @ w)


def tanh(a: Jet, shard=None) -> Jet:
    t = torch.tanh(a.val)
    d = 1.0 - t * t
    dd = -2.0 * t * d
    return Jet(t, d[None] * a.jac, d * a.lap + dd * _tsum(a.jac**2, shard))


def dense_tanh(a: Jet, w, b, shard=None) -> Jet:
    """tanh(dense(.)) through the fused jet kernel (rows of every leading
    axis folded together: rows are independent and w is shared). A layer
    without a bias runs the same kernel with a zero bias. With a shard the
    open kernel returns this rank's tangent square sum, which is summed
    over the ranks before the Laplacian is closed."""
    t_dim, d_in, d_out = a.jac.shape[0], a.val.shape[-1], w.shape[-1]
    if b is None:
        b = w.new_zeros(d_out)
    lead = a.val.shape[:-1]
    flat = (a.val.reshape(-1, d_in), a.jac.reshape(t_dim, -1, d_in),
            a.lap.reshape(-1, d_in), w, b)
    if shard is None:
        v, j, l = jet_kernels.fused_dense_tanh_jet(*flat)
    else:
        v, j, lap_part, s_local = jet_kernels.fused_dense_tanh_jet_partial(*flat)
        l = jet_kernels.close_laplacian(v, lap_part, shard.all_sum(s_local))
    return Jet(v.reshape(lead + (d_out,)),
               j.reshape((t_dim,) + lead + (d_out,)),
               l.reshape(lead + (d_out,)))


def dense_mix(a_rv: Jet, a_rc: Jet, w_rv, w_rc, b=None) -> Jet:
    """y = x_rv @ w_rv + broadcast_rows(x_rc @ w_rc) (+ b).

    `a_rc` is a row-constant jet (row axis of size 1, broadcast over the
    rows of `a_rv`): its contraction costs (T, B, 1, f_rc).
    """
    val = a_rv.val @ w_rv + a_rc.val @ w_rc
    if b is not None:
        val = val + b
    return Jet(val, a_rv.jac @ w_rv + a_rc.jac @ w_rc,
               a_rv.lap @ w_rv + a_rc.lap @ w_rc)


def dense_tanh_mix(a_rv: Jet, a_rc: Jet, w_rv, w_rc, b, shard=None) -> Jet:
    """tanh(dense_mix(.)) through the fused mix kernel.

    a_rv: val (B, n, f_rv); a_rc: val (B, 1, f_rc). The row-constant
    contractions enter per walker as zbc, lbc (B, d_out) and jbc
    (T, B, d_out), without tiling the row-constant block over rows. A
    layer without a bias runs the same kernel with a zero bias. With a
    shard, T is T_local and the open kernel's square sum is summed over
    the ranks before the Laplacian is closed.
    """
    t_dim = a_rv.jac.shape[0]
    groups, n, _ = a_rv.val.shape
    d_out = w_rv.shape[-1]
    if b is None:
        b = w_rv.new_zeros(d_out)
    zbc = (a_rc.val @ w_rc).reshape(groups, d_out)
    lbc = (a_rc.lap @ w_rc).reshape(groups, d_out)
    jbc = (a_rc.jac @ w_rc).reshape(t_dim, groups, d_out)
    args = (a_rv.val, a_rv.jac, a_rv.lap, zbc, lbc, jbc, w_rv, b)
    if shard is None:
        v, j, l = jet_kernels.fused_dense_tanh_jet_mix(*args)
    else:
        v, j, lap_part, s_local = jet_kernels.fused_dense_tanh_jet_mix_partial(*args)
        l = jet_kernels.close_laplacian(v, lap_part, shard.all_sum(s_local))
    return Jet(v, j, l)


def mul_row(a: Jet, b_val, b_jac3, b_lap, n_total: int, offset: int,
            shard=None) -> Jet:
    """Product jet of a dense-tangent jet with a row-local factor.

    a.val: (B, D, rows, F), rows = electrons of one spin channel starting
    at global electron `offset`; a.jac: (T, B, D, rows, F) with T =
    3 * n_total, or with a shard this rank's window [t0, t0 + T_local) of
    those tangents. Row i of b depends on r_{offset+i} only: b_val, b_lap
    (B, D, rows, F) and b_jac3 (3, B, D, rows, F) = db/dr_row. Only the 3
    tangents of electron offset+i touch row i through b, so that
    correction lands on a slab of the tangent axis (global tangents
    3*offset .. 3*(offset+rows)), diagonal in (tangent electron, row).

    The slab meets a rank's window in a range that may begin or end
    inside an electron's three tangents, so it is walked tangent by
    tangent: global tangent g touches row g // 3 - offset through
    component g % 3. Tangents outside the window belong to other ranks,
    and the cross term is summed over the ranks.
    """
    rows, t_loc = a.val.shape[-2], a.jac.shape[0]
    t0 = 0 if shard is None else shard.t0(t_loc)
    tl, i, c = dethead_kernels.slab(t0, t_loc, offset, rows, a.val.device)
    bj = b_jac3[c, :, :, i, :]  # (len, B, D, F)
    cross = _row_cross(a.jac[tl, :, :, i, :] * bj, max(3 * offset, t0), offset, rows,
                       shard)
    jac = a.jac * b_val
    jac[tl, :, :, i, :] = jac[tl, :, :, i, :] + a.val[:, :, i, :].permute(2, 0, 1, 3) * bj
    return Jet(a.val * b_val, jac, a.lap * b_val + a.val * b_lap + 2.0 * cross)


def _row_cross(prod, lo: int, offset: int, rows: int, shard=None):
    """The product rule's cross term of a row-local factor: prod (len, B,
    D, F) holds, for the consecutive global tangents lo, lo + 1, ... that
    move an electron of the channel (`dethead_kernels.slab`), that
    tangent's slab row of the jet's Jacobian times the factor's Jacobian;
    each row sums its (up to) three. Returns (B, D, rows, F), summed over
    the deriv ranks with a shard."""
    cross = torch.zeros((rows,) + prod.shape[1:], dtype=prod.dtype,
                        device=prod.device)
    # a row's (up to) three tangents added in the order of their
    # components, one strided slice of consecutive rows a component: the
    # same sums as index_add_ on the CPU, without the card's atomics,
    # whose order (and so the last bit) can vary from run to run
    for comp in range(3):
        s = (comp - lo) % 3
        part = prod[s::3]
        r0 = (lo + s) // 3 - offset
        cross[r0:r0 + part.shape[0]] += part
    cross = cross.permute(1, 2, 0, 3)  # (B, D, rows, F)
    return cross if shard is None else shard.all_sum(cross)


def complexify(re: Jet, im: Jet) -> Jet:
    return Jet(torch.complex(re.val, im.val), torch.complex(re.jac, im.jac),
               torch.complex(re.lap, im.lap))


# ---------------------------------------------------------------------------
# jets of a row-local function of electron positions
# ---------------------------------------------------------------------------


def jet_of_function(f: Callable, r: torch.Tensor) -> Jet:
    """Jets of a row-local f wrt the 3 coordinates of each electron.

    r: (..., 3) positions; f maps (..., 3) -> (..., out) where output row
    `...` depends on r[...] alone, so one forward-mode pass per Cartesian
    direction serves every electron at once. Returns val (..., out), jac
    (3, ..., out) and lap (..., out), the trace of each row's 3x3 Hessian.
    """
    val = f(r)
    jacs, lap = [], None
    for c in range(3):
        e = torch.zeros_like(r)
        e[..., c] = 1.0

        def df(y, e=e):
            return jvp(f, (y,), (e,))[1]

        d1, d2 = jvp(df, (r,), (e,))
        jacs.append(d1)
        lap = d2 if lap is None else lap + d2
    return Jet(val, torch.stack(jacs), lap)


# ---------------------------------------------------------------------------
# sparse -> dense conversions (electron rows on axis 2 of the jac, after
# the tangent and walker axes)
# ---------------------------------------------------------------------------


def dense_from_electron_rows(jac3: torch.Tensor) -> torch.Tensor:
    """(3, B, N, ...) electron-sparse jac -> (3N, B, N, ...) dense jac.

    Row i depends only on r_i: dense[3i + c, :, i] = jac3[c, :, i].
    """
    n = jac3.shape[2]
    out = jac3.new_zeros((n, 3) + jac3.shape[1:])
    idx = torch.arange(n, device=jac3.device)
    out[idx, :, :, idx] = jac3.movedim(2, 0)
    return out.reshape((3 * n,) + jac3.shape[1:])


def dense_row_mean_from_pairs(jac6: torch.Tensor, row_start: int,
                              row_stop: int) -> torch.Tensor:
    """Dense jac of g[:, j] = mean_{i in [row_start, row_stop)} h2[:, i, j].

    jac6: (6, B, N, N, ...) pair-sparse jac of h2 (first 3 tangents wrt
    r_i, last 3 wrt r_j). Returns (3N, B, N, ...).
    """
    n = jac6.shape[2]
    n_rows = row_stop - row_start
    # d/dr_i contributions, i in the averaged channel
    term1 = jac6.new_zeros((n, 3) + jac6.shape[1:2] + jac6.shape[3:])
    term1[row_start:row_stop] = jac6[:3, :, row_start:row_stop].movedim(2, 0) / n_rows
    term1 = term1.reshape((3 * n,) + term1.shape[2:])
    # d/dr_j contributions (same j as the output row)
    s = torch.mean(jac6[3:, :, row_start:row_stop], dim=2)  # (3, B, N, ...)
    return term1 + dense_from_electron_rows(s)


# ---------------------------------------------------------------------------
# determinant head
# ---------------------------------------------------------------------------


def det_factor(a):
    """(A^-1, sign, log|det|) of (..., n, n) matrices via the Gauss-Jordan
    kernel (all leading axes in one launch)."""
    return det_kernels.gj_inverse_slogdet(a)


def _pick_det_scan_chunk(t_dim: int, n: int) -> int:
    """Tangent-chunk size of the scan det head: a divisor of t_dim whose
    width tc*n lies in [128, 3072], preferring multiples of 128, then the
    width closest to 1024; t_dim when none fits (the JAX package's rule)."""
    candidates = [tc for tc in range(1, t_dim + 1)
                  if t_dim % tc == 0 and 128 <= tc * n <= 3072]
    if not candidates:
        return t_dim
    return min(candidates,
               key=lambda tc: (0 if (tc * n) % 128 == 0 else 1,
                               abs(tc * n - 1024)))


def det_trace_chunk(a_inv, j2c, tc, n, lead):
    """One tangent chunk of the det-head trace contractions.

    a_inv: (*lead, n, n); j2c: (*lead, n, tc*n), lanes ordered (t, k).
    Returns (trb (tc, *lead) = tr(A^-1 J_t), l2 (*lead,) = sum_t
    tr((A^-1 J_t)^2) over the chunk).
    """
    b = (a_inv @ j2c).reshape(tuple(lead) + (n, tc, n))  # [..., i, t, k]
    trb = torch.diagonal(b, dim1=-3, dim2=-1).sum(-1)  # (*lead, tc)
    l2 = torch.einsum("...itk,...kti->...", b, b)
    return trb.movedim(-1, 0), l2


def _det_scan_traces(a_inv, j2, t_dim, n, lead):
    """jac[t] = tr(A^-1 J_t) and lap2 = sum_t tr((A^-1 J_t)^2), one
    tangent chunk of the wide (.., n, T*n) stream at a time."""
    tc = _pick_det_scan_chunk(t_dim, n)
    lap2 = torch.zeros(lead, dtype=j2.dtype, device=j2.device)
    trbs = []
    for c in range(t_dim // tc):
        trb, l2 = det_trace_chunk(a_inv, j2[..., c * tc * n:(c + 1) * tc * n],
                                  tc, n, lead)
        lap2 = lap2 + l2
        trbs.append(trb)
    return torch.cat(trbs, dim=0), lap2


def slogdet_jet(mat: Jet, shard=None) -> Tuple[torch.Tensor, Jet]:
    """(sign, jet of log det A) for a jet of square matrices (..., n, n).

    d log det = tr(A^-1 dA);
    Lap log det = tr(A^-1 Lap A) - sum_t tr((A^-1 J_t)^2).
    One factorization per matrix, through the Gauss-Jordan kernel. With
    a shard, mat.jac holds T_local tangents (the scan's chunk is picked
    for T_local) and the sum over tangents is reduced once, over lap2.
    """
    a = mat.val
    a_inv, sign, logdet = det_factor(a)
    t_dim, n = mat.jac.shape[0], a.shape[-1]
    lead = tuple(mat.jac.shape[1:-2])
    j2 = torch.movedim(mat.jac, 0, -2).reshape(lead + (n, t_dim * n))
    lap1 = torch.sum(a_inv * mat.lap.transpose(-1, -2), dim=(-1, -2))
    jac, lap2 = _det_scan_traces(a_inv, j2, t_dim, n, lead)
    if shard is not None:
        lap2 = shard.all_sum(lap2)
    return sign, Jet(logdet, jac, lap1 - lap2)


def sliced_window(jr, jbc=None):
    """det_head_jet's window of tangent products held whole: jr and jbc on
    the local tangents [c0, c1)."""
    return lambda c0, c1: (jr[c0:c1], None if jbc is None else jbc[c0:c1])


def det_head_jet(val, lap, b_val, b_jac3, b_lap, window, t_loc: int, offset: int,
                 shard=None, scan: bool = False) -> Tuple[torch.Tensor, Jet]:
    """(sign, jet of log det A) of a determinant head, A = orb * b with b a
    row-local factor: mul_row's product, then slogdet_jet, without building
    orb's complex Jacobian.

    val, lap: (B, D, rows, rows) complex, the orbitals' value and
    Laplacian (electron rows `offset`.., orbital columns). Their Jacobian
    arrives as the orbital GEMM's real products, a window of the t_loc
    local tangents at a time: window(c0, c1) -> (jr (c1 - c0, B, rows,
    2P), jbc (c1 - c0, B, 2P) or None), P = D rows, the P real parts then
    the P imaginary ones of each row, jbc the row-constant block's
    tangents, added to every row. b_val, b_lap (B, D, rows, rows) and
    b_jac3 (3, B, D, rows, rows) as mul_row takes them; `offset` and
    `shard` as there.

    A is factored once. A window's tangent stream goes through
    dethead_kernels.dethead_traces where it serves the matrices (the
    plain version for CPU tensors), else through dethead_traces_plain;
    mul_row's cross term reads only the window's slab rows, in mul_row's
    order. All t_loc tangents go in one window where the kernel serves and
    `scan` is off; otherwise windows of _pick_det_scan_chunk(t_loc, rows)
    tangents, so that no full-width complex copy is held. With a shard the
    cross term and sum_t tr((A^-1 J_t)^2) are summed over the ranks once.
    """
    rows, ndet = val.shape[-2], val.shape[1]
    p = ndet * val.shape[-1]
    t0 = 0 if shard is None else shard.t0(t_loc)
    kernel = dethead_kernels.serves(rows, val.real.dtype, val.device)
    traces = dethead_kernels.dethead_traces if kernel else dethead_kernels.dethead_traces_plain
    tc = t_loc if kernel and not scan else _pick_det_scan_chunk(t_loc, rows)
    a_inv, sign, logdet = det_factor(val * b_val)
    cross, lap2, trbs = None, None, []
    for c0 in range(0, t_loc, tc):
        c1 = min(c0 + tc, t_loc)
        jr, jbc = window(c0, c1)
        tl, i, c = dethead_kernels.slab(t0 + c0, c1 - c0, offset, rows, val.device)
        if len(tl):
            slab = jr[tl, :, i, :]  # (len, B, 2P)
            if jbc is not None:
                slab = slab + jbc[tl]
            slab = torch.complex(slab[..., :p], slab[..., p:]).unflatten(-1, (ndet, -1))
            part = _row_cross(slab * b_jac3[c, :, :, i, :], max(3 * offset, t0 + c0),
                              offset, rows)
            cross = part if cross is None else cross + part
        trb, l2 = traces(jr, jbc, b_val, b_jac3, val, a_inv, offset, t0 + c0)
        trbs.append(trb)
        lap2 = l2 if lap2 is None else lap2 + l2
        del jr, jbc
    if cross is None:  # no local tangent moves an electron of these rows
        cross = torch.zeros_like(val)
    if shard is not None:
        cross, lap2 = shard.all_sum(cross), shard.all_sum(lap2)
    mat_lap = lap * b_val + val * b_lap + 2.0 * cross
    lap1 = torch.sum(a_inv * mat_lap.transpose(-1, -2), dim=(-1, -2))
    trb = trbs[0] if len(trbs) == 1 else torch.cat(trbs, dim=0)
    return sign, Jet(logdet, trb, lap1 - lap2)


def logsumexp_det_jet(sign, l: Jet, w=None, shard=None) -> Jet:
    """Jet of log|sum_d w_d s_d exp(l_d)| + i arg(...) over the last
    (determinant) axis of l, per walker. Matches ops/slogdet.logdet_matmul.

    sign, l.val, l.lap: (B, ndet); l.jac: (T, B, ndet). Returns a jet with
    val, lap (B,) and jac (T, B).
    """
    lmax = torch.amax(l.val.real, dim=-1, keepdim=True).detach()
    e = sign * torch.exp(l.val - lmax)
    if w is not None:
        e = e * w
    s_tot = torch.sum(e, dim=-1)
    p = e / s_tot[..., None]
    jac = torch.sum(p[None] * l.jac, dim=-1)  # (T, B)
    lap = (torch.sum(p * (l.lap + _tsum(l.jac**2, shard)), dim=-1)
           - _tsum(jac**2, shard))
    val = torch.complex(torch.log(torch.abs(s_tot)) + lmax[..., 0],
                        torch.angle(s_tot))
    return Jet(val, jac, lap)
