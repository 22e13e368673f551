"""Fused dense + tanh jet rule: CUDA kernel and plain version.

Counterpart of deepsolid_tpu/ops/pallas/jet_kernels.py
(fused_dense_tanh_jet, fused_dense_tanh_jet_mix and their `_partial`
twins). One CUDA source (csrc/dense_tanh_jet.cu) serves all four; the mix
variant adds the precontracted row-constant terms of each walker, and the
partial ("open") form serves a tangent axis sharded over ranks: jac holds
this rank's tangents and the tangent square sum comes back as a fourth
output, s_local, for the caller to sum over the ranks and close
    lap = lap_part + (-2 v (1 - v^2)) * sum_ranks s_local.
The wrappers take the plain PyTorch version only for tensors on the CPU.

Layouts (float32 on the card; T is T_local in the open form):
  plain rule: val, lap (R, d_in); jac (T, R, d_in); w (d_in, d_out); b (d_out,)
  mix rule:   val, lap (G, n, d_in); jac (T, G, n, d_in); zbc, lbc (G, d_out);
              jbc (T, G, d_out) - G walkers of n rows each.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from deepsolid_tpu_torch.ops.cuda import build

LAUNCHES = {"fused_dense_tanh_jet": 0, "fused_dense_tanh_jet_mix": 0,
            "fused_dense_tanh_jet_partial": 0,
            "fused_dense_tanh_jet_mix_partial": 0}
# launches by (kernel, (T, rows, d_in, d_out), variant_label), counted
# beside LAUNCHES
SHAPES = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "dense_tanh_jet_launch": (_I, [_P] * 13 + [_I] * 7 + [_P]),
}
# the wide variant's block tile and the largest d_in whose column slice of
# w stays resident in shared memory (kWM, kWN, kWMaxK in csrc/dense_tanh_jet.cu)
WIDE_ROWS, WIDE_COLS, WIDE_MAX_D_IN = 256, 64, 384
# what a block of the wide variant does once whatever its slice, counted in
# tangents' worth of work: it loads its slice of w and forms the value
WIDE_BLOCK_OVERHEAD = 2


def slice_tangents(t_dim, slices):
    """Tangents per slice, as the launcher cuts them (the last may be short)."""
    return -(-t_dim // slices)


def wide_slices(t_dim, rows, d_in, d_out, sms):
    """Tangent slices of the wide variant for this shape, 0 for the narrow
    one. The wide variant reads 128-bit vectors and keeps a d_in x 64 slice
    of w in shared memory, so it takes layers whose d_out is a multiple of
    its 64-column tile and whose d_in is a multiple of 4 and at most
    WIDE_MAX_D_IN (the 256-wide one-electron layers). One block runs per
    SM; the tangents are sliced over the grid so that the waves of blocks
    times a block's work (its tangents plus the fixed part) come out least,
    the fewest slices on a tie: no slice is empty."""
    if (d_out % WIDE_COLS or d_in % 4 or d_in > WIDE_MAX_D_IN or t_dim < 1
            or rows < 1):
        return 0
    tiles = -(-rows // WIDE_ROWS) * (d_out // WIDE_COLS)
    best, best_cost = 1, None
    for want in range(1, t_dim + 1):
        per = slice_tangents(t_dim, want)
        slices = -(-t_dim // per)
        cost = -(-tiles * slices // sms) * (per + WIDE_BLOCK_OVERHEAD)
        if best_cost is None or cost < best_cost:
            best, best_cost = slices, cost
        if tiles * slices >= 16 * sms:  # finer slices only add fixed parts
            break
    return best


# the pair variant's shapes: the two-electron layers (d_out, d_in choices
# kPC and the launch_pair instantiations in csrc/dense_tanh_jet.cu)
PAIR_D_OUT, PAIR_D_IN = 32, (4, 32)
PAIR = -1  # what `kernel_variant` returns for the pair variant


def pair_body(d_in, d_out, mixed):
    """Whether the pair variant takes this layer: the plain rule at the
    two-electron layers' widths, where a row of the output is one 128-byte
    line and the work is a streaming pass."""
    return not mixed and d_out == PAIR_D_OUT and d_in in PAIR_D_IN


def kernel_variant(t_dim, rows, d_in, d_out, mixed, sms):
    """Which kernel body a launch runs, by shape alone: PAIR for the pair
    variant, a positive count of tangent slices for the wide variant, 0
    for the general one."""
    if pair_body(d_in, d_out, mixed):
        return PAIR
    return wide_slices(t_dim, rows, d_in, d_out, sms)


def variant_label(slices):
    """`kernel_variant`'s answer in words."""
    if slices == PAIR:
        return "pair"
    return f"wide, {slices} tangent slices" if slices > 0 else "general"


def _dense(x):
    """x as a contiguous tensor whose data starts on a 16-byte boundary
    (the kernels read rows as 128-bit vectors): a strided input or a view
    that starts mid-allocation is copied."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def fused_dense_tanh_jet_plain(val, jac, lap, w, b):
    """(val_out, jac_out, lap_out) of tanh(val @ w + b) as a jet."""
    t = torch.tanh(val @ w + b)
    d = 1.0 - t * t
    yj = jac @ w
    return t, d * yj, d * (lap @ w) + (-2.0 * t * d) * torch.sum(yj * yj, dim=0)


def fused_dense_tanh_jet_mix_plain(val, jac, lap, zbc, lbc, jbc, w, b):
    """The same rule on tanh(val @ w + broadcast_rows(zbc) + b)."""
    t = torch.tanh(val @ w + b + zbc[:, None, :])
    d = 1.0 - t * t
    yj = jac @ w + jbc[:, :, None, :]
    yl = lap @ w + lbc[:, None, :]
    return t, d * yj, d * yl + (-2.0 * t * d) * torch.sum(yj * yj, dim=0)


def fused_dense_tanh_jet_partial_plain(val, jac, lap, w, b):
    """(val_out, jac_out, lap_part, s_local) with the tangent sum open:
    lap_part = d * (lap @ w), s_local = sum over this jac's tangents of
    (jac_t @ w)^2."""
    t = torch.tanh(val @ w + b)
    d = 1.0 - t * t
    yj = jac @ w
    return t, d * yj, d * (lap @ w), torch.sum(yj * yj, dim=0)


def fused_dense_tanh_jet_mix_partial_plain(val, jac, lap, zbc, lbc, jbc, w, b):
    """The open form of the mix rule, same four outputs."""
    t = torch.tanh(val @ w + b + zbc[:, None, :])
    d = 1.0 - t * t
    yj = jac @ w + jbc[:, :, None, :]
    return t, d * yj, d * (lap @ w + lbc[:, None, :]), torch.sum(yj * yj, dim=0)


def close_laplacian(val_out, lap_part, s_total):
    """lap = lap_part + (-2 v (1 - v^2)) * s_total, the identity that
    closes the open form once s_local is summed over the ranks."""
    return lap_part + (-2.0 * val_out * (1.0 - val_out * val_out)) * s_total


def _lib():
    return build.library("dense_tanh_jet", _SIGNATURES)


def _check_cuda(name, **tensors):
    for key, x in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name} kernel needs CUDA tensors; {key} is on {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32; {key} is {x.dtype}")


def _launch(name, val, jac, lap, w, b, mix, rows_per_group, groups,
            open_sum=False):
    """Launches the kernel; returns (val_o, jac_o, lap_o) or, with
    `open_sum`, (val_o, jac_o, lap_part, s_local)."""
    t_dim, rows, d_in = jac.shape
    d_out = w.shape[1]
    if val.shape != (rows, d_in) or lap.shape != (rows, d_in):
        raise ValueError(f"{name}: val/lap must be {(rows, d_in)}")
    if w.shape[0] != d_in or b.shape != (d_out,):
        raise ValueError(f"{name}: w must be ({d_in}, d_out), b (d_out,)")
    # the kernel reads dense row-major tiles; _dense copies only an input
    # that arrives strided or offset (the trunk's jets arrive dense)
    val, jac, lap, w, b = (_dense(x) for x in (val, jac, lap, w, b))
    zbc, lbc, jbc = (_dense(x) for x in mix) if mix else (None,) * 3
    val_o = torch.empty((rows, d_out), dtype=val.dtype, device=val.device)
    lap_o = torch.empty_like(val_o)
    jac_o = torch.empty((t_dim, rows, d_out), dtype=val.dtype, device=val.device)
    sq_o = torch.empty_like(val_o) if open_sum else None
    if rows and d_out:
        lib = _lib()
        # the one place the variant is chosen, by shape alone. The wide
        # variant splits the tangents across blocks, whose partial square
        # sums need slices * rows * d_out floats of scratch; PAIR is the
        # streaming body of the two-electron layers; 0 slices is the
        # general one (also for a d_in whose slice of w does not fit in
        # shared memory). t_dim is this call's own (a rank's T_local in the
        # open form), so scratch and the finishing grid follow `slices`
        sms = torch.cuda.get_device_properties(val.device).multi_processor_count
        slices = kernel_variant(t_dim, rows, d_in, d_out, mix is not None, sms)
        scratch = (torch.empty((slices, rows, d_out), dtype=val.dtype,
                               device=val.device) if slices > 0 else None)
        ptr = (lambda x: None if x is None else x.data_ptr())
        with torch.cuda.device(val.device):
            stream = torch.cuda.current_stream(val.device).cuda_stream
            code = lib.dense_tanh_jet_launch(
                ptr(val), ptr(lap), ptr(jac), ptr(w), ptr(b), ptr(zbc),
                ptr(lbc), ptr(jbc), ptr(val_o), ptr(lap_o), ptr(jac_o),
                ptr(scratch), ptr(sq_o), slices, t_dim, rows, d_in, d_out,
                rows_per_group, groups, stream)
        build.check(lib, code, name)
        LAUNCHES[name] += 1
        SHAPES[name, (t_dim, rows, d_in, d_out), variant_label(slices)] += 1
    if open_sum:
        return val_o, jac_o, lap_o, sq_o
    return val_o, jac_o, lap_o


def fused_dense_tanh_jet(val, jac, lap, w, b):
    """(val_out, jac_out, lap_out) of tanh(val @ w + b) as a jet.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if val.device.type == "cpu":
        return fused_dense_tanh_jet_plain(val, jac, lap, w, b)
    name = "fused_dense_tanh_jet"
    _check_cuda(name, val=val, jac=jac, lap=lap, w=w, b=b)
    return _launch(name, val, jac, lap, w, b, None, 1, 1)


def fused_dense_tanh_jet_partial(val, jac, lap, w, b):
    """(val_out, jac_out, lap_part, s_local) of tanh(val @ w + b) as a jet
    whose jac holds one rank's T_local tangents; see close_laplacian.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.
    """
    if val.device.type == "cpu":
        return fused_dense_tanh_jet_partial_plain(val, jac, lap, w, b)
    name = "fused_dense_tanh_jet_partial"
    _check_cuda(name, val=val, jac=jac, lap=lap, w=w, b=b)
    return _launch(name, val, jac, lap, w, b, None, 1, 1, open_sum=True)


def _launch_mix(name, val, jac, lap, zbc, lbc, jbc, w, b, open_sum):
    _check_cuda(name, val=val, jac=jac, lap=lap, zbc=zbc, lbc=lbc, jbc=jbc,
                w=w, b=b)
    groups, n, d_in = val.shape
    t_dim, d_out = jac.shape[0], w.shape[1]
    if (zbc.shape != (groups, d_out) or lbc.shape != (groups, d_out)
            or jbc.shape != (t_dim, groups, d_out)):
        raise ValueError(f"{name}: zbc/lbc must be {(groups, d_out)}, "
                         f"jbc {(t_dim, groups, d_out)}")
    v, j, *rest = _launch(
        name, val.reshape(groups * n, d_in),
        jac.reshape(t_dim, groups * n, d_in), lap.reshape(groups * n, d_in),
        w, b, (zbc, lbc, jbc), n, groups, open_sum=open_sum)
    return (v.reshape(groups, n, d_out), j.reshape(t_dim, groups, n, d_out),
            *(x.reshape(groups, n, d_out) for x in rest))


def fused_dense_tanh_jet_mix(val, jac, lap, zbc, lbc, jbc, w, b):
    """The jet of tanh(val @ w + zbc + b) with the row-constant terms
    zbc/lbc/jbc of each of the G walkers added to its n rows."""
    if val.device.type == "cpu":
        return fused_dense_tanh_jet_mix_plain(val, jac, lap, zbc, lbc, jbc, w, b)
    return _launch_mix("fused_dense_tanh_jet_mix", val, jac, lap, zbc, lbc,
                       jbc, w, b, open_sum=False)


def fused_dense_tanh_jet_mix_partial(val, jac, lap, zbc, lbc, jbc, w, b):
    """The open form of the mix rule: (val_out, jac_out, lap_part,
    s_local), jac and jbc holding one rank's T_local tangents."""
    if val.device.type == "cpu":
        return fused_dense_tanh_jet_mix_partial_plain(val, jac, lap, zbc, lbc,
                                                      jbc, w, b)
    return _launch_mix("fused_dense_tanh_jet_mix_partial", val, jac, lap, zbc,
                       lbc, jbc, w, b, open_sum=True)
