"""Fused dense + tanh jet rule: CUDA kernel and plain version.

Counterpart of deepsolid_tpu/ops/pallas/jet_kernels.py
(fused_dense_tanh_jet and fused_dense_tanh_jet_mix). One CUDA source
(csrc/dense_tanh_jet.cu) serves both; the mix variant adds the
precontracted row-constant terms of each walker. The wrappers take the
plain PyTorch version only for tensors on the CPU.

Layouts (float32 on the card):
  plain rule: val, lap (R, d_in); jac (T, R, d_in); w (d_in, d_out); b (d_out,)
  mix rule:   val, lap (G, n, d_in); jac (T, G, n, d_in); zbc, lbc (G, d_out);
              jbc (T, G, d_out) - G walkers of n rows each.
"""

from __future__ import annotations

import ctypes

import torch

from deepsolid_tpu_torch.ops.cuda import build

LAUNCHES = {"fused_dense_tanh_jet": 0, "fused_dense_tanh_jet_mix": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "dense_tanh_jet_launch": (_I, [_P] * 12 + [_I] * 7 + [_P]),
}
# the wide variant's block tile (kWM x kWN in csrc/dense_tanh_jet.cu)
WIDE_ROWS, WIDE_COLS = 128, 64


def wide_slices(t_dim, rows, d_in, d_out, sms):
    """Tangent slices of the wide variant for this shape, 0 for the narrow
    one. The wide variant reads 128-bit vectors, so it takes layers whose
    d_out is a multiple of its 64-column tile and whose d_in is a multiple
    of 4 (the 256-wide one-electron layers); it slices the tangents over
    the grid to run about four waves of two resident blocks per SM."""
    if d_out % WIDE_COLS or d_in % 4 or t_dim < 1 or rows < 1:
        return 0
    per_slice = -(-rows // WIDE_ROWS) * (d_out // WIDE_COLS)
    return max(1, min(-(-8 * sms // per_slice), t_dim))


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


def _lib():
    return build.library("dense_tanh_jet", _SIGNATURES)


def _check_cuda(name, **tensors):
    for key, x in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name} kernel needs CUDA tensors; {key} is on {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32; {key} is {x.dtype}")


def _launch(name, val, jac, lap, w, b, mix, rows_per_group, groups):
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
    if rows and d_out:
        lib = _lib()
        # the one place the variant is chosen: the wide variant splits the
        # tangents across blocks, whose partial square sums need
        # slices * rows * d_out floats of scratch; 0 slices is the narrow one
        sms = torch.cuda.get_device_properties(val.device).multi_processor_count
        slices = wide_slices(t_dim, rows, d_in, d_out, sms)
        scratch = (torch.empty((slices, rows, d_out), dtype=val.dtype,
                               device=val.device) if slices else None)
        ptr = (lambda x: None if x is None else x.data_ptr())
        with torch.cuda.device(val.device):
            stream = torch.cuda.current_stream(val.device).cuda_stream
            code = lib.dense_tanh_jet_launch(
                ptr(val), ptr(lap), ptr(jac), ptr(w), ptr(b), ptr(zbc),
                ptr(lbc), ptr(jbc), ptr(val_o), ptr(lap_o), ptr(jac_o),
                ptr(scratch), slices, t_dim, rows, d_in, d_out,
                rows_per_group, groups, stream)
        build.check(lib, code, name)
        LAUNCHES[name] += 1
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


def fused_dense_tanh_jet_mix(val, jac, lap, zbc, lbc, jbc, w, b):
    """The jet of tanh(val @ w + zbc + b) with the row-constant terms
    zbc/lbc/jbc of each of the G walkers added to its n rows."""
    if val.device.type == "cpu":
        return fused_dense_tanh_jet_mix_plain(val, jac, lap, zbc, lbc, jbc, w, b)
    name = "fused_dense_tanh_jet_mix"
    _check_cuda(name, val=val, jac=jac, lap=lap, zbc=zbc, lbc=lbc, jbc=jbc,
                w=w, b=b)
    groups, n, d_in = val.shape
    t_dim, d_out = jac.shape[0], w.shape[1]
    if (zbc.shape != (groups, d_out) or lbc.shape != (groups, d_out)
            or jbc.shape != (t_dim, groups, d_out)):
        raise ValueError(f"{name}: zbc/lbc must be {(groups, d_out)}, "
                         f"jbc {(t_dim, groups, d_out)}")
    v, j, l = _launch(
        name, val.reshape(groups * n, d_in),
        jac.reshape(t_dim, groups * n, d_in), lap.reshape(groups * n, d_in),
        w, b, (zbc, lbc, jbc), n, groups)
    return (v.reshape(groups, n, d_out), j.reshape(t_dim, groups, n, d_out),
            l.reshape(groups, n, d_out))
