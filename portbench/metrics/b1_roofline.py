"""B1 (csrc/gj_inverse.cu) against its roofline in the profiled
iterations: the least time of every launch the wrapper counted
(det_kernels.SHAPES: n^3 complex multiply-adds or the bytes, whichever
bounds, at the precision's peak), over the device time of the kernels
named here. Nothing to read when no such kernel ran."""

from portbench.counts import kernels, peaks

KERNELS = ("gj_registers_kernel", "gj_warp_kernel", "gj_mid_kernel", "gj_shared_kernel",
           "gj_registers_double_kernel", "gj_warp_double_kernel",
           "gj_mid_double_kernel")


def read(run):
    tr = run["trace"]
    if not tr:
        return None
    seconds = sum(v for k, v in tr["kernels"].items() if k in KERNELS)
    real_bytes = 8 if run["precision"] == "float64" else 4
    bound = 0.0
    for (_, (matrices, n, _), _), count in run["launches"]["b1"]:
        nbytes, flops = kernels.b1(matrices, n, real_bytes)
        bound += count * peaks.bound_s(nbytes, flops, run["precision"])
    return 100.0 * bound / seconds if seconds > 0 and bound > 0 else None
