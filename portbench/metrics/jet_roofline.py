"""B2/B3 (csrc/dense_tanh_jet.cu) against their roofline in the profiled
iterations: the least time of every launch the wrapper counted
(jet_kernels.SHAPES, the mix rule's walkers from its rows), over the
device time of the kernels named here, the finishing kernels included.
Nothing to read when no such kernel ran."""

from portbench.counts import kernels, peaks

KERNELS = ("dense_tanh_jet_kernel", "dense_tanh_jet_wide_kernel",
           "dense_tanh_jet_pair_kernel", "dense_tanh_jet_pair_double_kernel",
           "dense_tanh_jet_dmma_kernel", "finish_lap_kernel", "finish_open_kernel")


def read(run):
    tr = run["trace"]
    if not tr:
        return None
    seconds = sum(v for k, v in tr["kernels"].items() if k in KERNELS)
    real_bytes = 8 if run["precision"] == "float64" else 4
    n = run["nelectron"]
    bound = 0.0
    for (name, (t, rows, d_in, d_out), _), count in run["launches"]["jet"]:
        groups = rows // n if "mix" in name else 0
        nbytes, flops = kernels.jet(t, rows, d_in, d_out, groups, real_bytes)
        bound += count * peaks.bound_s(nbytes, flops, run["precision"])
    return 100.0 * bound / seconds if seconds > 0 and bound > 0 else None
