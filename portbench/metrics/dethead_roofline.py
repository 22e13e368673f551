"""The det head kernel (csrc/dethead_trace.cu) against its roofline in the
profiled iterations: the least time of the launches reckoned from the
record (portbench/counts/dethead.py: 8 n^3 flops a matrix and tangent, or
the bytes, whichever bounds, at the precision's peak), over the device
time of every kernel whose name starts with dethead_trace_kernel. Nothing
to read when no such kernel ran."""

from portbench.counts import dethead, peaks

PREFIX = "dethead_trace_kernel"


def read(run):
    tr = run["trace"]
    if not tr:
        return None
    seconds = sum(v for k, v in tr["kernels"].items() if k.startswith(PREFIX))
    real_bytes = 8 if run["precision"] == "float64" else 4
    bound = 0.0
    for (matrices, n, t), count in dethead.launches(run).items():
        nbytes, flops = dethead.launch(matrices, n, t, real_bytes)
        bound += count * peaks.bound_s(nbytes, flops, run["precision"])
    return 100.0 * bound / seconds if seconds > 0 and bound > 0 else None
