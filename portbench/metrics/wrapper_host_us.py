"""Host microseconds per call of the CUDA kernels' wrappers (spans
`deepsolid.op.*`, from the argument checks to the launch counter), over
both wrappers, in the profiled iterations."""

from portbench import spans


def read(run):
    found = spans.of(run)
    if not found:
        return None
    calls = sum(c for name, c in found["count"].items() if name.startswith("op."))
    host_s = sum(s for name, s in found["host_s"].items() if name.startswith("op."))
    return 1e6 * host_s / calls if calls else None
