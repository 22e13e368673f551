"""ATen calls per call of the CUDA kernels' wrappers (spans
`deepsolid.op.*`), over both wrappers, in the profiled iterations: the
host work a wrapper does beside its launch, counted the same on every
run, where `wrapper_host_us` also carries the profiler's cost."""

from portbench import spans


def read(run):
    found = spans.of(run)
    if not found:
        return None
    calls = sum(c for name, c in found["count"].items() if name.startswith("op."))
    ops = sum(c for name, c in found.get("cpu_ops", {}).items() if name.startswith("op."))
    return ops / calls if calls else None
