"""Kernels, copies and memsets launched per E_L chunk (span
`deepsolid.el.chunk`) in the profiled iterations."""

from portbench import spans


def read(run):
    found = spans.of(run)
    if not found or not found["count"].get("el.chunk"):
        return None
    return found["launches"].get("el.chunk", 0) / found["count"]["el.chunk"]
