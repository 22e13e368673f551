"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit): HBM3 at 3.35 TB/s; 67 TFLOP/s in float32
outside the tensor cores, which is what the port computes in (TF32 off);
67 TFLOP/s in float64 on the tensor cores."""

PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}


def bound_s(nbytes: float, flops: float, precision: str) -> float:
    """The least time for `nbytes` moved and `flops` done."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS[precision])
