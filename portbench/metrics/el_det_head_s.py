"""Device seconds of the determinant head (the envelope and Bloch-phase
jets, `mul_row`, the slogdet jets with B1 and their sum; span
`deepsolid.el.det_head`) per E_L pass over the batch, in the profiled
iterations."""

from portbench import spans


def read(run):
    return spans.per_pass(run, "el.det_head")
