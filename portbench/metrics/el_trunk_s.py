"""Device seconds of the forward engine's trunk (the features, B2 and B3
layers with their residuals and symmetric split; span
`deepsolid.el.trunk`) per E_L pass over the batch, in the profiled
iterations."""

from portbench import spans


def read(run):
    return spans.per_pass(run, "el.trunk")
