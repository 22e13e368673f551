"""Device seconds of the orbital head (each spin channel's dense or
dense-mix product, complexify and reshape; span `deepsolid.el.orbitals`)
per E_L pass over the batch, in the profiled iterations."""

from portbench import spans


def read(run):
    return spans.per_pass(run, "el.orbitals")
