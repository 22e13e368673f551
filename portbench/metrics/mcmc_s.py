"""Seconds of the sampler (20 all-electron Metropolis steps through the
network's value path and B1) per window iteration, from the program's
own split of each iteration."""


def read(run):
    w = run["window"]
    return w["split_s"].get("mcmc", 0.0) / w["iterations"] if w["iterations"] else None
