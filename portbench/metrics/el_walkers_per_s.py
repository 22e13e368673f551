"""Walkers per second of the local energy: the batch times the E_L passes
of the window (one an iteration, and one more where the damping adapts),
over the seconds the program spent in them."""


def read(run):
    w = run["window"]
    seconds = w["split_s"].get("local_energy", 0.0) + w["split_s"].get("adapt", 0.0)
    passes = w["iterations"] + w["adapted"]
    return run["batch"] * passes / seconds if seconds > 0 else None
