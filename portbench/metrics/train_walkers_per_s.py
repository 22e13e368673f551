"""Walkers through whole training iterations per second of the window:
the batch times the iterations the window holds, over its wall time."""


def read(run):
    w = run["window"]
    return w["walkers"] / w["wall_s"] if w["iterations"] else None
