"""Seconds of the gradient, the KFAC curvature capture and the update per
window iteration. Nothing to read where the traffic takes no gradient."""


def read(run):
    w = run["window"]
    s = w["split_s"]
    if not w["iterations"] or "gradient" not in s:
        return None
    return (s["gradient"] + s.get("curvature", 0.0) + s.get("update", 0.0)) / w["iterations"]
