"""The share of the profiled iterations' wall time in which no kernel,
copy or memset ran on the card."""


def read(run):
    tr = run["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
