"""The measured window of a run: whole training iterations.

The window opens when the warm-up iterations end and closes at the end of
the first iteration that ends `seconds` or more after it opened, so it
holds whole iterations only. Every rate is all the work of the window over
all its wall time, not a statistic of single iterations.
"""

from __future__ import annotations

from typing import List


def closes(start: float, now: float, seconds: float) -> bool:
    """Whether an iteration ending at `now` closes a window opened at `start`."""
    return now - start >= seconds


def summary(iterations: List[dict], start: float, end: float, batch: int) -> dict:
    """Totals of the window's iterations: each has 'seconds' (the
    program's split of that iteration) and 'adapted'."""
    total = {}
    for it in iterations:
        for key, value in it["seconds"].items():
            total[key] = total.get(key, 0.0) + value
    return {
        "iterations": len(iterations),
        "adapted": sum(1 for it in iterations if it["adapted"]),
        "wall_s": end - start,
        "walkers": batch * len(iterations),
        "split_s": total,
    }
