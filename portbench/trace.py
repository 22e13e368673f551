"""Reading a torch.profiler trace (Chrome trace JSON) of the profiled
iterations: device busy time, kernel time by name, the longest idle gaps
and what the host was doing in each."""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function")
SPAN_PREFIX = "portbench."


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], end))
        else:
            merged.append((start, end))
    return merged


def _signature(name: str) -> str:
    """A kernel's demangled name without its return type (`void `, or an
    `enable_if<...>::type ` prefix) and its parameter list."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    if name.startswith("std::enable_if") and "::type " in name:
        name = name.split("::type ", 1)[1]
    cut = name.find("(")
    return name[:cut] if cut > 0 else name


def short_name(name: str) -> str:
    """A kernel's name without namespaces and template arguments too, so
    that its launches group under one name."""
    name = _signature(name)
    cut = name.find("<")
    return (name[:cut] if cut > 0 else name).strip().split("::")[-1]


def read(path: str, window_s: float) -> dict:
    """busy_s, window_s, kernel seconds by short name, top device ops and
    the longest idle gaps labelled by the host's span and operation."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, spans = [], [], []
    kernels: Dict[str, float] = {}
    ops: Dict[str, float] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        start, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATEGORIES:
            device.append((start, start + dur))
            name = short_name(ev["name"]) if cat == "kernel" else cat
            kernels[name] = kernels.get(name, 0.0) + dur * 1e-6
            full = (_signature(ev["name"]) if cat == "kernel" else cat)[:120]
            ops[full] = ops.get(full, 0.0) + dur * 1e-6
        elif cat in HOST_CATEGORIES:
            item = (start, start + dur, ev["name"])
            (spans if ev["name"].startswith(SPAN_PREFIX) else host).append(item)
    busy = _union(device)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:10]

    def label(lo, hi):
        mid = 0.5 * (lo + hi)
        span = min((s for s in spans if s[0] <= mid <= s[1]),
                   key=lambda s: s[1] - s[0], default=None)
        op = min((h for h in host if h[0] <= mid <= h[1]),
                 key=lambda h: h[1] - h[0], default=None)
        parts = [span[2][len(SPAN_PREFIX):] if span else "outside spans",
                 op[2] if op else "no host op"]
        return "/".join(parts)

    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "kernels": kernels,
        "device_ops": [list(kv) for kv in sorted(ops.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[label(lo, hi), gap * 1e-6] for gap, lo, hi in gaps],
    }
