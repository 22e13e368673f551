"""The program's spans in a torch.profiler trace (Chrome trace JSON).

deepsolid_tpu_torch names its layers with `deepsolid.<name>` spans
(`utils/profiling.annotate`). For each span name, over the profiled
iterations:

  count      complete spans of that name
  host_s     the sum of their host durations
  device_s   the device time of every kernel, memcpy and memset whose
             launch fell inside a span of that name
  launches   the number of those device events
  cpu_ops    the ATen calls (`cpu_op` events, nested ones counted too)
             that started inside a span of that name: the same on every
             run of one path, where host_s carries the profiler's own cost
             and the shared host's noise

A device event is joined to its launch, a `cuda_runtime` or
`cuda_driver` call (cuBLAS launches through the driver), by the trace's
`correlation` id. Attribution is by launch, not by overlap in time, since
the host runs ahead of the card, and it is inclusive: a kernel launched
under `el.det_head` counts for `el.chunk`, `local_energy` and `iteration`
too. A launch falls inside the spans open at its time on its own host
thread; a thread that opens no span is the autograd engine's worker,
which runs a backward pass while the thread that called it waits inside
its span, so its launches fall inside the spans open at their time on the
threads of the same process that do. A span still open when the profiler
started or stopped has no complete event (the trace marks it unfinished)
and is left out. `unattributed_s` is the device time launched outside
every such span.
"""

from __future__ import annotations

import json
from collections import defaultdict

PREFIX = "deepsolid."
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def read(path: str) -> dict:
    with open(path) as f:
        return summarize(json.load(f)["traceEvents"])


def _enclosing(spans, launches):
    """{correlation: names of the spans open at its launch} for the
    launches of one host thread; spans on a thread nest, so a stack swept
    in time order holds exactly the open ones."""
    out = {}
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    stack, i = [], 0
    for ts, corr in sorted(launches):
        while i < len(spans) and spans[i][0] <= ts:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < ts:
            stack.pop()
        out[corr] = {name for _, _, name in stack}
    return out


def summarize(events) -> dict:
    spans = defaultdict(list)     # thread -> [(start, end, name)]
    launches = defaultdict(list)  # thread -> [(ts, correlation)]
    ops = defaultdict(list)       # thread -> [(ts, index)]: ATen calls
    device = []                   # (correlation, seconds)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, args = ev.get("cat", ""), ev.get("args") or {}
        thread = (ev.get("pid"), ev.get("tid"))
        if cat == "user_annotation" and ev["name"].startswith(PREFIX):
            if args.get("finished", True):
                start = float(ev["ts"])
                spans[thread].append((start, start + float(ev.get("dur", 0.0)),
                                      ev["name"][len(PREFIX):]))
        elif cat == "cpu_op":
            ops[thread].append((float(ev["ts"]), len(ops[thread])))
        elif cat in LAUNCH_CATEGORIES and "correlation" in args:
            launches[thread].append((float(ev["ts"]), args["correlation"]))
        elif cat in DEVICE_CATEGORIES:
            device.append((args.get("correlation"), float(ev.get("dur", 0.0)) * 1e-6))

    def owners(thread):
        return [thread] if thread in spans else [t for t in spans if t[0] == thread[0]]

    enclosing = defaultdict(set)
    for thread, items in launches.items():
        for owner in owners(thread):
            for corr, names in _enclosing(spans[owner], items).items():
                enclosing[corr] |= names
    cpu_ops = defaultdict(int)
    for thread, items in ops.items():
        inside = defaultdict(set)
        for owner in owners(thread):
            for index, names in _enclosing(spans[owner], items).items():
                inside[index] |= names
        for names in inside.values():
            for name in names:
                cpu_ops[name] += 1
    count, host_s = defaultdict(int), defaultdict(float)
    for items in spans.values():
        for start, end, name in items:
            count[name] += 1
            host_s[name] += (end - start) * 1e-6
    device_s, launched = defaultdict(float), defaultdict(int)
    unattributed = 0.0
    for corr, seconds in device:
        names = enclosing.get(corr, ())
        if not names:
            unattributed += seconds
        for name in names:
            device_s[name] += seconds
            launched[name] += 1
    return {"count": dict(count), "host_s": dict(host_s), "device_s": dict(device_s),
            "launches": dict(launched), "cpu_ops": dict(cpu_ops),
            "unattributed_s": unattributed}


def of(run):
    """The spans a run's profiled iterations read, or None (an untraced
    run, or a harness that did not read them)."""
    return (run.get("trace") or {}).get("spans")


def el_passes(found: dict, el_chunk: int, batch: int) -> float:
    """E_L passes over the whole batch: el.chunk spans times the walkers
    of a chunk over the batch (an unchunked pass is one el.chunk); an
    adapting step's second loss counts as a pass too."""
    chunk = el_chunk if el_chunk and 0 < el_chunk < batch else batch
    return found["count"].get("el.chunk", 0) * chunk / batch


def per_pass(run, name: str):
    """Device seconds under span `name` per E_L pass, or None."""
    found = of(run)
    if not found or name not in found["device_s"]:
        return None
    passes = el_passes(found, run["traffic"]["el_chunk"], run["batch"])
    return found["device_s"][name] / passes if passes else None
