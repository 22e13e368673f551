"""Run one cell of BENCHMARK.json on the card and print one JSON line.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. With --trace 0 the line holds the cell's
end-to-end metrics, with --trace 1 its per-layer metrics (the window is
timed untraced, then `trace_iterations` more iterations run under
torch.profiler). Every run checks the first steps of the timed loop
against the plain reference; `correct` says whether each compared number
is within its limit, and the numbers close the line under "checks" and
close standard error. The run exits with 2, printing no result, without
enough CUDA cards, and with 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root in place of this script's folder, whose module names
# (trace, spec, window, check) would shadow others
sys.path[0] = str(ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "deepsolid_tpu")
# the program's and its libraries' kernel caches, at fixed paths in the checkout
CACHE = ROOT / ".portbench_cache"


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (deepsolid_tpu_torch is not deepsolid_tpu)."""
    return sorted(m for m, mod in list(sys.modules.items())
                  if mod is not None and m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def result_line(cell, record, trace: bool, device_name: str) -> dict:
    from portbench import spec

    metrics = {}
    for m in cell.metrics(trace):
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    window = record["window_iterations"]
    device = {"platform": "gpu", "kind": device_name, "count": cell.chips,
              "memory_peak_bytes": record["peak_bytes"]}
    line = {"correct": record["correct"], "attempted": len(window),
            "failed": sum(1 for it in window if not it["finite"]),
            "metrics": metrics, "device": device}
    if trace and record["trace"]:
        device.update(busy_s=record["trace"]["busy_s"], window_s=record["trace"]["window_s"])
        line["breakdown"] = {"device_ops": record["trace"]["device_ops"],
                             "idle_gaps": record["trace"]["idle_gaps"]}
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in record["checks"]}
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    import torch

    from portbench import harness, spec

    started = harness.process_start()
    cell = spec.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed {args.seed} on {power_limit()}",
          file=sys.stderr, flush=True)
    record = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             device="cuda:0", started=started)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    line = result_line(cell, record, bool(args.trace), torch.cuda.get_device_name(0))
    w = record["window"]
    print(f"portbench: set-up {record['setup_s']:.2f} s, window {w['iterations']} "
          f"iterations in {w['wall_s']:.2f} s, reference {record['reference_s']:.1f} s",
          file=sys.stderr)
    for name, value, limit in record["checks"]:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
