"""Readings for the limits of `correct`, many seeds in one process.

    python3 portbench/calibrate.py --workload NAME --seeds 1,2,3 \\
        --control 3 --faults 3 [--seconds 0]

Each seed is one run of the cell (set-up, the followed steps, the
reference) without a measured window; the first `--control` seeds also
read the control (the reference in the precision below the cell's, in the
program's place) and the first `--faults` seeds the half-batch fault. One
JSON line a seed: the compared numbers, the control's and the fault's,
the per-step readings behind them, and the seconds each part took.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", type=int, default=0)
    parser.add_argument("--faults", type=int, default=0)
    parser.add_argument("--seconds", type=float, default=0.0)
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args(argv)
    import torch

    from portbench import harness, spec

    cell = spec.Cell(args.workload)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        started = time.perf_counter()
        rec = harness.run_cell(cell, seed, args.seconds, False, device=args.device,
                              started=started, control=i < args.control,
                              faults=i < args.faults)
        line = {"seed": seed, "checks": {n: v for n, v, _ in rec["checks"]},
                "setup_s": rec["setup_s"], "reference_s": rec["reference_s"],
                "peak_bytes": rec["peak_bytes"], "diagnostics": rec["diagnostics"]}
        for key in ("control", "control_s", "fault_half_batch", "fault_s"):
            if key in rec:
                line[key] = rec[key]
        print(json.dumps(line), flush=True)
        del rec
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
