"""Times the jet kernel's pair body in double beside variants of it, on a CUDA machine.

    python -m deepsolid_tpu_torch.ops.cuda.time_pair_variants

Each variant is csrc/dense_tanh_jet.cu with one change to
dense_tanh_jet_pair_double_kernel made by text substitution, built with
build.py's flags into build/pair_variants/ under the working directory:
  staged   - every output plane through a 16 x 32 staging tile per warp,
             from which the warp writes two whole rows (512 contiguous
             bytes) per instruction, as the float32 pair body does;
  stages4  - a four-stage ring instead of three;
  no_fma   - the k-loop's DFMAs cut to an assignment (wrong results): the
             copies, tanh and stores alone.
Times are milliseconds per launch (CUDA events, time_kernels.time_ms) at
the float64 pair shapes of time_kernels.JET_SHAPES_F64, all variants in
turns in one process (forward, then in reverse order), beside the general
body in double, with whether each variant that keeps the results equals
the general body bit for bit.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
from pathlib import Path

from deepsolid_tpu_torch.ops.cuda import build
from deepsolid_tpu_torch.ops.cuda import jet_kernels as jk
from deepsolid_tpu_torch.ops.cuda.time_kernels import (
    JET_SHAPES_F64, jet_launcher, same_bits, time_ms)

OUT = Path("build") / "pair_variants"
KEEP_RESULTS = ("current", "staged", "stages4")
STAGED_STORE = """  auto store_plane = [&](double* __restrict__ dst, const double (&v)[4][4],
                         int row0) {
    __syncwarp();  // the last plane's read-back is done
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      double* mine = out_s + (rg + 4 * i) * kPC + 2 * cg;
      *reinterpret_cast<double2*>(mine) = make_double2(v[i][0], v[i][1]);
      *reinterpret_cast<double2*>(mine + 16) = make_double2(v[i][2], v[i][3]);
    }
    __syncwarp();
    const int r = lane >> 4;
    const int c = (lane & 15) * 2;
#pragma unroll
    for (int m = 0; m < kPRowsD / 2; ++m) {
      const int rr = 2 * m + r;
      const double2 x = *reinterpret_cast<const double2*>(out_s + rr * kPC + c);
      if (row0 + rr < R) {
        *reinterpret_cast<double2*>(dst + static_cast<size_t>(row0 + rr) * kPC + c) = x;
      }
    }
  };
"""


def _sub(text: str, old: str, new: str) -> str:
    assert text.count(old) == 1, old
    return text.replace(old, new)


def variants() -> dict:
    src = (build.CSRC / "dense_tanh_jet.cu").read_text()
    cut = src.index("constexpr int kPStagesD = 3;")
    head, body = src[:cut], src[cut:]
    store_from = body.index("  auto store_plane = [&](double* __restrict__ dst,")
    store_to = body.index("  };\n", store_from) + len("  };\n")
    staged = body[:store_from] + STAGED_STORE + body[store_to:]
    staged = _sub(staged, "kWarpDoubles = kPStagesD * kStage;",
                  "kWarpDoubles = kPStagesD * kStage + kPRowsD * kPC;")
    staged = _sub(staged, "warp * Tile::kWarpDoubles;\n",
                  "warp * Tile::kWarpDoubles;\n"
                  "  double* out_s = ring + kPStagesD * Tile::kStage;\n")
    return {
        "current": src,
        "staged": head + staged,
        "stages4": head + _sub(body, "constexpr int kPStagesD = 3;",
                               "constexpr int kPStagesD = 4;"),
        "no_fma": head + _sub(
            body, "for (int j = 0; j < 4; ++j) acc[i][j] = fma(av, wv[j], acc[i][j]);",
            "for (int j = 0; j < 4; ++j) acc[i][j] = av;"),
    }


def main() -> None:
    import torch

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants().items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(OUT / f"lib{name}.so"), str(OUT / f"{name}.cu")],
            stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, log = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log[-3000:]}")
        print(json.dumps({"variant": name, "resources": [
            r for r in build.resources(log) if "pair_double" in r["kernel"]]}), flush=True)
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        for fn, (restype, argtypes) in jk._SIGNATURES.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi}), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float64)

    for t_dim, rows, d_in, d_out, mixed, open_sum, _ in JET_SHAPES_F64:
        if not jk.pair_body(d_in, d_out, mixed):
            continue
        args = (rnd(rows, d_in), rnd(t_dim, rows, d_in), rnd(rows, d_in),
                rnd(d_in, d_out) / math.sqrt(d_in), rnd(d_out))
        launchers = {name: jet_launcher(lib, jk.PAIR, *args, None, open_sum)
                     for name, lib in libs.items()}
        launchers["general"] = jet_launcher(libs["current"], 0, *args, None, open_sum)
        ms = {name: [] for name in launchers}
        for order in (list(launchers), list(reversed(launchers))):
            for name in order:
                ms[name].append(time_ms(launchers[name]))
        bits = {}
        for name in KEEP_RESULTS:
            launchers[name]()
            launchers["general"]()
            bits[name] = same_bits(launchers[name], launchers["general"])
        print(json.dumps({"T": t_dim, "rows": rows, "d_in": d_in, "open": open_sum,
                          "ms": ms, "same_bits_as_general": bits}), flush=True)
        del args, launchers
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
