"""Times the Gauss-Jordan kernel's mid body beside variants of it, on a CUDA machine.

    python -m deepsolid_tpu_torch.ops.cuda.time_gj_variants [--complex128]

Each variant is csrc/gj_inverse.cu with one change made by text
substitution, built with build.py's flags into build/gj_variants/ under
the working directory. The complex64 mid body's variants:
  persistent     - one block per resident slot instead of one per matrix:
                   each block walks the batch and copies its next matrix
                   into a second tile while it eliminates the current one;
  one_block      - one block per SM (dynamic shared memory raised to 120 KB);
  no_update_fma  - the 36 complex updates of a step cut to one add
                   (wrong results: the time of everything else);
  no_search      - the pivot fixed at row k (wrong where a swap is due):
                   the time without the per-warp search;
  no_barrier_one - the barrier after column k is published removed (wrong
                   results): what that barrier costs.
With --complex128, the complex128 mid body's (gj_mid_double_kernel):
  no_update_fma  - the 36 complex updates of a step cut to one add;
  no_search      - the pivot fixed at row k;
  no_barrier_one - the barrier after column k is published removed;
  no_division    - the pivot row's owners take 1 / |piv|^2 as piv's real
                   part (wrong results): what the division costs;
  row_guard      - a lane skips the update of its padding rows (row >= n:
                   at n = 81 every warp but the first skips one of its six
                   row tiles).
Times are per launch from a CUDA graph of launches (time_kernels.graph_ms)
at bcc-Li 3x3x3's (4096, 81, 81) and (256, 81, 81) (complex128: the
psi_chunk 512 and 256 sampler shapes and the el_chunk 16 E_L shape), all
variants in turns in one process, with log|det| against the plain version
for the variants that keep the results.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
from pathlib import Path

from deepsolid_tpu_torch.ops.cuda import build
from deepsolid_tpu_torch.ops.cuda import det_kernels as dk
from deepsolid_tpu_torch.ops.cuda.time_kernels import gj_launcher, graph_ms

OUT = Path("build") / "gj_variants"
KEEP_RESULTS = ("current", "persistent", "one_block")
ATTRIBUTE = """gj_mid_kernel<kMidN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));"""


def _sub(text: str, old: str, new: str) -> str:
    assert old in text, old
    return text.replace(old, new)


def variants() -> dict:
    src = (build.CSRC / "gj_inverse.cu").read_text()
    cut = src.index("gj_mid_kernel(const float2")
    head, mid = src[:cut], src[cut:]
    launch = "gj_mid_kernel<kMidN><<<batch, kMidThreads, smem, st>>>(ap, ip, sp, lp, n);"
    wide = "gj_mid_kernel<kMidWideN><<<batch, kMidThreads, smem, st>>>(ap, ip, sp, lp, n);"

    pers = _sub(mid, "              int n) {", "              int n, int batch) {")
    pers = _sub(pers, """  const size_t base = static_cast<size_t>(blockIdx.x) * nn;

  for (int e = tid; e < nn; e += kMidThreads) {
    const int i = e / n;
    cp_async8(tile + i * ld + e - i * n, a + base + e);
  }
  cp_async_wait_all();
  __syncthreads();""", """  float2* next = tile + n * ld;
  for (int e = tid; e < nn; e += kMidThreads) {
    const int i = e / n;
    cp_async8(next + i * ld + e - i * n, a + static_cast<size_t>(blockIdx.x) * nn + e);
  }
  for (int mat = blockIdx.x; mat < batch; mat += gridDim.x) {
  const size_t base = static_cast<size_t>(mat) * nn;
  cp_async_wait_all();
  __syncthreads();""")
    pers = _sub(pers, "? tile[row * ld + col] : make_float2(0.f, 0.f);\n    }\n  }\n",
                "? next[row * ld + col] : make_float2(0.f, 0.f);\n    }\n  }\n"
                "  __syncthreads();\n"
                "  if (mat + static_cast<int>(gridDim.x) < batch) {\n"
                "    const size_t nb = static_cast<size_t>(mat + gridDim.x) * nn;\n"
                "    for (int e = tid; e < nn; e += kMidThreads) {\n"
                "      const int i = e / n;\n"
                "      cp_async8(next + i * ld + e - i * n, a + nb + e);\n    }\n  }\n")
    pers = _sub(pers, """    sign_out[blockIdx.x] = sign;
    logdet_out[blockIdx.x] = logdet;
  }
}""", """    sign_out[mat] = sign;
    logdet_out[mat] = logdet;
  }
  }
}""")
    # two tiles a block, and the largest carveout so that two blocks fit an SM
    pers = _sub(pers, ATTRIBUTE, ATTRIBUTE.replace("(smem)", "(2 * smem)") + """
      if (err == cudaSuccess) {
        cudaFuncSetAttribute(gj_mid_kernel<kMidN>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
      }""")
    pers = _sub(pers, launch, """int per_sm = 0, sms = 0, dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gj_mid_kernel<kMidN>,
                                                    kMidThreads, 2 * smem);
      const int grid = batch < per_sm * sms ? batch : per_sm * sms;
      gj_mid_kernel<kMidN><<<grid, kMidThreads, 2 * smem, st>>>(ap, ip, sp, lp, n, batch);""")
    # the wide instantiation takes the new signature too (not timed here)
    pers = _sub(pers, wide, wide.replace("lp, n)", "lp, n, batch)"))

    one = _sub(mid, launch, launch.replace("smem, st", "120000, st"))
    one = _sub(one, ATTRIBUTE, ATTRIBUTE.replace("static_cast<int>(smem)", "120000"))

    search_from = mid.index("      unsigned key[N / 32];")
    search_to = mid.index("      const float2 bval = fcol[buf][brow];")
    return {
        "current": src,
        "persistent": head + pers,
        "one_block": head + one,
        "no_update_fma": head + _sub(
            mid, """          m[i][j].x = fmaf(f.y, pr[j].y, fmaf(-f.x, pr[j].x, m[i][j].x));
          m[i][j].y = fmaf(-f.y, pr[j].x, fmaf(-f.x, pr[j].y, m[i][j].y));""",
            "          m[i][j].x += f.x;"),
        "no_search": head + mid[:search_from]
        + "      const int bpos = k, brow = k;\n" + mid[search_to:],
        "no_barrier_one": head + _sub(
            mid, "__syncthreads();  // one: column k is published", ""),
    }


def variants_c128() -> dict:
    src = (build.CSRC / "gj_inverse.cu").read_text()
    cut = src.index("gj_mid_double_kernel(const double2")
    head, mid = src[:cut], src[cut:]
    search_from = mid.index("      unsigned long long key[Q];")
    search_to = mid.index("      const double2 bval = fcol[buf][brow];")
    return {
        "current": src,
        "no_update_fma": head + _sub(
            mid, """          m[i][j].x = fma(f.y, pr[j].y, fma(-f.x, pr[j].x, m[i][j].x));
          m[i][j].y = fma(-f.y, pr[j].x, fma(-f.x, pr[j].y, m[i][j].y));""",
            "          m[i][j].x += f.x;"),
        "no_search": head + mid[:search_from]
        + "      const int bpos = k, brow = k;\n" + mid[search_to:],
        "no_barrier_one": head + _sub(
            mid, "__syncthreads();  // one: column k is published", ""),
        "no_division": head + _sub(
            mid, "const double inv_den = 1.0 / (bval.x * bval.x + bval.y * bval.y);",
            "const double inv_den = bval.x;"),
        "row_guard": head + _sub(
            mid, "        const double2 f = row == brow ? make_double2(0.0, 0.0)",
            "        if (row >= n) continue;\n"
            "        const double2 f = row == brow ? make_double2(0.0, 0.0)"),
    }


def main() -> None:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--complex128", action="store_true")
    c128 = parser.parse_args().complex128
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in (variants_c128() if c128 else variants()).items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"),
             str(OUT / f"{name}.cu")])
    libs = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        for fn, (restype, argtypes) in dk._SIGNATURES.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi}), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = ((4096, 81), (2048, 81), (128, 81)) if c128 else ((4096, 81), (256, 81))
    keep = ("current", "row_guard") if c128 else KEEP_RESULTS
    for nb, n in shapes:
        a = torch.complex(torch.randn(nb, n, n, generator=gen, device=dev),
                          torch.randn(nb, n, n, generator=gen, device=dev)) / math.sqrt(2 * n)
        if c128:
            a = a.to(torch.complex128)
        launchers = {name: gj_launcher(lib, a) for name, lib in libs.items()}
        ms = {name: [] for name in libs}
        for order in (list(libs), list(reversed(libs))):
            for name in order:
                ms[name].append(graph_ms(launchers[name]))
        want = dk.gj_inverse_slogdet_plain(a)[2]
        err = {}
        for name in keep:
            launchers[name]()
            err[name] = float((launchers[name].outputs[2] - want).abs().max())
        print(json.dumps({"shape": [nb, n, n], "dtype": str(a.dtype)[6:], "graph_ms": ms,
                          "max_abs_err_logdet": err}), flush=True)


if __name__ == "__main__":
    main()
