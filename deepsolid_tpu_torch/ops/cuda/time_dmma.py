"""Times the FP64 tensor-core shapes of mma.sync on the card.

    python -m deepsolid_tpu_torch.ops.cuda.time_dmma [--reps N]

On a CUDA machine, a micro-kernel per .f64 shape that PTX offers sm_90a
(m8n8k4, m16n8k4, m16n8k8, m16n8k16), one JSON line each. Each shape is
first held against a float64 product on the card (its fragment layout:
`layout_ok`), then timed in a loop that keeps 8 independent accumulator
tiles per warp in registers (no memory traffic): TFLOP/s beside the
H100's 67 TFLOP/s FP64 tensor peak. csrc/dense_tanh_jet.cu's float64 wide
body uses m16n8k4 on these readings. Builds go to build/time_dmma/
(gitignored).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

from deepsolid_tpu_torch.ops.cuda import build
from deepsolid_tpu_torch.ops.cuda.time_kernels import time_ms

OUT = build.HERE.parents[2] / "build" / "time_dmma"
SHAPES = (884, 1684, 1688, 16816)
# (m, k) of each shape; n is 8
MK = {884: (8, 4), 1684: (16, 4), 1688: (16, 8), 16816: (16, 16)}
PEAK_FP64_TENSOR = 67e12  # H100 SXM, NVIDIA data sheet, 700 W

MICRO = r"""
#include <cuda_runtime.h>

// a_i = A[g + 8 (i % 2)][t + 4 (i / 2)], b_i = B[t + 4 i][g] (m16 shapes),
// a = A[g][t], b = B[t][g] (m8n8k4); c_i = D[g + 8 (i / 2)][2 t + i % 2]
template <int S>
__device__ __forceinline__ void mma(double (&c)[4], const double* a, const double* b) {
  if constexpr (S == 884) {
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
                 : "+d"(c[0]), "+d"(c[1]) : "d"(a[0]), "d"(b[0]));
  } else if constexpr (S == 1684) {
    asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3]) : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  } else if constexpr (S == 1688) {
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  } else {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
                   "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
}

template <int S> struct Dims {
  static constexpr int M = S == 884 ? 8 : 16;
  static constexpr int K = S == 884 ? 4 : S == 1684 ? 4 : S == 1688 ? 8 : 16;
  static constexpr int NA = M * K / 32;  // A values a lane holds
  static constexpr int NB = K / 4;       // B values a lane holds
};

// D (M x 8) = A (M x K, row-major) B (K x 8, row-major), one warp
template <int S>
__global__ void check_kernel(const double* A, const double* B, double* D) {
  using Dm = Dims<S>;
  const int g = threadIdx.x >> 2, t = threadIdx.x & 3;
  double a[8], b[4], c[4] = {0, 0, 0, 0};
  if (Dm::M == 8) {
    a[0] = A[g * Dm::K + t];
  } else {
    for (int i = 0; i < Dm::NA; ++i) a[i] = A[(g + 8 * (i % 2)) * Dm::K + t + 4 * (i / 2)];
  }
  for (int i = 0; i < Dm::NB; ++i) b[i] = B[(t + 4 * i) * 8 + g];
  mma<S>(c, a, b);
  for (int i = 0; i < (Dm::M == 8 ? 2 : 4); ++i) D[(g + 8 * (i / 2)) * 8 + 2 * t + i % 2] = c[i];
}

// 8 independent accumulator tiles per warp, `iters` rounds, operands in registers
template <int S>
__global__ void bench_kernel(double* out, int iters) {
  double a[8], b[4], c[8][4];
  for (int i = 0; i < 8; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < 4; ++i) b[i] = 1e-3 * (threadIdx.x - i);
  for (int q = 0; q < 8; ++q) for (int i = 0; i < 4; ++i) c[q][i] = 0.0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int q = 0; q < 8; ++q) mma<S>(c[q], a, b);
  }
  double s = 0.0;
  for (int q = 0; q < 8; ++q) for (int i = 0; i < 4; ++i) s += c[q][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" {
int check(int shape, const void* A, const void* B, void* D) {
  const auto* a = static_cast<const double*>(A);
  const auto* b = static_cast<const double*>(B);
  auto* d = static_cast<double*>(D);
  switch (shape) {
    case 884: check_kernel<884><<<1, 32>>>(a, b, d); break;
    case 1684: check_kernel<1684><<<1, 32>>>(a, b, d); break;
    case 1688: check_kernel<1688><<<1, 32>>>(a, b, d); break;
    default: check_kernel<16816><<<1, 32>>>(a, b, d);
  }
  return static_cast<int>(cudaGetLastError());
}
int bench(int shape, void* out, int blocks, int threads, int iters) {
  auto* o = static_cast<double*>(out);
  switch (shape) {
    case 884: bench_kernel<884><<<blocks, threads>>>(o, iters); break;
    case 1684: bench_kernel<1684><<<blocks, threads>>>(o, iters); break;
    case 1688: bench_kernel<1688><<<blocks, threads>>>(o, iters); break;
    default: bench_kernel<16816><<<blocks, threads>>>(o, iters);
  }
  return static_cast<int>(cudaGetLastError());
}
const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
}
"""


def micro(lib, reps: int) -> None:
    import torch

    _P, _I = ctypes.c_void_p, ctypes.c_int
    lib.check.restype = lib.bench.restype = _I
    lib.check.argtypes = [_I, _P, _P, _P]
    lib.bench.argtypes = [_I, _P, _I, _I, _I]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, threads, iters = 8 * sms, 128, 4096
    out = torch.empty(blocks * threads, dtype=torch.float64, device=dev)
    for shape in SHAPES:
        m, k = MK[shape]
        a = torch.randn((m, k), generator=gen, device=dev, dtype=torch.float64)
        b = torch.randn((k, 8), generator=gen, device=dev, dtype=torch.float64)
        d = torch.empty((m, 8), dtype=torch.float64, device=dev)
        build.check(lib, lib.check(shape, a.data_ptr(), b.data_ptr(), d.data_ptr()),
                    f"check {shape}")
        err = float((d - a @ b).abs().max())

        def run():
            build.check(lib, lib.bench(shape, out.data_ptr(), blocks, threads, iters),
                        f"bench {shape}")

        ms = time_ms(run, warmup=2, reps=reps)
        flops = 2.0 * m * 8 * k * 8 * iters * blocks * threads / 32
        print(json.dumps({"part": "micro", "shape": f"m{m}n8k{k}", "layout_ok": err <= 1e-12,
                          "max_abs_err": err, "ms": ms, "tflops": flops / ms / 1e9,
                          "of_peak": flops / ms / 1e9 / (PEAK_FP64_TENSOR / 1e12),
                          "warps_per_sm": blocks * threads // 32 // sms}), flush=True)


def main() -> None:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    OUT.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}),
          flush=True)
    src = OUT / "dmma_micro.cu"
    src.write_text(MICRO)
    lib = OUT / "libdmma_micro.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True)
    micro(ctypes.CDLL(str(lib)), args.reps)


if __name__ == "__main__":
    main()
