"""csrc/dethead_trace.cu itself, run on the CPU against its plain version.

The CUDA source is compiled with g++ against a small stand-in for the CUDA
runtime (below): one std::thread per CUDA thread, a std::barrier for
__syncthreads, warp barriers for the shuffles, shared memory filled with
garbage. Its index arithmetic, its barriers between the shared buffers'
writers and readers, the tangent split and the fixed-order sums are so
tested on every run of the suite; the card tests
(tests/test_torch_cuda_kernels.py) hold the compiled kernel to the same
plain version. A data race shows here as a wrong answer, since the
threads really run at once. Tolerances as on the card: float32 2e-5 of
the scale, float64 1e-12.
"""

import ctypes
import re
import shutil
import subprocess

import pytest
import torch

from deepsolid_tpu_torch.ops.cuda import build
from deepsolid_tpu_torch.ops.cuda import dethead_kernels as dh

RUNTIME = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x)
#define __restrict__
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct double2 { double x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline double2 make_double2(double a, double b) { return {a, b}; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
struct uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local uint3 threadIdx, blockIdx;
inline uint3 blockDim;
struct Block {
  std::barrier<>* all;
  std::vector<std::unique_ptr<std::barrier<>>>* warps;
  double* lanes;
  unsigned char* smem;
};
inline thread_local Block block;
inline void __syncthreads() { block.all->arrive_and_wait(); }
template <class T>
T __shfl_down_sync(unsigned, T v, int off) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto& w = *(*block.warps)[warp];
  double* buf = block.lanes + 32 * warp;
  w.arrive_and_wait();
  buf[lane] = static_cast<double>(v);
  w.arrive_and_wait();
  const T out = lane + off < 32 ? static_cast<T>(buf[lane + off]) : v;
  w.arrive_and_wait();
  return out;
}
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
using std::min;
// the blocks one after another, each block's threads at once
template <class F>
void emulate(dim3 grid, unsigned threads, size_t smem, F body) {
  blockDim = {threads, 1, 1};
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::vector<unsigned char> shared(smem, 0xCD);
      std::barrier<> all(threads);
      std::vector<std::unique_ptr<std::barrier<>>> warps;
      for (unsigned w = 0; w < threads / 32; ++w) warps.emplace_back(new std::barrier<>(32));
      std::vector<double> lanes(threads);
      std::vector<std::thread> pool;
      for (unsigned t = 0; t < threads; ++t)
        pool.emplace_back([&, t] {
          threadIdx = {t, 0, 0};
          blockIdx = {bx, by, 0};
          block = {&all, &warps, lanes.data(), shared.data()};
          body();
        });
      for (auto& th : pool) th.join();
    }
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    src = (build.CSRC / "dethead_trace.cu").read_text()
    shared = "extern __shared__ __align__(16) unsigned char smem_raw[];"
    assert shared in src
    src = src.replace(shared, "unsigned char* smem_raw = block.smem;")
    # kernel<<<grid, threads, smem, stream>>>(args); -> emulate(grid, threads, smem, ...)
    launch = re.search(r"(dethead_trace_kernel<R, TC>)<<<(grid), (.*?), (smem_bytes<R, TC>\(n\)), "
                       r"st>>>\((.*?)\);", src, re.S)
    assert launch, "the kernel's launch is not where this test looks for it"
    kernel, grid, threads, smem, args = launch.groups()
    src = (src[:launch.start()] + f"emulate({grid}, {threads}, {smem}, [&] {{ {kernel}({args}); }});"
           + src[launch.end():])
    out = tmp_path_factory.mktemp("dethead_emulated")
    (out / "cuda_runtime.h").write_text(RUNTIME)
    (out / "dethead_trace.cpp").write_text(src)
    lib_path = out / "libdethead_emulated.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-w",
                    f"-I{out}", "-o", str(lib_path), str(out / "dethead_trace.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn, (restype, argtypes) in dh._SIGNATURES.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


# (n, determinants, walkers, offset, (t0, T_loc) or None for the whole
# axis, splits, jbc): windows that cut a channel's slab, a split closed by
# the caller's sum, 4 x 4 tiles with padding (n = 5, 9), whole warps
# (16), 6-column tiles (90, complex64), the largest complex128 (84), and
# complex64's 8-column tiles with M_t staged over J_t: the first (97, a
# padded tile), Si 2x2x2's 112 (a slab row inside the window, split) and
# the largest (119)
CASES = {
    "n5": (5, 2, 2, 0, None, 1, True),
    "n9_window_split": (9, 2, 1, 4, (10, 9), 3, True),
    "n16_window": (16, 1, 2, 17, (48, 10), 2, False),
    "n90": (90, 1, 1, 30, (88, 3), 1, True),
    "n84": (84, 1, 1, 0, (0, 2), 1, True),
    "n97": (97, 1, 1, 0, (0, 2), 1, True),
    "n112_window_split": (112, 1, 1, 112, (335, 4), 2, True),
    "n119": (119, 1, 1, 0, (356, 2), 1, False),
}


@pytest.mark.parametrize("case,real", [
    pytest.param(case, real, id=f"{case}-{name}")
    for case in CASES for real, name in ((torch.float32, "f32"), (torch.float64, "f64"))
    if CASES[case][0] <= dh.MAX_N[real]])  # complex128 serves n <= 84
def test_kernel_source_matches_plain(emulated, case, real):
    n, ndet, batch, offset, window, splits, with_jbc = CASES[case]
    gen = torch.Generator().manual_seed(n + offset)
    cplx = dh._COMPLEX[real]
    t0, t_loc = window or (0, 3 * (offset + n + 2))

    def rnd(*shape, dtype=real):
        return torch.randn(shape, generator=gen, dtype=dtype)

    mat = (batch, ndet, n, n)
    jr, jbc = rnd(t_loc, batch, n, 2 * ndet * n), rnd(t_loc, batch, 2 * ndet * n)
    jbc = jbc if with_jbc else None
    ep_val, ep_jac3 = rnd(*mat, dtype=cplx), rnd(3, *mat, dtype=cplx)
    orb_val0, a_inv = rnd(*mat, dtype=cplx), rnd(*mat, dtype=cplx) / n**0.5
    trb = torch.empty(t_loc, batch, ndet, dtype=cplx)
    l2 = torch.empty(splits, batch, ndet, dtype=cplx)
    entry = (emulated.dethead_trace_launch_c128 if real == torch.float64
             else emulated.dethead_trace_launch)
    assert entry(jr.data_ptr(), None if jbc is None else jbc.data_ptr(), ep_val.data_ptr(),
                 ep_jac3.data_ptr(), orb_val0.data_ptr(), a_inv.data_ptr(), trb.data_ptr(),
                 l2.data_ptr(), n, ndet, batch, t_loc, splits, offset, t0, None) == 0
    want_trb, want_l2 = dh.dethead_traces_plain(jr, jbc, ep_val, ep_jac3, orb_val0, a_inv,
                                                offset, t0)
    tol = 2e-5 if real == torch.float32 else 1e-12
    for got, want in ((trb, want_trb), (l2.sum(0), want_l2)):
        torch.testing.assert_close(got, want, rtol=0, atol=tol * float(want.abs().max()))
    assert emulated.dethead_max_n(int(real == torch.float64)) == dh.MAX_N[real]


def test_dispatch_keeps_the_instantiations_up_to_96(emulated):
    # the tile a launch instantiates, as the library's dispatch picks it:
    # up to n = 96 the two complex64 tiles of before (4 columns to 84, 6
    # to 96), 8 columns with M_t over J_t from 97 to 119; complex128 4
    # columns to 84; 0 where nothing serves n
    for n in range(1, 97):
        assert emulated.dethead_tile_cols(n, 0) == (4 if n <= 84 else 6), n
        assert dh.BODIES[torch.float32, emulated.dethead_tile_cols(n, 0)] == "complex64"
    for n in range(97, 120):
        assert emulated.dethead_tile_cols(n, 0) == 8, n
        assert dh.BODIES[torch.float32, 8] == dh.BODY_C64_STAGED
    for n in range(1, 85):
        assert emulated.dethead_tile_cols(n, 1) == 4, n
    for n, is_double in ((0, 0), (120, 0), (128, 0), (85, 1), (112, 1)):
        assert emulated.dethead_tile_cols(n, is_double) == 0, (n, is_double)
    assert dh.MAX_N == {torch.float32: 119, torch.float64: 84}
    assert dh.serves(112, torch.float32, torch.device("cuda"))
    assert not dh.serves(112, torch.float64, torch.device("cuda"))


@pytest.mark.parametrize("n,real", [(120, torch.float32), (128, torch.float32),
                                    (85, torch.float64)])
def test_launch_refuses_past_the_largest_n(emulated, n, real):
    # checked before any pointer is read: cudaErrorInvalidValue
    entry = (emulated.dethead_trace_launch_c128 if real == torch.float64
             else emulated.dethead_trace_launch)
    assert entry(None, None, None, None, None, None, None, None, n, 1, 1, 2, 1, 0, 0,
                 None) == 1
