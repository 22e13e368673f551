"""csrc/dethead_trace.cu itself, run on the CPU against its plain version.

The CUDA source is compiled with g++ against a small stand-in for the CUDA
runtime (below): one std::thread per CUDA thread, a std::barrier for
__syncthreads, warp barriers for the shuffles, shared memory filled with
garbage; the source's PTX block (the complex128 body's mma.sync m16n8k4
.f64, bulk copies and mbarriers) is replaced by plain C++: the product
through the warp's lanes in the fragment layout time_dmma.py checked on
an H100 (a_i = A[g + 8 i][t], b = B[t][g], c_i = D[g + 8 (i / 2)][2 t +
i % 2], g = lane / 4, t = lane % 4), the copies done at once, a barrier's
phase completed when its arrivals and announced bytes are in. Its index
arithmetic, its barriers between the shared buffers' writers and readers,
the tangent split and the fixed-order sums are so tested on every run of
the suite; the card tests
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
#include "cuda.h"
#include <barrier>
#include <cassert>
#include <cmath>
#include <condition_variable>
#include <cstddef>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x)
#define __restrict__
#define __grid_constant__
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
  double* mma;  // a warp's fragments: a_0, a_1, b of its 32 lanes
  unsigned char* smem;
};
inline thread_local Block block;
inline void __syncthreads() { block.all->arrive_and_wait(); }
inline void __syncwarp() { (*block.warps)[threadIdx.x >> 5]->arrive_and_wait(); }
inline int atomicAdd(int* at, int v) { return __atomic_fetch_add(at, v, __ATOMIC_SEQ_CST); }
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
template <class T>
T __shfl_sync(unsigned, T v, int src) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto& w = *(*block.warps)[warp];
  double* buf = block.lanes + 32 * warp;
  w.arrive_and_wait();
  buf[lane] = static_cast<double>(v);
  w.arrive_and_wait();
  const T out = static_cast<T>(buf[src]);
  w.arrive_and_wait();
  return out;
}
// the source's PTX block: D += A B over the warp's fragments, each entry
// an FMA chain over k in order
inline void dmma_m16n8k4(double (&c)[4], double a0, double a1, double b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto& w = *(*block.warps)[warp];
  double* buf = block.mma + 96 * warp;
  w.arrive_and_wait();
  buf[lane] = a0;
  buf[32 + lane] = a1;
  buf[64 + lane] = b;
  w.arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i / 2), col = 2 * t + i % 2;
    for (int k = 0; k < 4; ++k)  // A[row][k]: lane 4 (row % 8) + k; B[k][col]: lane 4 col + k
      c[i] = std::fma(buf[32 * (row / 8) + 4 * (row % 8) + k], buf[64 + 4 * col + k], c[i]);
  }
  w.arrive_and_wait();
}
// a barrier of the copy engine: `count` arrivals and the announced bytes
// complete a phase; the copies land at once
struct Phase {
  unsigned count, pending, phase;
  long long bytes;
};
inline std::mutex phase_lock;
inline std::condition_variable phase_done;
inline std::map<const void*, Phase> phases;
inline void settle(Phase& ph) {
  if (ph.pending == 0 && ph.bytes == 0) {
    ++ph.phase;
    ph.pending = ph.count;
    phase_done.notify_all();
  }
}
inline void mbar_init(unsigned long long* bar, unsigned count) {
  std::lock_guard<std::mutex> hold(phase_lock);
  phases[bar] = {count, count, 0, 0};
}
inline void mbar_expect(unsigned long long* bar, unsigned bytes) {
  std::lock_guard<std::mutex> hold(phase_lock);
  Phase& ph = phases.at(bar);
  ph.bytes += bytes;
  --ph.pending;
  settle(ph);
}
inline void bulk_load(void* dst, const void* src, unsigned bytes, unsigned long long* bar) {
  // the copy engine's rules: 16-byte ends on both sides
  assert((static_cast<unsigned char*>(dst) - block.smem) % 16 == 0);
  assert(reinterpret_cast<size_t>(src) % 16 == 0 && bytes % 16 == 0);
  std::memcpy(dst, src, bytes);
  std::lock_guard<std::mutex> hold(phase_lock);
  Phase& ph = phases.at(bar);
  ph.bytes -= bytes;
  settle(ph);
}
inline void mbar_arrive(unsigned long long* bar) {
  std::lock_guard<std::mutex> hold(phase_lock);
  Phase& ph = phases.at(bar);
  --ph.pending;
  settle(ph);
}
inline void fence_async_shared() {}
inline void tensor_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                           unsigned long long* bar) {
  // the copy engine's rules: 128-byte aligned in shared memory, a box
  // starting on a 16-byte column, a whole number of 16 bytes a row
  assert((static_cast<unsigned char*>(dst) - block.smem) % 128 == 0);
  assert(c0 % 2 == 0 && map->box_cols % 2 == 0);
  double* out = static_cast<double*>(dst);
  for (unsigned r = 0; r < map->box_rows; ++r)
    for (unsigned c = 0; c < map->box_cols; ++c) {
      const unsigned long long row = c1 + r, col = c0 + c;
      *out++ = row < map->rows && col < map->cols ? map->base[row * map->cols + col] : 0.0;
    }
  std::lock_guard<std::mutex> hold(phase_lock);
  Phase& ph = phases.at(bar);
  ph.bytes -= 8ll * map->box_rows * map->box_cols;
  settle(ph);
}
inline bool rows_map(CUtensorMap* map, const double* base, unsigned long long cols,
                     unsigned long long rows, unsigned box_cols, unsigned box_rows) {
  *map = {base, cols, rows, box_cols, box_rows};
  return true;
}
inline void mbar_wait(unsigned long long* bar, unsigned parity) {
  std::unique_lock<std::mutex> hold(phase_lock);
  phase_done.wait(hold, [&] { return (phases.at(bar).phase & 1) != parity; });
}
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F, int, size_t) {
  *blocks = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
using std::max;
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
      std::vector<double> lanes(threads), mma(3 * threads);
      std::vector<std::thread> pool;
      for (unsigned t = 0; t < threads; ++t)
        pool.emplace_back([&, t] {
          threadIdx = {t, 0, 0};
          blockIdx = {bx, by, 0};
          block = {&all, &warps, lanes.data(), mma.data(), shared.data()};
          body();
        });
      for (auto& th : pool) th.join();
    }
}
"""


# cuda.h's stand-in: a tensor description the copy engine's stand-in reads
CUDA_H = r"""
#pragma once
struct CUtensorMap {
  const double* base;
  unsigned long long cols, rows;
  unsigned box_cols, box_rows;
};
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    src = (build.CSRC / "dethead_trace.cu").read_text()
    src, shared = re.subn(r"extern __shared__ __align__\(\d+\) unsigned char (\w+)\[\];",
                          r"unsigned char* \1 = block.smem;", src)
    assert shared == 2, "the kernels' shared memory is not where this test looks for it"
    ptx = re.search(r"\n// ---- PTX:.*?\n// ---- end of PTX\n", src, re.S)
    assert ptx, "the source's PTX block is not where this test looks for it"
    src = src[:ptx.start()] + "\n" + src[ptx.end():]
    # kernel<<<grid, threads, smem, stream>>>(args); -> emulate(grid, threads, smem, ...)
    src, launches = re.subn(
        r"(dethead_trace_kernel\w*(?:<[\w, ]+>)?)<<<(grid), (.*?), (.*?), st>>>\((.*?)\);",
        lambda l: "emulate({1}, {2}, {3}, [&] {{ {0}({4}); }});".format(*l.groups()), src,
        flags=re.S)
    assert launches == 2, "the kernels' launches are not where this test looks for them"
    out = tmp_path_factory.mktemp("dethead_emulated")
    (out / "cuda_runtime.h").write_text(RUNTIME)
    (out / "cuda.h").write_text(CUDA_H)
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
# the largest (119). complex128 on the FMA body at 5, 9, 16 and on the
# tensor-core body at C-diamond's 48 (three pairs and two diagonal warps,
# a slab row in the window, split), 49 without jbc (odd, a second
# determinant: its boxes start a column early), 60 (four blocks a side,
# two slots a warp), bcc-Li's 81 (five slots a warp; a half-empty last
# block column; the slab row at the window's start) and 84 (a partial
# last slab)
CASES = {
    "n5": (5, 2, 2, 0, None, 1, True),
    "n9_window_split": (9, 2, 1, 4, (10, 9), 3, True),
    "n16_window": (16, 1, 2, 17, (48, 10), 2, False),
    "n48_window_split": (48, 2, 1, 48, (142, 4), 2, True),
    "n81_window": (81, 1, 1, 81, (243, 3), 1, True),
    "n49_no_jbc": (49, 2, 1, 0, (0, 2), 1, False),
    "n60_window": (60, 1, 1, 60, (180, 2), 1, True),
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
    # the body a launch takes, as the library's dispatch picks it: up to
    # n = 96 the two complex64 tiles of before (4 columns to 84, 6 to 96),
    # 8 columns with M_t over J_t from 97 to 119; complex128 the tensor-core
    # body (16 x 16 blocks) at 46-49 and 58-84, the FMA body's 4 columns at
    # the other n up to 84, where the card timed it faster; 0 where nothing
    # serves n
    for n in range(1, 97):
        assert emulated.dethead_tile_cols(n, 0) == (4 if n <= 84 else 6), n
        assert dh.BODIES[torch.float32, emulated.dethead_tile_cols(n, 0)] == "complex64"
    for n in range(97, 120):
        assert emulated.dethead_tile_cols(n, 0) == 8, n
        assert dh.BODIES[torch.float32, 8] == dh.BODY_C64_STAGED
    for n in range(1, 85):
        tensor_cores = 46 <= n <= 49 or n >= 58
        assert emulated.dethead_tile_cols(n, 1) == (16 if tensor_cores else 4), n
    assert dh.BODIES[torch.float64, 4] == dh.BODY_C128_FMA == "complex128"
    assert dh.BODIES[torch.float64, 16] == dh.BODY_C128 == "complex128, tensor cores"
    assert set(dh.BODIES.values()) == {dh.BODY_C64, dh.BODY_C64_STAGED, dh.BODY_C128_FMA,
                                       dh.BODY_C128}
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
