// Batched complex64 Gauss-Jordan inverse + slogdet for Hopper (sm_90a).
//
// Replaces the TPU kernel deepsolid_tpu/ops/pallas/det_kernels.py
// (_gj_kernel, launched by _gj_flat through gj_inverse_slogdet), which
// laid the matrix batch across the 128 vector lanes of a TPU core.
//
// What it computes, per matrix A (n x n): A^-1, sign = prod piv/|piv| *
// (-1)^swaps and log|det A| = sum 0.5 log|piv|^2. The pivot at step k is
// the largest |A[r, k]|^2 among the unused rows r >= k of the row-swapped
// matrix, the smallest r on a tie (the TPU kernel's rule); a column whose
// unused entries are all NaN takes row k. A zero pivot gives log 0 = -inf
// and no fault.
//
// What bounds it on this card: at the main path's shape (8192 matrices of
// 48 x 48 per launch) the work is 8 n^3 flops per matrix, 7.2 GFLOP, and
// 302 MB of input and output: ~0.1 ms at either peak. An elimination is a
// chain of n dependent steps, so no design reaches that; what decides the
// time is where the matrix lives. With the matrix in shared memory every
// one of the n^3 entry updates moves ~32 bytes through a port of 128
// bytes a clock, 4 updates a clock per SM where the FMA lanes could do 32;
// a sampler chunk of 512 matrices does not fill the card and takes one
// matrix's own latency, n steps of pivot search + broadcast + update.
//
// Design, two kernels chosen by n alone (gj_uses_registers):
//   * registers (n = 48: the 48 electrons per spin of the C-diamond 2x2x2
//     supercell, the one system the port's configs hold). One warp per
//     matrix, two matrices per block. Lane (ty, tx) of a 4 x 8 lane grid
//     owns rows ty + 4 i and columns tx + 8 j for the whole elimination,
//     12 x 6 complex entries in registers. Per step only the scaled pivot
//     row and the multiplier column (2 n values) pass through shared
//     memory, so a lane reads 18 values for 72 complex multiply-adds and
//     the updates run at the FMA rate. Rows are never swapped: a position
//     table (where the explicit algorithm would hold each row) keeps the
//     pivot rule, the tie rule and the swap parity, and the permutation is
//     undone when the inverse is written, through a shared-memory tile so
//     that the stores are coalesced. The pivot search is part of the step:
//     column k, which its owners publish for the update anyway, is scanned
//     by all 32 lanes and two warp reductions (redux.sync) pick the pivot;
//     nothing waits on a block barrier, a step has four __syncwarp()s. The same rule serves both launch shapes: at
//     8192 matrices ~8 warps per SM hide each other's latency, and at 512
//     a warp's own chain of 48 short steps is the whole launch.
//   * shared (any other n up to 168, the shared-memory limit): one block
//     per matrix in shared memory, warp 0 picks the pivot, one pass per
//     step applies swap and elimination, three barriers per step.
// Plain FP32 arithmetic, no fast-math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // the shared-memory kernel's block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// ---- the register kernel ---------------------------------------------------

constexpr int kRegWarps = 2;  // matrices per block

// Shared memory of one warp: the unscrambling tile (row stride N + 1
// against bank conflicts of the permuted writes), the scaled pivot row,
// the multiplier column and the two position tables.
template <int N>
struct RegShared {
  float2 tile[N][N + 1];
  float2 prow[N];
  float2 fcol[N];
  int pos[N];     // position of storage row s in the row-swapped matrix;
                  // after step k, pos[s] < k + 1 marks a used row, and at
                  // the end it is the step that took s as its pivot
  int row_at[N];  // its inverse; at the end row_at[k] is step k's pivot row
};

template <int N>
__global__ void __launch_bounds__(32 * kRegWarps, 4)
gj_registers_kernel(const float2* __restrict__ a, float2* __restrict__ ainv,
                    float2* __restrict__ sign_out,
                    float* __restrict__ logdet_out, int batch) {
  static_assert(N % 8 == 0, "a 4 x 8 lane grid owns the matrix");
  constexpr int NR = N / 4;  // rows per lane
  constexpr int NC = N / 8;  // columns per lane
  __shared__ RegShared<N> shared[kRegWarps];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tx = lane & 7;
  const int ty = lane >> 3;
  const int mat = blockIdx.x * kRegWarps + warp;
  if (mat >= batch) return;  // a whole warp: only warp-level syncs follow
  RegShared<N>& s = shared[warp];
  const size_t base = static_cast<size_t>(mat) * N * N;

  float2 m[NR][NC];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) m[i][j] = a[base + (ty + 4 * i) * N + tx + 8 * j];
  for (int e = lane; e < N; e += 32) {
    s.pos[e] = e;
    s.row_at[e] = e;
  }
  __syncwarp();

  float2 sign = make_float2(1.f, 0.f);
  float logdet = 0.f;

  // k = 8 j0 + kx: j0 is unrolled so that column k is a static register
  // index of its owners (the lanes with tx == kx)
#pragma unroll
  for (int j0 = 0; j0 < NC; ++j0) {
#pragma unroll 1
    for (int kx = 0; kx < 8; ++kx) {
      const int k = 8 * j0 + kx;
      const bool owns_col = tx == kx;

      // ---- column k's owners publish it: the search reads it, and the
      // update takes its multipliers from it ----
      if (owns_col) {
#pragma unroll
        for (int i = 0; i < NR; ++i) s.fcol[ty + 4 * i] = m[i][j0];
      }
      __syncwarp();

      // ---- the pivot among the unused rows: lane l scans rows l, l + 32.
      // A candidate's key is the bit pattern of its |.|^2 plus one (the
      // order of non-negative floats is the order of their bits), 0 for a
      // used row or a NaN, which never wins ----
      unsigned key[(N + 31) / 32];
      int cpos[(N + 31) / 32];
      unsigned kmax = 0u;
#pragma unroll
      for (int q = 0; q < (N + 31) / 32; ++q) {
        const int r = lane + 32 * q;
        key[q] = 0u;
        cpos[q] = N;
        if (r < N) {
          const float2 v = s.fcol[r];
          const float mag = v.x * v.x + v.y * v.y;
          cpos[q] = s.pos[r];
          if (cpos[q] >= k && mag == mag) key[q] = __float_as_uint(mag) + 1u;
        }
        kmax = max(kmax, key[q]);
      }
      kmax = __reduce_max_sync(kFull, kmax);
      int bpos = N;  // the smallest position among the largest
#pragma unroll
      for (int q = 0; q < (N + 31) / 32; ++q) {
        if (key[q] == kmax) bpos = min(bpos, cpos[q]);
      }
      bpos = static_cast<int>(
          __reduce_min_sync(kFull, static_cast<unsigned>(bpos)));
      if (kmax == 0u) bpos = k;  // every unused entry is NaN: take row k
      const int brow = s.row_at[bpos];
      const float2 bval = s.fcol[brow];
      __syncwarp();  // pos, row_at and fcol are read before lane 0 rewrites

      // every lane holds the pivot: the accumulators are kept redundantly
      const float den = bval.x * bval.x + bval.y * bval.y;
      const float inv_den = 1.f / den;
      const float rs = rsqrtf(den) * (bpos == k ? 1.f : -1.f);
      const float2 sg = cmul(sign, bval);
      sign = make_float2(sg.x * rs, sg.y * rs);
      logdet += 0.5f * logf(den);
      const float2 d = make_float2(bval.x * inv_den, -bval.y * inv_den);

      if (lane == 0) {  // the swap of positions k and bpos, on the tables only
        const int rk = s.row_at[k];
        s.row_at[bpos] = rk;
        s.pos[rk] = bpos;
        s.row_at[k] = brow;
        s.pos[brow] = k;
        s.fcol[brow] = make_float2(0.f, 0.f);  // the pivot row is not eliminated
      }
      // the pivot row's owners scale it in place and publish it, with d in
      // column k: the uniform update below then leaves -f d in that column
      // once its owners have cleared it
      if (ty == (brow & 3)) {
        const int ip = brow >> 2;
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          if (i == ip) {
#pragma unroll
            for (int j = 0; j < NC; ++j) {
              m[i][j] = (tx + 8 * j == k) ? d : cmul(m[i][j], d);
              s.prow[tx + 8 * j] = m[i][j];
            }
          }
        }
      }
      if (owns_col) {
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          if (ty + 4 * i != brow) m[i][j0] = make_float2(0.f, 0.f);
        }
      }
      __syncwarp();

      float2 pr[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) pr[j] = s.prow[tx + 8 * j];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const float2 f = s.fcol[ty + 4 * i];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          m[i][j].x = fmaf(f.y, pr[j].y, fmaf(-f.x, pr[j].x, m[i][j].x));
          m[i][j].y = fmaf(-f.y, pr[j].x, fmaf(-f.x, pr[j].y, m[i][j].y));
        }
      }
      __syncwarp();  // prow and fcol are free for the next step
    }
  }

  // storage row r, column c holds A^-1[pos[r], row_at[c]]
  int out_col[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) out_col[j] = s.row_at[tx + 8 * j];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int out_row = s.pos[ty + 4 * i];
#pragma unroll
    for (int j = 0; j < NC; ++j) s.tile[out_row][out_col[j]] = m[i][j];
  }
  __syncwarp();
  for (int e = lane; e < N * N; e += 32) {
    ainv[base + e] = s.tile[e / N][e % N];
  }
  if (lane == 0) {
    sign_out[mat] = sign;
    logdet_out[mat] = logdet;
  }
}

// ---- the shared-memory kernel ------------------------------------------------

__global__ void __launch_bounds__(kThreads)
gj_shared_kernel(const float2* __restrict__ a, float2* __restrict__ ainv,
                 float2* __restrict__ sign_out, float* __restrict__ logdet_out,
                 int n) {
  extern __shared__ float2 smem[];
  float2* m = smem;              // n*n, row-major
  float2* fcol = m + n * n;      // n: multiplier column of this step
  float2* rowk = fcol + n;       // n: row k before the step
  float2* prow = rowk + n;       // n: scaled pivot row
  int* perm = reinterpret_cast<int*>(prow + n);  // n: pivot row per step

  __shared__ int s_p;
  __shared__ float2 s_d;
  __shared__ float2 s_sign;
  __shared__ float s_logdet;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nn = n * n;
  const size_t base = static_cast<size_t>(blockIdx.x) * nn;
  for (int i = tid; i < nn; i += blockDim.x) m[i] = a[base + i];
  if (tid == 0) {
    s_sign = make_float2(1.f, 0.f);
    s_logdet = 0.f;
  }
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    if (tid < 32) {
      float best = -1.f;
      int bidx = n;
      for (int r = k + tid; r < n; r += 32) {
        const float2 v = m[r * n + k];
        const float mag = v.x * v.x + v.y * v.y;
        if (mag > best) {  // rows ascend per lane: strict > keeps the first
          best = mag;
          bidx = r;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_down_sync(kFull, best, off);
        const int oi = __shfl_down_sync(kFull, bidx, off);
        if (ob > best || (ob == best && oi < bidx)) {
          best = ob;
          bidx = oi;
        }
      }
      if (tid == 0) {
        const int p = bidx < n ? bidx : k;  // NaN column: no candidate wins
        const float2 piv = m[p * n + k];
        const float den = piv.x * piv.x + piv.y * piv.y;
        const float inv_den = 1.f / den;
        const float rs = rsqrtf(den) * (p == k ? 1.f : -1.f);
        const float2 sg = cmul(s_sign, piv);
        s_sign = make_float2(sg.x * rs, sg.y * rs);
        s_logdet += 0.5f * logf(den);
        s_d = make_float2(piv.x * inv_den, -piv.y * inv_den);
        s_p = p;
        perm[k] = p;
      }
    }
    __syncthreads();

    const int p = s_p;
    const float2 d = s_d;
    for (int j = tid; j < n; j += blockDim.x) {
      rowk[j] = m[k * n + j];
      prow[j] = cmul(m[p * n + j], d);
      // multiplier column of the row-swapped matrix
      fcol[j] = (j == p) ? m[k * n + k] : m[j * n + k];
    }
    __syncthreads();

    // a warp takes rows warp, warp + 8, ...: no division by the run-time n
    for (int r = warp; r < n; r += kThreads / 32) {
      const float2 f = fcol[r];
      const float2 fd = cmul(f, d);
      float2* row = m + r * n;
      for (int j = lane; j < n; j += 32) {
        const float2 pj = prow[j];
        const float2 src = (r == p) ? rowk[j] : row[j];
        const float2 fp = cmul(f, pj);
        float2 out = make_float2(src.x - fp.x, src.y - fp.y);
        if (j == k) out = make_float2(-fd.x, -fd.y);
        if (r == k) out = (j == k) ? d : pj;
        row[j] = out;
      }
    }
    __syncthreads();
  }

  // (PA)^-1 -> A^-1: swap columns j and perm[j] in reverse pivot order
  for (int j = n - 1; j >= 0; --j) {
    const int q = perm[j];
    if (q != j) {  // uniform across the block: perm lives in shared memory
      for (int r = tid; r < n; r += blockDim.x) {
        const float2 cj = m[r * n + j];
        m[r * n + j] = m[r * n + q];
        m[r * n + q] = cj;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < nn; i += blockDim.x) ainv[base + i] = m[i];
  if (tid == 0) {
    sign_out[blockIdx.x] = s_sign;
    logdet_out[blockIdx.x] = s_logdet;
  }
}

}  // namespace

extern "C" {

// 1 when n x n matrices take the register kernel, 0 for the shared-memory
// one: by n alone.
int gj_uses_registers(int n) { return n == 48 ? 1 : 0; }

// Dynamic shared memory the shared-memory kernel needs for n x n matrices.
long long gj_smem_bytes(int n) {
  return static_cast<long long>(n) * n * sizeof(float2) +
         3LL * n * sizeof(float2) + static_cast<long long>(n) * sizeof(int);
}

// Largest dynamic shared memory a block may opt into on `device`.
int gj_max_smem_optin(int device) {
  int value = 0;
  if (cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return value;
}

// a, ainv: (batch, n, n) complex64; sign: (batch,) complex64;
// logdet: (batch,) float32. Returns the cudaError_t of the launch.
int gj_inverse_slogdet_launch(const void* a, void* ainv, void* sign,
                              void* logdet, int batch, int n, void* stream) {
  const auto* ap = static_cast<const float2*>(a);
  auto* ip = static_cast<float2*>(ainv);
  auto* sp = static_cast<float2*>(sign);
  auto* lp = static_cast<float*>(logdet);
  auto st = static_cast<cudaStream_t>(stream);
  if (gj_uses_registers(n)) {
    const int blocks = (batch + kRegWarps - 1) / kRegWarps;
    gj_registers_kernel<48><<<blocks, 32 * kRegWarps, 0, st>>>(ap, ip, sp, lp,
                                                               batch);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(gj_smem_bytes(n));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gj_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gj_shared_kernel<<<batch, kThreads, smem, st>>>(ap, ip, sp, lp, n);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
