// Batched complex Gauss-Jordan inverse + slogdet for Hopper (sm_90a):
// complex64 and complex128, four bodies each (warp, registers, mid,
// shared), chosen by n alone.
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
// and no fault. Padding rows and columns of a body that rounds n up are
// never candidates (an identity-filled padding row, as the TPU kernel
// pads, would outrank a NaN entry and break the NaN rule).
//
// What bounds it on this card: a launch of B matrices does 8 n^3 flops
// per matrix on 16 n^2 bytes in and out, so the operations bound it from
// n ~ 8 up: ~0.1 ms at the FP32 peak for C-diamond's (8192, 48, 48), 0.26
// ms for bcc-Li's (4096, 81, 81); Si's (8192, 14, 14) is bound by its 26
// MB of bytes, 0.008 ms. An elimination is a chain of n dependent steps,
// so no design reaches that; what decides the time is where the matrix
// lives. With the matrix in shared memory every one of the n^3 entry
// updates moves ~32 bytes through a port of 128 bytes a clock, 4 updates
// a clock per SM where the FMA lanes could do 32; a launch that does not
// fill the card (512 matrices of 14, 256 of 81) takes one matrix's own
// latency, n steps of pivot search + broadcast + update.
//
// Design, five bodies chosen by n alone (gj_body). The three register
// bodies keep the matrix in registers for the whole elimination and share
// one scheme: rows are never swapped; a position (where the explicit
// algorithm would hold each row) keeps the pivot rule, the tie rule and
// the swap parity, and the permutation is undone once, when the inverse
// is written through a shared-memory tile so that the stores are
// coalesced. A candidate's key is the bit pattern of its |.|^2 plus two
// (the order of non-negative floats is the order of their bits), one for
// a NaN, zero for a used or padding row; the largest key wins, the
// smallest position on a tie, and since the row at position k is always
// unused an all-NaN column takes it. The sign and log|det| accumulators
// are kept redundantly by every thread. Every register index is static:
// the loop over k is unrolled over the register tiles.
//   * warp (n <= 32: Si's 14; H10's 5, graphene's 6, LiH 2x2x2's 16).
//     One lane owns one row (W complex values, W = 16 or 32); for n <= 16
//     two matrices share a warp, 16 lanes each. A step: the lane's column-k
//     entry gives its key; a shuffle butterfly of log2 W rounds inside the
//     matrix's lanes picks the largest 64-bit word (key, 255 - position,
//     lane); the pivot value and then the W entries of the raw pivot row
//     are broadcast by shuffles from the pivot lane, and each lane updates
//     its row with its own multiplier f d. Dependent chain per step: 2
//     FMAs and a compare, log2 W paired shuffles, one shuffle, a
//     reciprocal, then W shuffles pipelined into W complex updates; no
//     barrier of any kind.
//   * registers (n = 48: the 48 electrons per spin of the C-diamond 2x2x2
//     supercell). One warp per matrix, two matrices per block. Lane (ty, tx)
//     of a 4 x 8 lane grid owns rows ty + 4 i and columns tx + 8 j, 12 x 6
//     complex entries. Per step only the scaled pivot row and the
//     multiplier column (2 n values) pass through shared memory, so a lane
//     reads 18 values for 72 complex multiply-adds and the updates run at
//     the FMA rate. Column k, which its owners publish for the update
//     anyway, is scanned by all 32 lanes and two warp reductions
//     (redux.sync) pick the pivot; a step has four __syncwarp()s. At 8192
//     matrices ~8 warps per SM hide each other's latency, and at 512 a
//     warp's own chain of 48 short steps is the whole launch.
//   * mid (49 <= n <= 96: bcc-Li 3x3x3's 81 electrons per spin). One block
//     of 8 warps per matrix; lane (ty, tx) of a 16 x 16 lane grid owns rows
//     ty + 16 i and columns tx + 16 j, 6 x 6 complex entries (72 registers,
//     half the n = 48 body's 144, so that two blocks of 256 threads fit an
//     SM at <= 128 registers each; 96 is the largest n a 6 x 6 tile
//     covers). The matrix arrives in a shared-memory tile by 8-byte
//     cp.async copies (a matrix of odd n^2 starts off 16-byte alignment),
//     from which each lane takes its strided entries. A step: the owners
//     of column k publish it (double-buffered by the parity of k); barrier
//     one; every warp scans the whole column (rows lane + 32 q) with the
//     positions of those rows in registers and two redux.sync pick the
//     pivot, the same in every warp, so no word crosses warps; the pivot
//     row's owners publish it scaled; barrier two; each lane reads its 6
//     row multipliers and 6 pivot-row entries and does 36 complex
//     multiply-adds. Dependent chain per step: a shared store, a barrier,
//     3 shared loads, 2 warp reductions, a shared load, a reciprocal, 6
//     complex products and stores, a barrier, 12 shared loads, then the
//     36 updates (144 FMAs, 288 clocks of an SM's FMA rate for the block).
//     One block per matrix: a persistent grid that copies the next matrix
//     while it eliminates the current one measured slower
//     (time_gj_variants.py), as did one barrier per step with the search
//     a step ahead, a rolled loop over the column tiles, and the pivot
//     arithmetic left to the pivot row's owners.
//   * mid, wide (97 <= n <= 128: Si 2x2x2's 112 electrons per spin). The
//     mid body compiled for a padded size of 128: 8 x 8 complex entries a
//     lane (204 registers, no spill), so one block an SM. At (4096, 112,
//     112) it took 4.75 ms against the shared body's 14.62 (graph-timed in
//     turns on an H100); at 81 it would take 3.20 against the 6 x 6 tile's
//     1.63, so 49-96 keep that one.
//   * shared (33-47 and 129 up to 168, the shared-memory limit): one block
//     per matrix in shared memory, warp 0 picks the pivot, one pass per
//     step applies swap and elimination, three barriers per step.
// Plain FP32 arithmetic, no fast-math.
//
// complex128 (the float64 runs), four bodies chosen by n alone
// (gj_body_c128). Plain FP64 arithmetic, the same pivot, tie and NaN rules
// with |a|^2 compared in double. What bounds it: 8 n^3 flops per matrix at
// the FP64 rate, half the FP32 one outside the tensor cores (an
// elimination's rank-1 updates do not reach the FP64 tensor cores), so the
// updates' FMAs and a step's chain weigh twice what they do in complex64.
// The three register bodies form sign and log|det| once at the end from
// each step's pivot, in a fixed order, off the per-step chain.
//   * warp (n <= 32: Si's 14, LiH's 16, graphene's 6, H10's 5). The
//     complex64 warp body's scheme in double: one lane owns one row (W =
//     16 or 32 complex128 values, 64 or 128 registers), two matrices a
//     warp for n <= 16, two warps a block so that the loading tiles stay
//     in static shared memory (35,840 B at W = 32). The pivot by a
//     butterfly of log2 W rounds over (64-bit key, position << 8 | lane),
//     the pivot value by shuffles and the raw pivot row through shared
//     memory (one complex128 entry would take four shuffles); lane k keeps
//     step k's pivot for the sign and log|det|.
//   * mid (49 <= n <= 96: bcc-Li's 81 in float64). The complex64 mid
//     body's scheme in double: one block of 8 warps per matrix, lane (ty,
//     tx) of a 16 x 16 lane grid owns rows ty + 16 i and columns tx + 16 j,
//     6 x 6 complex128 entries (144 registers, so one block per SM: an
//     81 x 81 matrix is 105 KB of the SM's 256 KB register file, padded to
//     96 x 96 147 KB). The matrix is loaded straight into registers (the
//     16 lanes of a grid row read 256 contiguous bytes); two barriers a
//     step, every warp finds the pivot alone as the n = 48 body does, and
//     only the pivot row's owners form d. A step's updates are 36,864
//     DFMA a block, ~580 clocks of an SM's 64 FP64 FMA lanes, so at 4096
//     matrices the time is ~32 waves of one matrix's 81-step latency.
//   * registers (n = 48: C-diamond in float64). A matrix in registers takes
//     144 registers of complex64 data a lane in one warp, which complex128
//     would double past the 255 a thread may hold; so a matrix spans two
//     warps: lane (ty, tx) of an 8 x 8 lane grid owns rows ty + 8 i and
//     columns tx + 8 j, 6 x 6 complex128 entries (144 registers), the mid
//     body's scheme over 64 lanes. Two matrices per block, each with its
//     own named barrier (bar.sync id, 64), two per step: column k
//     published; both warps scan all 48 rows and pick the pivot alone,
//     comparing (|a|^2, position) pairs as the 64-bit pattern of |a|^2 in
//     two 32-bit warp reductions and then the smallest position; only the
//     pivot row's eight owners form d = 1 / piv and publish the scaled row;
//     every lane does 36 complex multiply-adds. Sign and log|det| are formed
//     once at the end from each step's pivot, by the first warp's lanes and
//     a butterfly in a fixed order, off the per-step chain.
//   * shared (33-47 and 97-118): the shared-memory body, templated on its
//     scalar type, for every n whose 16 n^2 + 52 n bytes fit a block's
//     shared memory (n <= 118 in the 227 KB an H100 block may opt into).
// Entry points gj_body_c128, gj_smem_bytes_c128 and
// gj_inverse_slogdet_launch_c128; a larger n is refused by the wrapper
// before any launch.
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
//
// One body for both scalar types: C = float2 (complex64, log|det| in
// float) or double2 (complex128, log|det| in double, the float64 runs).
// Its pivot search compares (|a|^2, row) pairs, so the float64 key needs
// no packing into one word.

template <typename C>
struct Scalar;
template <>
struct Scalar<float2> {
  using R = float;
  __device__ static float2 make(float x, float y) { return make_float2(x, y); }
  __device__ static float rsqrt(float x) { return rsqrtf(x); }
  __device__ static float log(float x) { return logf(x); }
};
template <>
struct Scalar<double2> {
  using R = double;
  __device__ static double2 make(double x, double y) { return make_double2(x, y); }
  __device__ static double rsqrt(double x) { return ::rsqrt(x); }
  __device__ static double log(double x) { return ::log(x); }
};

template <typename C>
__device__ __forceinline__ C cmul_t(C a, C b) {
  return Scalar<C>::make(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

template <typename C>
__global__ void __launch_bounds__(kThreads)
gj_shared_kernel(const C* __restrict__ a, C* __restrict__ ainv,
                 C* __restrict__ sign_out,
                 typename Scalar<C>::R* __restrict__ logdet_out, int n) {
  using S = Scalar<C>;
  using R = typename S::R;
  extern __shared__ __align__(16) unsigned char gj_smem[];
  C* m = reinterpret_cast<C*>(gj_smem);  // n*n, row-major
  C* fcol = m + n * n;           // n: multiplier column of this step
  C* rowk = fcol + n;            // n: row k before the step
  C* prow = rowk + n;            // n: scaled pivot row
  int* perm = reinterpret_cast<int*>(prow + n);  // n: pivot row per step

  __shared__ int s_p;
  __shared__ C s_d;
  __shared__ C s_sign;
  __shared__ R s_logdet;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nn = n * n;
  const size_t base = static_cast<size_t>(blockIdx.x) * nn;
  for (int i = tid; i < nn; i += blockDim.x) m[i] = a[base + i];
  if (tid == 0) {
    s_sign = S::make(R(1), R(0));
    s_logdet = R(0);
  }
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    if (tid < 32) {
      R best = R(-1);
      int bidx = n;
      for (int r = k + tid; r < n; r += 32) {
        const C v = m[r * n + k];
        const R mag = v.x * v.x + v.y * v.y;
        if (mag > best) {  // rows ascend per lane: strict > keeps the first
          best = mag;
          bidx = r;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const R ob = __shfl_down_sync(kFull, best, off);
        const int oi = __shfl_down_sync(kFull, bidx, off);
        if (ob > best || (ob == best && oi < bidx)) {
          best = ob;
          bidx = oi;
        }
      }
      if (tid == 0) {
        const int p = bidx < n ? bidx : k;  // NaN column: no candidate wins
        const C piv = m[p * n + k];
        const R den = piv.x * piv.x + piv.y * piv.y;
        const R inv_den = R(1) / den;
        const R rs = S::rsqrt(den) * (p == k ? R(1) : R(-1));
        const C sg = cmul_t(s_sign, piv);
        s_sign = S::make(sg.x * rs, sg.y * rs);
        s_logdet += R(0.5) * S::log(den);
        s_d = S::make(piv.x * inv_den, -piv.y * inv_den);
        s_p = p;
        perm[k] = p;
      }
    }
    __syncthreads();

    const int p = s_p;
    const C d = s_d;
    for (int j = tid; j < n; j += blockDim.x) {
      rowk[j] = m[k * n + j];
      prow[j] = cmul_t(m[p * n + j], d);
      // multiplier column of the row-swapped matrix
      fcol[j] = (j == p) ? m[k * n + k] : m[j * n + k];
    }
    __syncthreads();

    // a warp takes rows warp, warp + 8, ...: no division by the run-time n
    for (int r = warp; r < n; r += kThreads / 32) {
      const C f = fcol[r];
      const C fd = cmul_t(f, d);
      C* row = m + r * n;
      for (int j = lane; j < n; j += 32) {
        const C pj = prow[j];
        const C src = (r == p) ? rowk[j] : row[j];
        const C fp = cmul_t(f, pj);
        C out = S::make(src.x - fp.x, src.y - fp.y);
        if (j == k) out = S::make(-fd.x, -fd.y);
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
        const C cj = m[r * n + j];
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

// Dynamic shared memory of the shared-memory body for n x n matrices of C:
// the matrix, three rows of C and the pivot rows.
template <typename C>
constexpr long long shared_body_bytes(int n) {
  return static_cast<long long>(n) * n * sizeof(C) + 3LL * n * sizeof(C) +
         static_cast<long long>(n) * sizeof(int);
}

// Launches the shared-memory body, opting in above the default 48 KB.
template <typename C>
int launch_shared(const C* a, C* ainv, C* sign, typename Scalar<C>::R* logdet,
                  int batch, int n, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(shared_body_bytes<C>(n));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gj_shared_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gj_shared_kernel<C><<<batch, kThreads, smem, st>>>(a, ainv, sign, logdet, n);
  return static_cast<int>(cudaSuccess);
}

// ---- the warp kernel ---------------------------------------------------------

constexpr int kWarpBodyWarps = 4;  // warps per block

// A candidate's key: 0 for a used or padding row, 1 for a NaN, else the
// bits of |v|^2 plus 2.
__device__ __forceinline__ unsigned pivot_key(float2 v, bool candidate) {
  const float mag = v.x * v.x + v.y * v.y;
  if (!candidate) return 0u;
  return mag == mag ? __float_as_uint(mag) + 2u : 1u;
}

// One lane per row, W lanes per matrix (32 / W matrices per warp).
template <int W>
__global__ void __launch_bounds__(32 * kWarpBodyWarps)
gj_warp_kernel(const float2* __restrict__ a, float2* __restrict__ ainv,
               float2* __restrict__ sign_out, float* __restrict__ logdet_out,
               int batch, int n) {
  static_assert(W == 16 || W == 32, "a matrix takes a half warp or a warp");
  constexpr int kSegs = 32 / W;
  constexpr unsigned kSegMask = W == 32 ? kFull : (1u << W) - 1u;
  // the loading and unscrambling tile of each matrix (row stride W + 1),
  // and its raw pivot row, double-buffered by the parity of k
  __shared__ float2 tiles[kWarpBodyWarps][kSegs][W][W + 1];
  __shared__ __align__(16) float2 rows[kWarpBodyWarps][2][kSegs][W];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg = lane / W;
  const int r = lane % W;  // the row this lane owns
  const int first = (blockIdx.x * kWarpBodyWarps + warp) * kSegs;
  if (first >= batch) return;  // a whole warp: only warp-level syncs follow
  const int mat = first + seg;
  const bool live = mat < batch;  // the last half warp of an odd batch idles
  const size_t base = static_cast<size_t>(mat) * n * n;
  float2(*tile)[W + 1] = tiles[warp][seg];

  // row i of the matrix is one coalesced load of its lanes
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if (live && i < n && r < n) tile[i][r] = a[base + i * n + r];
  }
  __syncwarp();
  float2 m[W];
#pragma unroll
  for (int c = 0; c < W; ++c) {
    m[c] = (live && r < n && c < n) ? tile[r][c] : make_float2(0.f, 0.f);
  }
  __syncwarp();  // the tile is rewritten at the end

  int pos = r;  // padding rows keep positions >= n and never move
  float2 sign = make_float2(1.f, 0.f);
  float logdet = 0.f;
  const int seg_base = seg * W;

#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (k >= n) break;
    const float2 v = m[k];
    // the pivot: the largest (key, 255 - position) among the matrix's
    // lanes, its lane in the low byte (positions are unique)
    unsigned long long best =
        (static_cast<unsigned long long>(pivot_key(v, r < n && pos >= k)) << 32) |
        (static_cast<unsigned>(255 - pos) << 8) | static_cast<unsigned>(r);
#pragma unroll
    for (int off = W / 2; off > 0; off >>= 1) {
      const unsigned long long other = __shfl_xor_sync(kFull, best, off);
      best = other > best ? other : best;
    }
    const unsigned low = static_cast<unsigned>(best);
    const int plane = static_cast<int>(low & 255u);
    const int bpos = 255 - static_cast<int>(low >> 8);
    const int src = seg_base + plane;
    // the pivot value by shuffle, the pivot row through shared memory
    const float2 bval = make_float2(__shfl_sync(kFull, v.x, src),
                                    __shfl_sync(kFull, v.y, src));
    float4* prow = reinterpret_cast<float4*>(rows[warp][k & 1][seg]);
    if (r == plane) {
#pragma unroll
      for (int j = 0; j < W / 2; ++j) {
        prow[j] = make_float4(m[2 * j].x, m[2 * j].y, m[2 * j + 1].x, m[2 * j + 1].y);
      }
    }
    __syncwarp();

    const float den = bval.x * bval.x + bval.y * bval.y;
    const float inv_den = 1.f / den;
    const float rs = rsqrtf(den) * (bpos == k ? 1.f : -1.f);
    const float2 sg = cmul(sign, bval);
    sign = make_float2(sg.x * rs, sg.y * rs);
    logdet += 0.5f * logf(den);
    const float2 d = make_float2(bval.x * inv_den, -bval.y * inv_den);

    // row -= (f d) * pivot row; the pivot row becomes d * itself, with d
    // in column k, and every other row -f d there
    const bool piv = r == plane;
    const float2 fd = cmul(v, d);
    const float2 coef = piv ? make_float2(-d.x, -d.y) : fd;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float4 p2 = prow[j / 2];
      const float2 p = (j & 1) ? make_float2(p2.z, p2.w) : make_float2(p2.x, p2.y);
      const float2 b = piv ? make_float2(0.f, 0.f) : m[j];
      m[j].x = fmaf(coef.y, p.y, fmaf(-coef.x, p.x, b.x));
      m[j].y = fmaf(-coef.y, p.x, fmaf(-coef.x, p.y, b.y));
    }
    m[k] = piv ? d : make_float2(-fd.x, -fd.y);
    if (piv) {
      pos = k;
    } else if (pos == k) {
      pos = bpos;
    }
  }

  // storage row r, column c holds A^-1[pos(r), the row at position c]
#pragma unroll
  for (int c = 0; c < W; ++c) {
    if (c >= n) break;
    const unsigned at = (__ballot_sync(kFull, pos == c) >> seg_base) & kSegMask;
    if (r < n) tile[pos][__ffs(at) - 1] = m[c];
  }
  __syncwarp();
  if (live) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i < n && r < n) ainv[base + i * n + r] = tile[i][r];
    }
    if (r == 0) {
      sign_out[mat] = sign;
      logdet_out[mat] = logdet;
    }
  }
}

// ---- the mid kernel ----------------------------------------------------------

constexpr int kMidMin = 49;            // smallest n of the mid kernel
constexpr int kMidN = 96;              // its padded size: 6 x 6 per lane
constexpr int kMidTile = kMidN / 16;   // entries per lane along each axis
constexpr int kMidWideN = 128;         // complex64 above kMidN: 8 x 8 per lane
constexpr int kMidThreads = 256;       // a 16 x 16 lane grid

// Dynamic shared memory of the mid kernels: their n x (n + 1) tile of C.
template <typename C>
__host__ __device__ constexpr long long mid_tile_bytes(int n) {
  return static_cast<long long>(n) * (n + 1) * sizeof(C);
}

// 8-byte asynchronous copy from device to shared memory.
__device__ __forceinline__ void cp_async8(float2* dst, const float2* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// N is the padded size: kMidN (two blocks an SM at <= 128 registers) or
// kMidWideN (one block an SM)
template <int N>
__global__ void __launch_bounds__(kMidThreads, N == kMidN ? 2 : 1)
gj_mid_kernel(const float2* __restrict__ a, float2* __restrict__ ainv,
              float2* __restrict__ sign_out, float* __restrict__ logdet_out,
              int n) {
  constexpr int T = N / 16;
  extern __shared__ float2 tile[];  // n x (n + 1): the matrix in, A^-1 out
  __shared__ float2 fcol[2][N];  // column k of this step, by parity of k
  __shared__ float2 prow[2][N];  // the scaled pivot row, the same
  __shared__ int pos_s[N];
  __shared__ int row_at_s[N];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int ld = n + 1;
  const int nn = n * n;
  const size_t base = static_cast<size_t>(blockIdx.x) * nn;

  for (int e = tid; e < nn; e += kMidThreads) {
    const int i = e / n;
    cp_async8(tile + i * ld + e - i * n, a + base + e);
  }
  cp_async_wait_all();
  __syncthreads();
  float2 m[T][T];
#pragma unroll
  for (int i = 0; i < T; ++i) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const int row = ty + 16 * i, col = tx + 16 * j;
      m[i][j] = (row < n && col < n) ? tile[row * ld + col] : make_float2(0.f, 0.f);
    }
  }

  // every warp scans rows lane + 32 q and keeps their positions
  int pos[N / 32];
#pragma unroll
  for (int q = 0; q < N / 32; ++q) pos[q] = lane + 32 * q;
  float2 sign = make_float2(1.f, 0.f);
  float logdet = 0.f;

  // k = 16 j0 + kx: j0 is unrolled so that column k is a static register
  // index of its owners (the lanes with tx == kx)
#pragma unroll
  for (int j0 = 0; j0 < T; ++j0) {
#pragma unroll 1
    for (int kx = 0; kx < 16; ++kx) {
      const int k = 16 * j0 + kx;
      if (k >= n) break;
      const int buf = k & 1;
      const bool owns_col = tx == kx;
      if (owns_col) {
#pragma unroll
        for (int i = 0; i < T; ++i) fcol[buf][ty + 16 * i] = m[i][j0];
      }
      __syncthreads();  // one: column k is published

      unsigned key[N / 32];
      unsigned kmax = 0u;
#pragma unroll
      for (int q = 0; q < N / 32; ++q) {
        const int row = lane + 32 * q;
        key[q] = pivot_key(fcol[buf][row], row < n && pos[q] >= k);
        kmax = max(kmax, key[q]);
      }
      kmax = __reduce_max_sync(kFull, kmax);
      unsigned cand = 0xffffffffu;  // (position, row) of the smallest position
#pragma unroll
      for (int q = 0; q < N / 32; ++q) {
        if (key[q] == kmax) {
          cand = min(cand, (static_cast<unsigned>(pos[q]) << 8) |
                               static_cast<unsigned>(lane + 32 * q));
        }
      }
      cand = __reduce_min_sync(kFull, cand);
      const int bpos = static_cast<int>(cand >> 8);
      const int brow = static_cast<int>(cand & 255u);
      const float2 bval = fcol[buf][brow];

      const float den = bval.x * bval.x + bval.y * bval.y;
      const float inv_den = 1.f / den;
      const float rs = rsqrtf(den) * (bpos == k ? 1.f : -1.f);
      const float2 sg = cmul(sign, bval);
      sign = make_float2(sg.x * rs, sg.y * rs);
      logdet += 0.5f * logf(den);
      const float2 d = make_float2(bval.x * inv_den, -bval.y * inv_den);
#pragma unroll
      for (int q = 0; q < N / 32; ++q) {
        if (lane + 32 * q == brow) {
          pos[q] = k;
        } else if (pos[q] == k) {
          pos[q] = bpos;
        }
      }

      // the pivot row's owners scale it in place and publish it, with d
      // in column k: the update below then leaves -f d in that column
      // once its owners have cleared it
      if (ty == (brow & 15)) {
        const int ip = brow >> 4;
#pragma unroll
        for (int i = 0; i < T; ++i) {
          if (i == ip) {
#pragma unroll
            for (int j = 0; j < T; ++j) {
              m[i][j] = (tx + 16 * j == k) ? d : cmul(m[i][j], d);
              prow[buf][tx + 16 * j] = m[i][j];
            }
          }
        }
      }
      if (owns_col) {
#pragma unroll
        for (int i = 0; i < T; ++i) {
          if (ty + 16 * i != brow) m[i][j0] = make_float2(0.f, 0.f);
        }
      }
      __syncthreads();  // two: the pivot row is published

      float2 pr[T];
#pragma unroll
      for (int j = 0; j < T; ++j) pr[j] = prow[buf][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const int row = ty + 16 * i;
        // the pivot row is not eliminated
        const float2 f = row == brow ? make_float2(0.f, 0.f) : fcol[buf][row];
#pragma unroll
        for (int j = 0; j < T; ++j) {
          m[i][j].x = fmaf(f.y, pr[j].y, fmaf(-f.x, pr[j].x, m[i][j].x));
          m[i][j].y = fmaf(-f.y, pr[j].x, fmaf(-f.x, pr[j].y, m[i][j].y));
        }
      }
    }
  }

  // storage row r, column c holds A^-1[pos(r), row_at(c)]: warp 0 holds
  // every row's position
  if (tid < 32) {
#pragma unroll
    for (int q = 0; q < N / 32; ++q) {
      const int row = lane + 32 * q;
      if (row < n) {
        pos_s[row] = pos[q];
        row_at_s[pos[q]] = row;
      }
    }
  }
  __syncthreads();
  int out_col[T];
#pragma unroll
  for (int j = 0; j < T; ++j) {
    out_col[j] = tx + 16 * j < n ? row_at_s[tx + 16 * j] : 0;
  }
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int row = ty + 16 * i;
    if (row < n) {
      const int out_row = pos_s[row];
#pragma unroll
      for (int j = 0; j < T; ++j) {
        if (tx + 16 * j < n) tile[out_row * ld + out_col[j]] = m[i][j];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < nn; e += kMidThreads) {
    const int i = e / n;
    ainv[base + e] = tile[i * ld + e - i * n];
  }
  if (tid == 0) {
    sign_out[blockIdx.x] = sign;
    logdet_out[blockIdx.x] = logdet;
  }
}

// ---- the complex128 register kernel (n = 48) ---------------------------------

constexpr int kZN = 48;           // its matrix size
constexpr int kZMats = 2;         // matrices per block, two warps each
constexpr int kZTile = kZN / 8;   // entries per lane along each axis

// Shared memory of one matrix: the unscrambling tile, column k and the
// scaled pivot row (both double-buffered by the parity of k), each step's
// pivot value and swap, and the two position tables.
struct ZRegShared {
  double2 tile[kZN][kZN + 1];
  double2 fcol[2][kZN];
  double2 prow[2][kZN];
  double2 piv[kZN];
  int swapped[kZN];
  int pos[kZN];     // position of storage row s at the end
  int row_at[kZN];  // its inverse
};

// The barrier of the two warps of one matrix (ids 1.. ; 0 is the block's).
__device__ __forceinline__ void matrix_barrier(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// A candidate's key: 0 for a used or padding row, 1 for a NaN, else the
// bits of |v|^2 plus 2 (the order of non-negative doubles is the order of
// their 64-bit patterns).
__device__ __forceinline__ unsigned long long zpivot_key(double2 v, bool candidate) {
  const double mag = v.x * v.x + v.y * v.y;
  if (!candidate) return 0ull;
  return mag == mag
             ? static_cast<unsigned long long>(__double_as_longlong(mag)) + 2ull
             : 1ull;
}

// Step k's factor of the sign (its pivot over |pivot|, negated for a row
// swap) and its term 0.5 log|pivot|^2 of log|det|.
__device__ __forceinline__ double2 unit_pivot(double2 p, bool swapped, double& half_log) {
  const double den = p.x * p.x + p.y * p.y;
  const double rs = ::rsqrt(den) * (swapped ? -1.0 : 1.0);
  half_log = 0.5 * ::log(den);
  return make_double2(p.x * rs, p.y * rs);
}

// A matrix's sign and log|det| from its W lanes' partial products and
// sums, combined by a butterfly in a fixed order (every lane ends with both).
template <int W>
__device__ __forceinline__ void combine_sign_logdet(double2& phase, double& logdet) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) {
    const double2 other = make_double2(__shfl_xor_sync(kFull, phase.x, off),
                                       __shfl_xor_sync(kFull, phase.y, off));
    logdet += __shfl_xor_sync(kFull, logdet, off);
    phase = cmul_t(phase, other);
  }
}

__global__ void __launch_bounds__(64 * kZMats)
gj_registers_double_kernel(const double2* __restrict__ a,
                           double2* __restrict__ ainv,
                           double2* __restrict__ sign_out,
                           double* __restrict__ logdet_out, int batch) {
  constexpr int T = kZTile;
  extern __shared__ __align__(16) unsigned char gj_z_smem[];
  const int which = threadIdx.x >> 6;  // the block's matrix this thread serves
  const int l = threadIdx.x & 63;      // its lane among the matrix's 64
  const int lane = threadIdx.x & 31;
  const int tx = l & 7;
  const int ty = l >> 3;
  const int mat = blockIdx.x * kZMats + which;
  if (mat >= batch) return;  // both warps of the matrix: only its barrier follows
  ZRegShared& s = reinterpret_cast<ZRegShared*>(gj_z_smem)[which];
  const int bar = 1 + which;
  const size_t base = static_cast<size_t>(mat) * kZN * kZN;

  double2 m[T][T];
#pragma unroll
  for (int i = 0; i < T; ++i)
#pragma unroll
    for (int j = 0; j < T; ++j) m[i][j] = a[base + (ty + 8 * i) * kZN + tx + 8 * j];

  // both warps scan rows lane and lane + 32 and keep their positions
  int pos[2] = {lane, lane + 32};

  // k = 8 j0 + kx: j0 is unrolled so that column k is a static register
  // index of its owners (the lanes with tx == kx)
#pragma unroll
  for (int j0 = 0; j0 < T; ++j0) {
#pragma unroll 1
    for (int kx = 0; kx < 8; ++kx) {
      const int k = 8 * j0 + kx;
      const int buf = k & 1;
      const bool owns_col = tx == kx;
      if (owns_col) {
#pragma unroll
        for (int i = 0; i < T; ++i) s.fcol[buf][ty + 8 * i] = m[i][j0];
      }
      matrix_barrier(bar);  // one: column k is published

      // the pivot: the largest (|.|^2, smallest position) pair among the
      // unused rows, compared as the key's two 32-bit halves, then the
      // position; every warp finds it alone, so no word crosses warps
      unsigned long long key[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int row = lane + 32 * q;
        key[q] = row < kZN ? zpivot_key(s.fcol[buf][row], pos[q] >= k) : 0ull;
      }
      const unsigned long long mine = key[0] > key[1] ? key[0] : key[1];
      const unsigned hi =
          __reduce_max_sync(kFull, static_cast<unsigned>(mine >> 32));
      const unsigned lo = __reduce_max_sync(
          kFull, static_cast<unsigned>(mine >> 32) == hi
                     ? static_cast<unsigned>(mine)
                     : 0u);
      const unsigned long long kmax =
          (static_cast<unsigned long long>(hi) << 32) | lo;
      unsigned cand = 0xffffffffu;  // (position, row) of the smallest position
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (key[q] == kmax) {
          cand = min(cand, (static_cast<unsigned>(pos[q]) << 8) |
                               static_cast<unsigned>(lane + 32 * q));
        }
      }
      cand = __reduce_min_sync(kFull, cand);
      const int bpos = static_cast<int>(cand >> 8);
      const int brow = static_cast<int>(cand & 255u);
      const double2 bval = s.fcol[buf][brow];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (lane + 32 * q == brow) {
          pos[q] = k;
        } else if (pos[q] == k) {
          pos[q] = bpos;
        }
      }
      if (l == 0) {  // sign and log|det| are formed from these at the end
        s.piv[k] = bval;
        s.swapped[k] = bpos != k;
      }

      // the pivot row's owners scale it in place and publish it, with d in
      // column k: the update below then leaves -f d in that column once its
      // owners have cleared it. Only they need d.
      if (ty == (brow & 7)) {
        const double inv_den = 1.0 / (bval.x * bval.x + bval.y * bval.y);
        const double2 d = make_double2(bval.x * inv_den, -bval.y * inv_den);
        const int ip = brow >> 3;
#pragma unroll
        for (int i = 0; i < T; ++i) {
          if (i == ip) {
#pragma unroll
            for (int j = 0; j < T; ++j) {
              m[i][j] = (tx + 8 * j == k) ? d : cmul_t(m[i][j], d);
              s.prow[buf][tx + 8 * j] = m[i][j];
            }
          }
        }
      }
      if (owns_col) {
#pragma unroll
        for (int i = 0; i < T; ++i) {
          if (ty + 8 * i != brow) m[i][j0] = make_double2(0.0, 0.0);
        }
      }
      matrix_barrier(bar);  // two: the pivot row is published

      double2 pr[T];
#pragma unroll
      for (int j = 0; j < T; ++j) pr[j] = s.prow[buf][tx + 8 * j];
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const int row = ty + 8 * i;
        // the pivot row is not eliminated
        const double2 f = row == brow ? make_double2(0.0, 0.0) : s.fcol[buf][row];
#pragma unroll
        for (int j = 0; j < T; ++j) {
          m[i][j].x = fma(f.y, pr[j].y, fma(-f.x, pr[j].x, m[i][j].x));
          m[i][j].y = fma(-f.y, pr[j].x, fma(-f.x, pr[j].y, m[i][j].y));
        }
      }
    }
  }

  // storage row r, column c holds A^-1[pos(r), row_at(c)]: the first warp
  // holds every row's position
  if (l < 32) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int row = lane + 32 * q;
      if (row < kZN) {
        s.pos[row] = pos[q];
        s.row_at[pos[q]] = row;
      }
    }
  }
  matrix_barrier(bar);
  int out_col[T];
#pragma unroll
  for (int j = 0; j < T; ++j) out_col[j] = s.row_at[tx + 8 * j];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int out_row = s.pos[ty + 8 * i];
#pragma unroll
    for (int j = 0; j < T; ++j) s.tile[out_row][out_col[j]] = m[i][j];
  }
  matrix_barrier(bar);
  for (int e = l; e < kZN * kZN; e += 64) {
    ainv[base + e] = s.tile[e / kZN][e % kZN];
  }

  // sign = prod piv / |piv| * (-1)^swaps, log|det| = sum 0.5 log|piv|^2:
  // lane q of the first warp takes steps q and q + 32, then a butterfly
  // combines the lanes in a fixed order (the pivots were written before
  // the last step's second barrier)
  if (l < 32) {
    double2 phase = make_double2(1.0, 0.0);
    double logdet = 0.0;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int k = lane + 32 * q;
      if (k < kZN) {
        double half_log;
        phase = cmul_t(phase, unit_pivot(s.piv[k], s.swapped[k], half_log));
        logdet += half_log;
      }
    }
    combine_sign_logdet<32>(phase, logdet);
    if (l == 0) {
      sign_out[mat] = phase;
      logdet_out[mat] = logdet;
    }
  }
}

// ---- the complex128 warp kernel (n <= 32) ------------------------------------

constexpr int kZWarpWarps = 2;  // warps per block: the tiles fit static shared memory

// One lane per row, W lanes per matrix (32 / W matrices per warp).
template <int W>
__global__ void __launch_bounds__(32 * kZWarpWarps)
gj_warp_double_kernel(const double2* __restrict__ a, double2* __restrict__ ainv,
                      double2* __restrict__ sign_out, double* __restrict__ logdet_out,
                      int batch, int n) {
  static_assert(W == 16 || W == 32, "a matrix takes a half warp or a warp");
  constexpr int kSegs = 32 / W;
  constexpr unsigned kSegMask = W == 32 ? kFull : (1u << W) - 1u;
  // the loading and unscrambling tile of each matrix (row stride W + 1),
  // and its raw pivot row, double-buffered by the parity of k
  __shared__ double2 tiles[kZWarpWarps][kSegs][W][W + 1];
  __shared__ double2 rows[kZWarpWarps][2][kSegs][W];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg = lane / W;
  const int r = lane % W;  // the row this lane owns
  const int first = (blockIdx.x * kZWarpWarps + warp) * kSegs;
  if (first >= batch) return;  // a whole warp: only warp-level syncs follow
  const int mat = first + seg;
  const bool live = mat < batch;  // the last half warp of an odd batch idles
  const size_t base = static_cast<size_t>(mat) * n * n;
  double2(*tile)[W + 1] = tiles[warp][seg];

  // row i of the matrix is one coalesced load of its lanes
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if (live && i < n && r < n) tile[i][r] = a[base + i * n + r];
  }
  __syncwarp();
  double2 m[W];
#pragma unroll
  for (int c = 0; c < W; ++c) {
    m[c] = (live && r < n && c < n) ? tile[r][c] : make_double2(0.0, 0.0);
  }
  __syncwarp();  // the tile is rewritten at the end

  int pos = r;  // padding rows keep positions >= n and never move
  double2 piv = make_double2(1.0, 0.0);  // lane r keeps step r's pivot
  bool swapped = false;
  const int seg_base = seg * W;

#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (k >= n) break;
    const double2 v = m[k];
    // the pivot: the largest key among the matrix's lanes, then the
    // smallest position, by a butterfly over (key, position << 8 | lane)
    // (positions are unique, so the second word decides every tie)
    unsigned long long key = zpivot_key(v, r < n && pos >= k);
    unsigned cand = (static_cast<unsigned>(pos) << 8) | static_cast<unsigned>(r);
#pragma unroll
    for (int off = W / 2; off > 0; off >>= 1) {
      const unsigned long long okey = __shfl_xor_sync(kFull, key, off);
      const unsigned ocand = __shfl_xor_sync(kFull, cand, off);
      if (okey > key || (okey == key && ocand < cand)) {
        key = okey;
        cand = ocand;
      }
    }
    const int plane = static_cast<int>(cand & 255u);
    const int bpos = static_cast<int>(cand >> 8);
    const int src = seg_base + plane;
    // the pivot value by shuffle, the raw pivot row through shared memory
    const double2 bval = make_double2(__shfl_sync(kFull, v.x, src),
                                      __shfl_sync(kFull, v.y, src));
    double2* prow = rows[warp][k & 1][seg];
    const bool is_piv = r == plane;
    if (is_piv) {
#pragma unroll
      for (int j = 0; j < W; ++j) prow[j] = m[j];
    }
    __syncwarp();
    if (r == k) {  // sign and log|det| are formed from these at the end
      piv = bval;
      swapped = bpos != k;
    }

    const double inv_den = 1.0 / (bval.x * bval.x + bval.y * bval.y);
    const double2 d = make_double2(bval.x * inv_den, -bval.y * inv_den);
    // row -= (f d) * pivot row; the pivot row becomes d * itself, with d
    // in column k, and every other row -f d there
    const double2 fd = cmul_t(v, d);
    const double2 coef = is_piv ? make_double2(-d.x, -d.y) : fd;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const double2 p = prow[j];
      const double2 b = is_piv ? make_double2(0.0, 0.0) : m[j];
      m[j].x = fma(coef.y, p.y, fma(-coef.x, p.x, b.x));
      m[j].y = fma(-coef.y, p.x, fma(-coef.x, p.y, b.y));
    }
    m[k] = is_piv ? d : make_double2(-fd.x, -fd.y);
    if (is_piv) {
      pos = k;
    } else if (pos == k) {
      pos = bpos;
    }
  }

  // sign = prod piv / |piv| * (-1)^swaps, log|det| = sum 0.5 log|piv|^2:
  // lane r takes step r, a butterfly combines the matrix's lanes in a
  // fixed order
  double2 phase = make_double2(1.0, 0.0);
  double logdet = 0.0;
  if (r < n) phase = unit_pivot(piv, swapped, logdet);
  combine_sign_logdet<W>(phase, logdet);

  // storage row r, column c holds A^-1[pos(r), the row at position c]
#pragma unroll
  for (int c = 0; c < W; ++c) {
    if (c >= n) break;
    const unsigned at = (__ballot_sync(kFull, pos == c) >> seg_base) & kSegMask;
    if (r < n) tile[pos][__ffs(at) - 1] = m[c];
  }
  __syncwarp();
  if (live) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i < n && r < n) ainv[base + i * n + r] = tile[i][r];
    }
    if (r == 0) {
      sign_out[mat] = phase;
      logdet_out[mat] = logdet;
    }
  }
}

// ---- the complex128 mid kernel (49 <= n <= 96) -------------------------------

__global__ void __launch_bounds__(kMidThreads, 1)
gj_mid_double_kernel(const double2* __restrict__ a, double2* __restrict__ ainv,
                     double2* __restrict__ sign_out, double* __restrict__ logdet_out,
                     int n) {
  constexpr int T = kMidTile;
  constexpr int Q = kMidN / 32;  // rows a lane scans
  extern __shared__ __align__(16) unsigned char gj_zmid_smem[];
  double2* tile = reinterpret_cast<double2*>(gj_zmid_smem);  // n x (n + 1): A^-1 out
  __shared__ double2 fcol[2][kMidN];  // column k of this step, by parity of k
  __shared__ double2 prow[2][kMidN];  // the scaled pivot row, the same
  __shared__ double2 piv[kMidN];      // each step's pivot
  __shared__ int swapped[kMidN];
  __shared__ int pos_s[kMidN];
  __shared__ int row_at_s[kMidN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int ld = n + 1;
  const int nn = n * n;
  const size_t base = static_cast<size_t>(blockIdx.x) * nn;

  // straight into registers: the 16 lanes of a lane-grid row read 256
  // contiguous bytes of a matrix row
  double2 m[T][T];
#pragma unroll
  for (int i = 0; i < T; ++i) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const int row = ty + 16 * i, col = tx + 16 * j;
      m[i][j] = (row < n && col < n) ? a[base + row * n + col] : make_double2(0.0, 0.0);
    }
  }

  // every warp scans rows lane + 32 q and keeps their positions
  int pos[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) pos[q] = lane + 32 * q;

  // k = 16 j0 + kx: j0 is unrolled so that column k is a static register
  // index of its owners (the lanes with tx == kx)
#pragma unroll
  for (int j0 = 0; j0 < T; ++j0) {
#pragma unroll 1
    for (int kx = 0; kx < 16; ++kx) {
      const int k = 16 * j0 + kx;
      if (k >= n) break;
      const int buf = k & 1;
      const bool owns_col = tx == kx;
      if (owns_col) {
#pragma unroll
        for (int i = 0; i < T; ++i) fcol[buf][ty + 16 * i] = m[i][j0];
      }
      __syncthreads();  // one: column k is published

      // the pivot: the largest (|.|^2, smallest position) pair among the
      // unused rows, compared as the key's two 32-bit halves, then the
      // position; every warp finds it alone, so no word crosses warps
      unsigned long long key[Q];
      unsigned long long mine = 0ull;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int row = lane + 32 * q;
        key[q] = row < n ? zpivot_key(fcol[buf][row], pos[q] >= k) : 0ull;
        mine = key[q] > mine ? key[q] : mine;
      }
      const unsigned hi =
          __reduce_max_sync(kFull, static_cast<unsigned>(mine >> 32));
      const unsigned lo = __reduce_max_sync(
          kFull, static_cast<unsigned>(mine >> 32) == hi
                     ? static_cast<unsigned>(mine)
                     : 0u);
      const unsigned long long kmax =
          (static_cast<unsigned long long>(hi) << 32) | lo;
      unsigned cand = 0xffffffffu;  // (position, row) of the smallest position
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (key[q] == kmax) {
          cand = min(cand, (static_cast<unsigned>(pos[q]) << 8) |
                               static_cast<unsigned>(lane + 32 * q));
        }
      }
      cand = __reduce_min_sync(kFull, cand);
      const int bpos = static_cast<int>(cand >> 8);
      const int brow = static_cast<int>(cand & 255u);
      const double2 bval = fcol[buf][brow];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (lane + 32 * q == brow) {
          pos[q] = k;
        } else if (pos[q] == k) {
          pos[q] = bpos;
        }
      }
      if (tid == 0) {  // sign and log|det| are formed from these at the end
        piv[k] = bval;
        swapped[k] = bpos != k;
      }

      // the pivot row's owners scale it in place and publish it, with d in
      // column k: the update below then leaves -f d in that column once its
      // owners have cleared it. Only they need d.
      if (ty == (brow & 15)) {
        const double inv_den = 1.0 / (bval.x * bval.x + bval.y * bval.y);
        const double2 d = make_double2(bval.x * inv_den, -bval.y * inv_den);
        const int ip = brow >> 4;
#pragma unroll
        for (int i = 0; i < T; ++i) {
          if (i == ip) {
#pragma unroll
            for (int j = 0; j < T; ++j) {
              m[i][j] = (tx + 16 * j == k) ? d : cmul_t(m[i][j], d);
              prow[buf][tx + 16 * j] = m[i][j];
            }
          }
        }
      }
      if (owns_col) {
#pragma unroll
        for (int i = 0; i < T; ++i) {
          if (ty + 16 * i != brow) m[i][j0] = make_double2(0.0, 0.0);
        }
      }
      __syncthreads();  // two: the pivot row is published

      double2 pr[T];
#pragma unroll
      for (int j = 0; j < T; ++j) pr[j] = prow[buf][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const int row = ty + 16 * i;
        // the pivot row is not eliminated
        const double2 f = row == brow ? make_double2(0.0, 0.0) : fcol[buf][row];
#pragma unroll
        for (int j = 0; j < T; ++j) {
          m[i][j].x = fma(f.y, pr[j].y, fma(-f.x, pr[j].x, m[i][j].x));
          m[i][j].y = fma(-f.y, pr[j].x, fma(-f.x, pr[j].y, m[i][j].y));
        }
      }
    }
  }

  // storage row r, column c holds A^-1[pos(r), row_at(c)]: warp 0 holds
  // every row's position
  if (tid < 32) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int row = lane + 32 * q;
      if (row < n) {
        pos_s[row] = pos[q];
        row_at_s[pos[q]] = row;
      }
    }
  }
  __syncthreads();
  int out_col[T];
#pragma unroll
  for (int j = 0; j < T; ++j) {
    out_col[j] = tx + 16 * j < n ? row_at_s[tx + 16 * j] : 0;
  }
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int row = ty + 16 * i;
    if (row < n) {
      const int out_row = pos_s[row];
#pragma unroll
      for (int j = 0; j < T; ++j) {
        if (tx + 16 * j < n) tile[out_row * ld + out_col[j]] = m[i][j];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < nn; e += kMidThreads) {
    const int i = e / n;
    ainv[base + e] = tile[i * ld + e - i * n];
  }

  // sign = prod piv / |piv| * (-1)^swaps, log|det| = sum 0.5 log|piv|^2:
  // lane q of warp 0 takes steps q + 32 i, then a butterfly combines the
  // lanes in a fixed order
  if (tid < 32) {
    double2 phase = make_double2(1.0, 0.0);
    double logdet = 0.0;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int k = lane + 32 * q;
      if (k < n) {
        double half_log;
        phase = cmul_t(phase, unit_pivot(piv[k], swapped[k], half_log));
        logdet += half_log;
      }
    }
    combine_sign_logdet<32>(phase, logdet);
    if (lane == 0) {
      sign_out[blockIdx.x] = phase;
      logdet_out[blockIdx.x] = logdet;
    }
  }
}

}  // namespace

extern "C" {

// The body that serves n x n matrices, by n alone: 1 warp, 2 registers,
// 3 mid, 4 mid wide, 0 shared (det_kernels.BODIES names them).
int gj_body(int n) {
  if (n <= 32) return 1;
  if (n == 48) return 2;
  if (n >= kMidMin && n <= kMidN) return 3;
  if (n > kMidN && n <= kMidWideN) return 4;
  return 0;
}

// Dynamic shared memory the body for n x n matrices needs per block.
long long gj_smem_bytes(int n) {
  switch (gj_body(n)) {
    case 0:
      return shared_body_bytes<float2>(n);
    case 3:
    case 4:
      return mid_tile_bytes<float2>(n);
    default:
      return 0;
  }
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
  const size_t smem = static_cast<size_t>(gj_smem_bytes(n));
  switch (gj_body(n)) {
    case 1:
      if (n <= 16) {
        const int per_block = 2 * kWarpBodyWarps;
        gj_warp_kernel<16><<<(batch + per_block - 1) / per_block,
                             32 * kWarpBodyWarps, 0, st>>>(ap, ip, sp, lp, batch, n);
      } else {
        gj_warp_kernel<32><<<(batch + kWarpBodyWarps - 1) / kWarpBodyWarps,
                             32 * kWarpBodyWarps, 0, st>>>(ap, ip, sp, lp, batch, n);
      }
      break;
    case 2:
      gj_registers_kernel<48><<<(batch + kRegWarps - 1) / kRegWarps,
                                32 * kRegWarps, 0, st>>>(ap, ip, sp, lp, batch);
      break;
    case 3: {
      const cudaError_t err = cudaFuncSetAttribute(
          gj_mid_kernel<kMidN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      gj_mid_kernel<kMidN><<<batch, kMidThreads, smem, st>>>(ap, ip, sp, lp, n);
      break;
    }
    case 4: {
      const cudaError_t err = cudaFuncSetAttribute(
          gj_mid_kernel<kMidWideN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      gj_mid_kernel<kMidWideN><<<batch, kMidThreads, smem, st>>>(ap, ip, sp, lp, n);
      break;
    }
    default: {
      const int err = launch_shared(ap, ip, sp, lp, batch, n, st);
      if (err != 0) return err;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The complex128 body that serves n x n matrices, by n alone: 2 warp
// (n <= 32), 1 registers (n = 48), 3 mid (49-96), 0 shared
// (det_kernels.BODIES_C128 names them).
int gj_body_c128(int n) {
  if (n <= 32) return 2;
  if (n == kZN) return 1;
  if (n >= kMidMin && n <= kMidN) return 3;
  return 0;
}

// Dynamic shared memory the complex128 body for n x n matrices needs per
// block (the warp body's tiles are static: 35,840 B a block of two warps).
long long gj_smem_bytes_c128(int n) {
  switch (gj_body_c128(n)) {
    case 1:
      return static_cast<long long>(sizeof(ZRegShared)) * kZMats;
    case 2:
      return 0;
    case 3:
      return mid_tile_bytes<double2>(n);
    default:
      return shared_body_bytes<double2>(n);
  }
}

// a, ainv: (batch, n, n) complex128; sign: (batch,) complex128; logdet:
// (batch,) float64. Returns the cudaError_t of the launch.
int gj_inverse_slogdet_launch_c128(const void* a, void* ainv, void* sign,
                                   void* logdet, int batch, int n,
                                   void* stream) {
  const auto* ap = static_cast<const double2*>(a);
  auto* ip = static_cast<double2*>(ainv);
  auto* sp = static_cast<double2*>(sign);
  auto* lp = static_cast<double*>(logdet);
  auto st = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(gj_smem_bytes_c128(n));
  switch (gj_body_c128(n)) {
    case 1: {
      const cudaError_t err = cudaFuncSetAttribute(
          gj_registers_double_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      gj_registers_double_kernel<<<(batch + kZMats - 1) / kZMats, 64 * kZMats,
                                   smem, st>>>(ap, ip, sp, lp, batch);
      break;
    }
    case 2:
      if (n <= 16) {
        const int per_block = 2 * kZWarpWarps;
        gj_warp_double_kernel<16><<<(batch + per_block - 1) / per_block,
                                    32 * kZWarpWarps, 0, st>>>(ap, ip, sp, lp, batch, n);
      } else {
        gj_warp_double_kernel<32><<<(batch + kZWarpWarps - 1) / kZWarpWarps,
                                    32 * kZWarpWarps, 0, st>>>(ap, ip, sp, lp, batch, n);
      }
      break;
    case 3: {
      const cudaError_t err = cudaFuncSetAttribute(
          gj_mid_double_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      gj_mid_double_kernel<<<batch, kMidThreads, smem, st>>>(ap, ip, sp, lp, n);
      break;
    }
    default: {
      const int err = launch_shared(ap, ip, sp, lp, batch, n, st);
      if (err != 0) return err;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
