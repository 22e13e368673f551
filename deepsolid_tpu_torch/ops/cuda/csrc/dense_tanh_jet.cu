// Fused dense + tanh forward-Laplacian jet rule for Hopper (sm_90a).
//
// Replaces four TPU kernels of deepsolid_tpu/ops/pallas/jet_kernels.py:
//   * fused_dense_tanh_jet (body _kernel): the two-electron trunk layers;
//   * fused_dense_tanh_jet_mix (_fused_mix_call, body _kernel_mix): the
//     one-electron trunk layers, whose row-constant block enters
//     precontracted as zbc, lbc (per walker) and jbc (per tangent and
//     walker), added to every row of that walker;
//   * fused_dense_tanh_jet_partial (body _kernel_partial) and
//     fused_dense_tanh_jet_mix_partial (body _kernel_mix_partial): the same
//     two rules for a tangent axis that is sharded over ranks. jac holds
//     this rank's T_local tangents only, and the tangent square sum is
//     left open: the kernel returns it as a fourth output for the caller
//     to sum over the ranks.
//
// What it computes, rows r, output columns c, tangents t < T:
//   z  = val @ w + b (+ zbc)        t_ = tanh z       d = 1 - t_^2
//   y_t = jac[t] @ w (+ jbc[t])     jac_o[t] = d * y_t
//   closed: lap_o = d * (lap @ w (+ lbc)) - 2 t_ d * sum_t y_t^2
//   open:   lap_o = d * (lap @ w (+ lbc)),   sq_o = sum_t y_t^2
//           (the caller closes lap = lap_o - 2 t_ d * sum over ranks of sq_o)
//
// What bounds it on this card: the main path's one-electron layers
// (T = 288, 6144 rows per 64-walker chunk, 320 -> 256) do 290 GFLOP on
// 4.1 GB; in full FP32 (no TF32: the reference measured a kinetic bias
// with reduced-precision products) the operations, not the bytes, set the
// bound. The two-electron layers (T = 6, 64 * 9216 rows, 32 -> 32) are
// bound by their bytes.
//
// Design: register-tiled FP32 FMA matrix products; walkers ride the row
// axis (rows are independent and w is shared). The TPU kernel carried the
// tangent square sum across a sequential grid axis in scratch memory;
// blocks on Hopper run in no order, so the sum is carried in registers by
// a loop over tangents inside the block, and jac @ w is written once,
// scaled by d, and never read back. Two variants:
//   * narrow (any other shape, such as the 32-wide two-electron layers):
//     a block owns 64 rows x 32 columns, each thread a 4 x 2 sub-tile, and
//     loops over all tangents.
//   * wide (the 256-wide one-electron layers): a block owns 128 rows x 64
//     columns and a slice of the tangents; each thread an 8 x 4 sub-tile
//     read as 128-bit shared-memory loads (3 loads per 32 FMAs, where the
//     narrow variant issues 1 load per 2 FMAs). Slicing the tangents over
//     the grid fills the card several times over at one 64-walker chunk;
//     each slice writes its partial square sums to scratch the wrapper
//     allocates, and a small second kernel closes the Laplacian.
// The open form changes no product: the narrow variant stores the square
// sum it holds in registers instead of folding it into lap_o (a
// compile-time flag), and the wide variant runs a second finishing kernel
// that sums the slices into sq_o and scales lap_o's linear part by d.
// k-slices of the input rows and of w are staged in shared memory.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kBM = 64;        // rows per block
constexpr int kBK = 16;        // k-slice staged in shared memory
constexpr int kThreads = 256;  // 16 x 16 threads

template <int TN>
struct Tiles {
  float a[kBM][kBK];
  float w[kBK][16 * TN];
};

// acc[i][j] = sum_k A[row0 + ty + 16 i, k] * w[k, col0 + tx + 16 j],
// zero outside the R x K and K x C ranges.
template <int TN>
__device__ __forceinline__ void tile_product(
    const float* __restrict__ A, const float* __restrict__ w, int R, int K,
    int C, int row0, int col0, Tiles<TN>& s, float (&acc)[4][TN]) {
  constexpr int BN = 16 * TN;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int rr = e / kBK;
      const int kk = e - rr * kBK;
      const int gr = row0 + rr;
      const int gk = k0 + kk;
      s.a[rr][kk] =
          (gr < R && gk < K) ? A[static_cast<size_t>(gr) * K + gk] : 0.f;
    }
    for (int e = tid; e < kBK * BN; e += kThreads) {
      const int kk = e / BN;
      const int cc = e - kk * BN;
      const int gk = k0 + kk;
      const int gc = col0 + cc;
      s.w[kk][cc] =
          (gk < K && gc < C) ? w[static_cast<size_t>(gk) * C + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4];
      float wv[TN];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = s.a[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) wv[j] = s.w[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <int TN, bool MIX, bool OPEN>
__global__ void __launch_bounds__(kThreads) dense_tanh_jet_kernel(
    const float* __restrict__ val, const float* __restrict__ lap,
    const float* __restrict__ jac, const float* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ zbc,
    const float* __restrict__ lbc, const float* __restrict__ jbc,
    float* __restrict__ val_o, float* __restrict__ lap_o,
    float* __restrict__ jac_o, float* __restrict__ sq_o, int T, int R, int K,
    int C, int rows_per_group, int groups) {
  __shared__ Tiles<TN> s;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * 16 * TN;

  int rows[4];
  int grp[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rows[i] = row0 + ty + 16 * i;
    row_ok[i] = rows[i] < R;
    grp[i] = MIX ? (row_ok[i] ? rows[i] / rows_per_group : 0) : 0;
  }
  int cols[TN];
  bool col_ok[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    cols[j] = col0 + tx + 16 * j;
    col_ok[j] = cols[j] < C;
  }

  float acc[4][TN];
  float tv[4][TN];  // tanh z; d = 1 - t^2 is recomputed where needed
  float sq[4][TN];

  tile_product<TN>(val, w, R, K, C, row0, col0, s, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const bool ok = row_ok[i] && col_ok[j];
      float z = acc[i][j];
      if (col_ok[j]) z += b[cols[j]];
      if (MIX && ok) z += zbc[static_cast<size_t>(grp[i]) * C + cols[j]];
      const float t = tanhf(z);
      tv[i][j] = t;
      sq[i][j] = 0.f;
      if (ok) val_o[static_cast<size_t>(rows[i]) * C + cols[j]] = t;
    }

  for (int t = 0; t < T; ++t) {
    tile_product<TN>(jac + static_cast<size_t>(t) * R * K, w, R, K, C, row0,
                     col0, s, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if (!(row_ok[i] && col_ok[j])) continue;
        float y = acc[i][j];
        if (MIX) {
          y += jbc[(static_cast<size_t>(t) * groups + grp[i]) * C + cols[j]];
        }
        jac_o[(static_cast<size_t>(t) * R + rows[i]) * C + cols[j]] =
            (1.f - tv[i][j] * tv[i][j]) * y;
        sq[i][j] = fmaf(y, y, sq[i][j]);
      }
  }

  tile_product<TN>(lap, w, R, K, C, row0, col0, s, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (!(row_ok[i] && col_ok[j])) continue;
      float yl = acc[i][j];
      if (MIX) yl += lbc[static_cast<size_t>(grp[i]) * C + cols[j]];
      const float t = tv[i][j];
      const float d = 1.f - t * t;
      const size_t o = static_cast<size_t>(rows[i]) * C + cols[j];
      if (OPEN) {  // the caller sums sq_o over the ranks and closes lap
        lap_o[o] = d * yl;
        sq_o[o] = sq[i][j];
      } else {
        lap_o[o] = d * yl + (-2.f * t * d) * sq[i][j];
      }
    }
}

// ---- the wide variant: 256-wide layers (d_out a multiple of 64) ----------
//
// A block owns 128 rows x 64 columns and a slice of the tangents; each of
// its 256 threads holds an 8 x 4 sub-tile and reads its operands as 128-bit
// shared-memory loads (3 loads per 32 FMAs). tanh z of the tile lives in
// shared memory. Tangent slices ride the grid's z axis so a 64-walker
// chunk fills the card several times over; each slice writes its jac_o
// rows and its partial square sum, slice 0 also val_o and the Laplacian's
// linear part, and finish_lap_kernel closes lap_o from the partial sums.

constexpr int kWM = 128;  // rows per block
constexpr int kWN = 64;   // columns per block
constexpr int kWK = 16;   // k-slice staged in shared memory
constexpr int kWPad = 4;  // keeps the transposed row tile 16-byte aligned

struct WideTiles {
  float a[kWK][kWM + kWPad];  // k-major: a thread's 8 rows are contiguous
  float w[kWK][kWN];
};

__device__ __forceinline__ void wide_product(
    const float* __restrict__ A, const float* __restrict__ w, int R, int K,
    int C, int row0, int col0, WideTiles& s, float (&acc)[8][4]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kWK) {
    for (int e = tid; e < kWM * kWK / 4; e += kThreads) {
      const int rr = e >> 2;
      const int k4 = (e & 3) * 4;
      const int gr = row0 + rr;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gr < R && k0 + k4 < K) {  // K % 4 == 0: a float4 is all in or out
        v = *reinterpret_cast<const float4*>(A + static_cast<size_t>(gr) * K + k0 + k4);
      }
      s.a[k4 + 0][rr] = v.x;
      s.a[k4 + 1][rr] = v.y;
      s.a[k4 + 2][rr] = v.z;
      s.a[k4 + 3][rr] = v.w;
    }
    {
      const int kk = tid >> 4;
      const int c4 = (tid & 15) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + kk < K) {
        v = *reinterpret_cast<const float4*>(w + static_cast<size_t>(k0 + kk) * C + col0 + c4);
      }
      *reinterpret_cast<float4*>(&s.w[kk][c4]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.a[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&s.a[kk][ty * 8 + 4]);
      const float4 wv = *reinterpret_cast<const float4*>(&s.w[kk][tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <bool MIX>
__global__ void __launch_bounds__(kThreads, 2) dense_tanh_jet_wide_kernel(
    const float* __restrict__ val, const float* __restrict__ lap,
    const float* __restrict__ jac, const float* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ zbc,
    const float* __restrict__ lbc, const float* __restrict__ jbc,
    float* __restrict__ val_o, float* __restrict__ lap_o,
    float* __restrict__ jac_o, float* __restrict__ sq_part, int T, int R,
    int K, int C, int rows_per_group, int groups, int t_per_slice) {
  __shared__ __align__(16) WideTiles s;
  __shared__ __align__(16) float tanh_tile[kWM][kWN];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * kWM;
  const int col0 = blockIdx.y * kWN;
  const int slice = blockIdx.z;
  const int t_begin = slice * t_per_slice;
  const int t_end = min(T, t_begin + t_per_slice);
  const int c = col0 + tx * 4;  // this thread's 4 columns: c .. c + 3

  float acc[8][4];
  wide_product(val, w, R, K, C, row0, col0, s, acc);
  const float4 bias = *reinterpret_cast<const float4*>(b + c);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + ty * 8 + i;
    float4 z = make_float4(acc[i][0] + bias.x, acc[i][1] + bias.y,
                           acc[i][2] + bias.z, acc[i][3] + bias.w);
    if (MIX && r < R) {
      const float4 zb = *reinterpret_cast<const float4*>(
          zbc + static_cast<size_t>(r / rows_per_group) * C + c);
      z.x += zb.x; z.y += zb.y; z.z += zb.z; z.w += zb.w;
    }
    const float4 t = make_float4(tanhf(z.x), tanhf(z.y), tanhf(z.z), tanhf(z.w));
    *reinterpret_cast<float4*>(&tanh_tile[ty * 8 + i][tx * 4]) = t;
    if (slice == 0 && r < R) {
      *reinterpret_cast<float4*>(val_o + static_cast<size_t>(r) * C + c) = t;
    }
  }

  float sq[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sq[i][j] = 0.f;
  for (int t = t_begin; t < t_end; ++t) {
    wide_product(jac + static_cast<size_t>(t) * R * K, w, R, K, C, row0, col0,
                 s, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + ty * 8 + i;
      if (r >= R) continue;
      float y[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
      if (MIX) {
        const float4 jb = *reinterpret_cast<const float4*>(
            jbc + (static_cast<size_t>(t) * groups + r / rows_per_group) * C + c);
        y[0] += jb.x; y[1] += jb.y; y[2] += jb.z; y[3] += jb.w;
      }
      const float4 tv = *reinterpret_cast<const float4*>(&tanh_tile[ty * 8 + i][tx * 4]);
      const float4 out = make_float4((1.f - tv.x * tv.x) * y[0], (1.f - tv.y * tv.y) * y[1],
                                     (1.f - tv.z * tv.z) * y[2], (1.f - tv.w * tv.w) * y[3]);
      *reinterpret_cast<float4*>(jac_o + (static_cast<size_t>(t) * R + r) * C + c) = out;
#pragma unroll
      for (int j = 0; j < 4; ++j) sq[i][j] = fmaf(y[j], y[j], sq[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + ty * 8 + i;
    if (r < R) {
      *reinterpret_cast<float4*>(
          sq_part + (static_cast<size_t>(slice) * R + r) * C + c) =
          make_float4(sq[i][0], sq[i][1], sq[i][2], sq[i][3]);
    }
  }

  if (slice == 0) {  // the Laplacian's linear part; finish_lap_kernel closes it
    wide_product(lap, w, R, K, C, row0, col0, s, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + ty * 8 + i;
      if (r >= R) continue;
      float4 yl = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      if (MIX) {
        const float4 lb = *reinterpret_cast<const float4*>(
            lbc + static_cast<size_t>(r / rows_per_group) * C + c);
        yl.x += lb.x; yl.y += lb.y; yl.z += lb.z; yl.w += lb.w;
      }
      *reinterpret_cast<float4*>(lap_o + static_cast<size_t>(r) * C + c) = yl;
    }
  }
}

// lap_o = d * lap_o + (-2 t d) * sum over slices of sq_part, t = val_o.
__global__ void finish_lap_kernel(const float* __restrict__ val_o,
                                  float* __restrict__ lap_o,
                                  const float* __restrict__ sq_part,
                                  int slices, size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float sum = 0.f;
    for (int k = 0; k < slices; ++k) sum += sq_part[k * n + i];
    const float t = val_o[i];
    const float d = 1.f - t * t;
    lap_o[i] = d * lap_o[i] + (-2.f * t * d) * sum;
  }
}

// The open form: sq_o = sum over slices of sq_part, lap_o = d * lap_o.
__global__ void finish_open_kernel(const float* __restrict__ val_o,
                                   float* __restrict__ lap_o,
                                   const float* __restrict__ sq_part,
                                   float* __restrict__ sq_o, int slices,
                                   size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float sum = 0.f;
    for (int k = 0; k < slices; ++k) sum += sq_part[k * n + i];
    const float t = val_o[i];
    sq_o[i] = sum;
    lap_o[i] = (1.f - t * t) * lap_o[i];
  }
}

template <bool MIX>
int launch_wide(const float* val, const float* lap, const float* jac,
                const float* w, const float* b, const float* zbc,
                const float* lbc, const float* jbc, float* val_o, float* lap_o,
                float* jac_o, float* sq_part, float* sq_o, int slices, int T,
                int R, int K, int C, int rows_per_group, int groups,
                cudaStream_t stream) {
  const int t_per_slice = (T + slices - 1) / slices;
  const dim3 grid((R + kWM - 1) / kWM, C / kWN, slices);
  dense_tanh_jet_wide_kernel<MIX><<<grid, kThreads, 0, stream>>>(
      val, lap, jac, w, b, zbc, lbc, jbc, val_o, lap_o, jac_o, sq_part, T, R,
      K, C, rows_per_group, groups, t_per_slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(R) * C;
  const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
  if (sq_o != nullptr) {
    finish_open_kernel<<<blocks, 256, 0, stream>>>(val_o, lap_o, sq_part, sq_o,
                                                   slices, n);
  } else {
    finish_lap_kernel<<<blocks, 256, 0, stream>>>(val_o, lap_o, sq_part,
                                                  slices, n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int TN, bool MIX>
int launch(const float* val, const float* lap, const float* jac,
           const float* w, const float* b, const float* zbc, const float* lbc,
           const float* jbc, float* val_o, float* lap_o, float* jac_o,
           float* sq_o, int T, int R, int K, int C, int rows_per_group,
           int groups, cudaStream_t stream) {
  const dim3 grid((R + kBM - 1) / kBM, (C + 16 * TN - 1) / (16 * TN));
  if (sq_o != nullptr) {
    dense_tanh_jet_kernel<TN, MIX, true><<<grid, kThreads, 0, stream>>>(
        val, lap, jac, w, b, zbc, lbc, jbc, val_o, lap_o, jac_o, sq_o, T, R, K,
        C, rows_per_group, groups);
  } else {
    dense_tanh_jet_kernel<TN, MIX, false><<<grid, kThreads, 0, stream>>>(
        val, lap, jac, w, b, zbc, lbc, jbc, val_o, lap_o, jac_o, sq_o, T, R, K,
        C, rows_per_group, groups);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// val, lap: (R, K); jac: (T, R, K); w: (K, C); b: (C,); outputs val_o,
// lap_o: (R, C) and jac_o: (T, R, C), all float32 and contiguous. For the
// mix variant zbc, lbc: (groups, C) and jbc: (T, groups, C), row r
// belonging to group r / rows_per_group; pass null zbc for the plain rule.
// A non-null sq_out (R, C) selects the open form: it receives the tangent
// square sum and lap_o keeps d * (lap @ w (+ lbc)) only; null closes the
// Laplacian in the kernel.
// The caller chooses the variant (jet_kernels.wide_slices): slices > 0
// runs the wide one, which needs C % 64 == 0, K % 4 == 0, every pointer
// 16-byte aligned and `slices` * R * C floats of scratch; slices = 0 runs
// the narrow one (scratch unused). Returns the cudaError_t of the launches.
int dense_tanh_jet_launch(const void* val, const void* lap, const void* jac,
                          const void* w, const void* b, const void* zbc,
                          const void* lbc, const void* jbc, void* val_o,
                          void* lap_o, void* jac_o, void* scratch,
                          void* sq_out, int slices, int T, int R, int K, int C,
                          int rows_per_group, int groups, void* stream) {
  const auto* v = static_cast<const float*>(val);
  const auto* l = static_cast<const float*>(lap);
  const auto* jc = static_cast<const float*>(jac);
  const auto* wp = static_cast<const float*>(w);
  const auto* bp = static_cast<const float*>(b);
  const auto* zp = static_cast<const float*>(zbc);
  const auto* lp = static_cast<const float*>(lbc);
  const auto* jp = static_cast<const float*>(jbc);
  auto* vo = static_cast<float*>(val_o);
  auto* lo = static_cast<float*>(lap_o);
  auto* jo = static_cast<float*>(jac_o);
  auto* so = static_cast<float*>(sq_out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool mix = zbc != nullptr;
  if (slices > 0) {
    auto* sp = static_cast<float*>(scratch);
    return mix ? launch_wide<true>(v, l, jc, wp, bp, zp, lp, jp, vo, lo, jo,
                                   sp, so, slices, T, R, K, C, rows_per_group,
                                   groups, st)
               : launch_wide<false>(v, l, jc, wp, bp, zp, lp, jp, vo, lo, jo,
                                    sp, so, slices, T, R, K, C, rows_per_group,
                                    groups, st);
  }
  return mix ? launch<2, true>(v, l, jc, wp, bp, zp, lp, jp, vo, lo, jo, so, T,
                               R, K, C, rows_per_group, groups, st)
             : launch<2, false>(v, l, jc, wp, bp, zp, lp, jp, vo, lo, jo, so,
                                T, R, K, C, rows_per_group, groups, st);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
