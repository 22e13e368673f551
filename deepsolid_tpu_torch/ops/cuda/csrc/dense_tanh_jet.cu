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
// (T = 288, 6144 rows per 64-walker chunk, 320 -> 256) do 292 GFLOP on
// 4.1 GB; in full FP32 (no TF32: the reference measured a kinetic bias
// with reduced-precision products) the operations, not the bytes, set the
// bound, and the tensor cores are out. An FP32 FMA kernel reaches that
// bound only with an FMA in nearly every instruction slot, and an 8 x 8 register
// tile already draws its operands from shared memory at about the rate
// the load path returns them (16 128-bit loads per 256 FMAs of a warp,
// four schedulers sharing one path), so every load, barrier and epilogue
// instruction beyond that comes out of the rate. The two-electron layers
// (T = 6, 64 * 9216 rows, 32 -> 32) are bound by their bytes.
//
// Design: register-tiled FP32 FMA matrix products; walkers ride the row
// axis (rows are independent and w is shared). The TPU kernel carried the
// tangent square sum across a sequential grid axis in scratch memory;
// blocks on Hopper run in no order, so the sum is carried in registers by
// a loop over tangents inside the block, and jac @ w is written once,
// scaled by d, and never read back. Three variants, chosen by shape alone
// (jet_kernels.kernel_variant):
//   * pair (the two-electron layers: d_out = 32, d_in = 4 or 32, plain
//     rule): a streaming pass, not a matrix product. With d_out = 32 a
//     tile of rows is one contiguous run of every plane (val, each
//     jac[t], lap) on the way in and on the way out, w is 4 KB, and the
//     bytes bound the work. w and b stay in shared memory for the block's
//     life; each warp is a pipeline of its own that copies its 32-row
//     tiles of all T + 2 planes into a ring of shared-memory stages with
//     16-byte cp.async copies running ahead across planes and across row
//     tiles, and every output plane leaves through a staging tile as full
//     128-byte lines. One block barrier in all; see the note above
//     dense_tanh_jet_pair_kernel.
//   * general (any other shape that is not wide): a block owns 64 rows x
//     32 columns, each thread a 4 x 2 sub-tile, and loops over all
//     tangents; k-slices of the rows and of w are staged in shared memory.
//   * wide (the 256-wide one-electron layers, d_in up to 384): w is the
//     same for all T + 2 products of a block, so its column slice stays
//     in shared memory for the block's life and only the row tiles stream,
//     through a ring filled by asynchronous copies that run ahead of the
//     multiply; see the note above dense_tanh_jet_wide_kernel. Tangents
//     are sliced over the grid to fill the card from one 64-walker chunk;
//     each slice writes its partial square sums to scratch the wrapper
//     allocates, and a small second kernel closes the Laplacian in a fixed
//     order (no atomics: two launches on the same inputs agree bit for bit).
// float64 (precision='float64', through dense_tanh_jet_launch_f64; tanh in
// double, no TF32 anywhere) has three variants, closed and open:
//   * wide in double (the 256-wide layers, d_in up to 352): the products
//     run on the FP64 tensor cores (mma.sync .f64, IEEE double, so they
//     cost no accuracy where TF32 would bias E_L). The main path's
//     one-electron layers do 598 GFLOP on 20 GB in double: 8.9 ms at the
//     tensor cores' 67 TFLOP/s, 6.0 ms of bytes, 17.6 ms at the FMA-only
//     34 TFLOP/s, so FP64 FMAs alone could not reach the bound. A block
//     holds 64 x 64 outputs (a 64-column slice of w in double leaves no
//     room for more rows and a tanh tile). At the 320 -> 256 layer it runs
//     at about half the tensor rate (33 TFLOP/s on an H100) and moves under
//     1 TB/s, so what stands between it and the bound is the feeding of the
//     fragments (one block of 8 warps per SM, a barrier per k-slice, 24
//     shared loads per 16 products), not the bytes; see the note above
//     dense_tanh_jet_dmma_kernel.
//   * pair in double (the two-electron layers, plain rule, d_out = 32,
//     d_in = 4 or 32): the float32 pair variant's streaming design on
//     16-row warp tiles (a row takes twice the registers in double),
//     storing whole lines straight from the registers; FP64 fma: the bytes
//     bound these layers. It sums in the general variant's order, so the
//     two agree bit for bit; see the note above
//     dense_tanh_jet_pair_double_kernel.
//   * general in double (whatever the other two do not take): the general
//     variant templated on its scalar type, FP64 fma.
// The open form changes no product: the pair and general variants store
// the square sum they hold in registers instead of folding it into lap_o
// (a compile-time flag), and the wide variants run a second finishing
// kernel that sums the slices into sq_o and scales lap_o's linear part by d.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

// ---- the general variant --------------------------------------------------

constexpr int kBM = 64;        // rows per block
constexpr int kBK = 16;        // k-slice staged in shared memory
constexpr int kThreads = 256;  // 16 x 16 threads

// The general variant's arithmetic by scalar type: float (the float32
// runs) or double (the float64 runs; fma and tanh in double).
__device__ __forceinline__ float fma_s(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_s(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float tanh_s(float x) { return tanhf(x); }
__device__ __forceinline__ double tanh_s(double x) { return tanh(x); }

template <int TN, typename S>
struct Tiles {
  S a[kBM][kBK];
  S w[kBK][16 * TN];
};

// acc[i][j] = sum_k A[row0 + ty + 16 i, k] * w[k, col0 + tx + 16 j],
// zero outside the R x K and K x C ranges.
template <int TN, typename S>
__device__ __forceinline__ void tile_product(
    const S* __restrict__ A, const S* __restrict__ w, int R, int K,
    int C, int row0, int col0, Tiles<TN, S>& s, S (&acc)[4][TN]) {
  constexpr int BN = 16 * TN;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = S(0);

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int rr = e / kBK;
      const int kk = e - rr * kBK;
      const int gr = row0 + rr;
      const int gk = k0 + kk;
      s.a[rr][kk] =
          (gr < R && gk < K) ? A[static_cast<size_t>(gr) * K + gk] : S(0);
    }
    for (int e = tid; e < kBK * BN; e += kThreads) {
      const int kk = e / BN;
      const int cc = e - kk * BN;
      const int gk = k0 + kk;
      const int gc = col0 + cc;
      s.w[kk][cc] =
          (gk < K && gc < C) ? w[static_cast<size_t>(gk) * C + gc] : S(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      S av[4];
      S wv[TN];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = s.a[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) wv[j] = s.w[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma_s(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <int TN, bool MIX, bool OPEN, typename S>
__global__ void __launch_bounds__(kThreads) dense_tanh_jet_kernel(
    const S* __restrict__ val, const S* __restrict__ lap,
    const S* __restrict__ jac, const S* __restrict__ w,
    const S* __restrict__ b, const S* __restrict__ zbc,
    const S* __restrict__ lbc, const S* __restrict__ jbc,
    S* __restrict__ val_o, S* __restrict__ lap_o,
    S* __restrict__ jac_o, S* __restrict__ sq_o, int T, int R, int K,
    int C, int rows_per_group, int groups) {
  __shared__ Tiles<TN, S> s;
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

  S acc[4][TN];
  S tv[4][TN];  // tanh z; d = 1 - t^2 is recomputed where needed
  S sq[4][TN];

  tile_product<TN, S>(val, w, R, K, C, row0, col0, s, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const bool ok = row_ok[i] && col_ok[j];
      S z = acc[i][j];
      if (col_ok[j]) z += b[cols[j]];
      if (MIX && ok) z += zbc[static_cast<size_t>(grp[i]) * C + cols[j]];
      const S t = tanh_s(z);
      tv[i][j] = t;
      sq[i][j] = S(0);
      if (ok) val_o[static_cast<size_t>(rows[i]) * C + cols[j]] = t;
    }

  for (int t = 0; t < T; ++t) {
    tile_product<TN, S>(jac + static_cast<size_t>(t) * R * K, w, R, K, C, row0,
                        col0, s, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if (!(row_ok[i] && col_ok[j])) continue;
        S y = acc[i][j];
        if (MIX) {
          y += jbc[(static_cast<size_t>(t) * groups + grp[i]) * C + cols[j]];
        }
        jac_o[(static_cast<size_t>(t) * R + rows[i]) * C + cols[j]] =
            (S(1) - tv[i][j] * tv[i][j]) * y;
        sq[i][j] = fma_s(y, y, sq[i][j]);
      }
  }

  tile_product<TN, S>(lap, w, R, K, C, row0, col0, s, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (!(row_ok[i] && col_ok[j])) continue;
      S yl = acc[i][j];
      if (MIX) yl += lbc[static_cast<size_t>(grp[i]) * C + cols[j]];
      const S t = tv[i][j];
      const S d = S(1) - t * t;
      const size_t o = static_cast<size_t>(rows[i]) * C + cols[j];
      if (OPEN) {  // the caller sums sq_o over the ranks and closes lap
        lap_o[o] = d * yl;
        sq_o[o] = sq[i][j];
      } else {
        lap_o[o] = d * yl + (S(-2) * t * d) * sq[i][j];
      }
    }
}

// ---- the wide variant: 256-wide layers (d_out a multiple of 64) ----------
//
// A block of 256 threads owns 256 rows x 64 columns and a slice of the
// tangents. Its column slice of w (d_in x 64) is copied to shared memory
// once and serves every product of the block: the value, each tangent of
// the slice and (slice 0) the Laplacian. Only the row tiles stream: a ring
// of tiles of 256 rows x 16 or 32 k, filled with 16-byte cp.async
// copies that run ahead of the multiply across k-slices and across
// products, so a tangent's epilogue overlaps the next tangent's loads.
// One __syncthreads() per k-slice. A thread holds an 8 x 8 accumulator
// (rows ty + 4 i of its warp's 32, columns 4 tx .. 4 tx + 3 and 32 + 4 tx
// ..): 16 128-bit shared loads per 256 FMAs, the row tile read row-major
// as it was copied (the four row groups of a warp hit disjoint banks, the
// eight column groups are a broadcast). tanh z of the tile lives in shared
// memory, each thread reading back only what it wrote. Tangent slices
// ride the grid's z axis so that one 64-walker chunk fills the card for
// about three waves; each slice writes its jac_o rows and its partial
// square sum, slice 0 also val_o and the Laplacian's linear part, and a
// finishing kernel sums the partial sums in a fixed order.

constexpr int kWM = 256;      // rows per block
constexpr int kWN = 64;       // columns per block
constexpr int kWMaxK = 384;   // largest d_in whose w slice stays resident
constexpr size_t kWMaxSmem = 232448;  // dynamic shared memory of one block

// The ring of row tiles for a k-slice of BK: three stages of 16 or two of
// 32 (a deeper slice halves the barriers; the launcher takes it when it
// pads d_in no further). The row stride BK + 4 keeps rows 16-byte aligned
// and puts the four row groups of a warp on disjoint banks.
template <int BK>
struct Ring {
  static constexpr int kStride = BK + 4;
  static constexpr int kStages = BK == 16 ? 3 : 2;
  static constexpr int kFloats = kStages * kWM * kStride;
};

__host__ __device__ constexpr int wide_k_pad(int K, int BK) {
  return (K + BK - 1) / BK * BK;
}

// Dynamic shared memory of the wide kernel: w slice, tanh tile, ring.
template <int BK>
constexpr size_t wide_smem_bytes(int K) {
  return sizeof(float) * (static_cast<size_t>(wide_k_pad(K, BK)) * kWN +
                          kWM * kWN + Ring<BK>::kFloats);
}

// 16-byte asynchronous copy (four floats or two doubles); copies nothing
// and zero-fills when !valid.
template <typename S>
__device__ __forceinline__ void cp_async16(S* dst, const S* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool MIX, int kWK>
__global__ void __launch_bounds__(kThreads, 1) dense_tanh_jet_wide_kernel(
    const float* __restrict__ val, const float* __restrict__ lap,
    const float* __restrict__ jac, const float* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ zbc,
    const float* __restrict__ lbc, const float* __restrict__ jbc,
    float* __restrict__ val_o, float* __restrict__ lap_o,
    float* __restrict__ jac_o, float* __restrict__ sq_part, int T, int R,
    int K, int C, int rows_per_group, int groups, int t_per_slice) {
  constexpr int kWKP = Ring<kWK>::kStride;
  constexpr int kWStages = Ring<kWK>::kStages;
  extern __shared__ __align__(16) float wide_smem[];
  const int k_pad = wide_k_pad(K, kWK);
  float* w_s = wide_smem;                 // [k_pad][kWN]
  float* tanh_s = w_s + k_pad * kWN;      // [kWM][kWN]
  float* a_s = tanh_s + kWM * kWN;        // [kWStages][kWM][kWKP]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = lane & 7;
  const int ty = lane >> 3;
  const int row_l = (tid >> 5) * 32 + ty;  // this thread's rows: row_l + 4 i
  const int col0 = blockIdx.x * kWN;       // columns ride x: the blocks that
  const int row0 = blockIdx.y * kWM;       // share a row tile run together
  const int slice = blockIdx.z;
  const int t_begin = min(T, slice * t_per_slice);
  const int t_end = min(T, t_begin + t_per_slice);
  const int c_lo = col0 + tx * 4;          // this thread's columns:
  const int c_hi = c_lo + 32;              // c_lo .. + 3 and c_hi .. + 3

  // products of this block: the value, its tangents, (slice 0) the Laplacian
  const int n_prod = 1 + (t_end - t_begin) + (slice == 0 ? 1 : 0);
  const int nk = k_pad / kWK;
  const int total = n_prod * nk;
  const size_t rk = static_cast<size_t>(R) * K;

  // ---- the producer side: every thread copies its chunks of each tile ----
  constexpr int kChunks = kWK / 4;             // 16-byte chunks of a tile row
  constexpr int kLdRows = kThreads / kChunks;  // tile rows copied in one pass
  const int ld_row = tid / kChunks;            // rows ld_row + kLdRows q
  const int ld_k = (tid % kChunks) * 4;
  int fetched = 0, f_stage = 0, f_prod = 0, f_kt = 0;
  const float* f_base = val;
  auto fetch_tile = [&]() {
    if (fetched < total) {
      float* dst = a_s + f_stage * (kWM * kWKP) + ld_row * kWKP + ld_k;
      const int gk = f_kt * kWK + ld_k;
#pragma unroll
      for (int q = 0; q < kWM / kLdRows; ++q) {
        const int gr = row0 + ld_row + kLdRows * q;
        const bool ok = gr < R && gk < K;  // K % 4 == 0: all in or all out
        cp_async16(dst + q * kLdRows * kWKP,
                   ok ? f_base + static_cast<size_t>(gr) * K + gk : f_base,
                   ok);
      }
      if (++f_kt == nk) {
        f_kt = 0;
        ++f_prod;
        const int t = t_begin + f_prod - 1;
        f_base = t < t_end ? jac + static_cast<size_t>(t) * rk : lap;
      }
    }
    ++fetched;
    if (++f_stage == kWStages) f_stage = 0;
    cp_async_commit();  // one group per call, empty past the last tile
  };

  // the resident w slice rides the first group
  for (int e = tid; e < k_pad * (kWN / 4); e += kThreads) {
    const int kk = e / (kWN / 4);
    const int c4 = (e - kk * (kWN / 4)) * 4;
    const bool ok = kk < K;
    cp_async16(w_s + kk * kWN + c4,
               ok ? w + static_cast<size_t>(kk) * C + col0 + c4 : w, ok);
  }
#pragma unroll
  for (int s = 0; s < kWStages - 1; ++s) fetch_tile();

  int grp[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + row_l + 4 * i;
    grp[i] = (MIX && r < R) ? r / rows_per_group : 0;
  }

  float acc[8][8];
  float sq[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sq[i][j] = 0.f;

  int stage = 0;
  for (int p = 0; p < n_prod; ++p) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kWStages - 2>();  // this thread's share of the tile landed
      __syncthreads();                // everyone's did; the last one is consumed
      fetch_tile();                   // refills the last tile's stage
      const float* as = a_s + stage * (kWM * kWKP) + row_l * kWKP;
      if (++stage == kWStages) stage = 0;
      const float* ws = w_s + kt * kWK * kWN + tx * 4;
#pragma unroll
      for (int k4 = 0; k4 < kWK; k4 += 4) {
        float4 a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          a[i] = *reinterpret_cast<const float4*>(as + i * 4 * kWKP + k4);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 w0 =
              *reinterpret_cast<const float4*>(ws + (k4 + kk) * kWN);
          const float4 w1 =
              *reinterpret_cast<const float4*>(ws + (k4 + kk) * kWN + 32);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float av = kk == 0   ? a[i].x
                             : kk == 1 ? a[i].y
                             : kk == 2 ? a[i].z
                                       : a[i].w;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, wv[j], acc[i][j]);
          }
        }
      }
    }

    // ---- epilogue of product p; the next tiles are already in flight ----
    if (p == 0) {  // the value: tanh z into shared memory (and val_o)
      const float4 b_lo = *reinterpret_cast<const float4*>(b + c_lo);
      const float4 b_hi = *reinterpret_cast<const float4*>(b + c_hi);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = row0 + row_l + 4 * i;
        float z[8] = {acc[i][0] + b_lo.x, acc[i][1] + b_lo.y,
                      acc[i][2] + b_lo.z, acc[i][3] + b_lo.w,
                      acc[i][4] + b_hi.x, acc[i][5] + b_hi.y,
                      acc[i][6] + b_hi.z, acc[i][7] + b_hi.w};
        if (MIX && r < R) {
          const float* zp = zbc + static_cast<size_t>(grp[i]) * C;
          const float4 z_lo = *reinterpret_cast<const float4*>(zp + c_lo);
          const float4 z_hi = *reinterpret_cast<const float4*>(zp + c_hi);
          z[0] += z_lo.x; z[1] += z_lo.y; z[2] += z_lo.z; z[3] += z_lo.w;
          z[4] += z_hi.x; z[5] += z_hi.y; z[6] += z_hi.z; z[7] += z_hi.w;
        }
        const float4 t_lo = make_float4(tanhf(z[0]), tanhf(z[1]), tanhf(z[2]),
                                        tanhf(z[3]));
        const float4 t_hi = make_float4(tanhf(z[4]), tanhf(z[5]), tanhf(z[6]),
                                        tanhf(z[7]));
        float* ts = tanh_s + (row_l + 4 * i) * kWN + tx * 4;
        *reinterpret_cast<float4*>(ts) = t_lo;
        *reinterpret_cast<float4*>(ts + 32) = t_hi;
        if (slice == 0 && r < R) {
          float* vo = val_o + static_cast<size_t>(r) * C;
          *reinterpret_cast<float4*>(vo + c_lo) = t_lo;
          *reinterpret_cast<float4*>(vo + c_hi) = t_hi;
        }
      }
    } else if (p <= t_end - t_begin) {  // a tangent
      const int t = t_begin + p - 1;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = row0 + row_l + 4 * i;
        if (r >= R) continue;
        float y[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) y[j] = acc[i][j];
        if (MIX) {
          const float* jp =
              jbc + (static_cast<size_t>(t) * groups + grp[i]) * C;
          const float4 j_lo = *reinterpret_cast<const float4*>(jp + c_lo);
          const float4 j_hi = *reinterpret_cast<const float4*>(jp + c_hi);
          y[0] += j_lo.x; y[1] += j_lo.y; y[2] += j_lo.z; y[3] += j_lo.w;
          y[4] += j_hi.x; y[5] += j_hi.y; y[6] += j_hi.z; y[7] += j_hi.w;
        }
        const float* ts = tanh_s + (row_l + 4 * i) * kWN + tx * 4;
        const float4 t_lo = *reinterpret_cast<const float4*>(ts);
        const float4 t_hi = *reinterpret_cast<const float4*>(ts + 32);
        float* jo = jac_o + (static_cast<size_t>(t) * R + r) * C;
        *reinterpret_cast<float4*>(jo + c_lo) = make_float4(
            (1.f - t_lo.x * t_lo.x) * y[0], (1.f - t_lo.y * t_lo.y) * y[1],
            (1.f - t_lo.z * t_lo.z) * y[2], (1.f - t_lo.w * t_lo.w) * y[3]);
        *reinterpret_cast<float4*>(jo + c_hi) = make_float4(
            (1.f - t_hi.x * t_hi.x) * y[4], (1.f - t_hi.y * t_hi.y) * y[5],
            (1.f - t_hi.z * t_hi.z) * y[6], (1.f - t_hi.w * t_hi.w) * y[7]);
#pragma unroll
        for (int j = 0; j < 8; ++j) sq[i][j] = fmaf(y[j], y[j], sq[i][j]);
      }
    } else {  // slice 0: the Laplacian's linear part; a finishing kernel closes it
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = row0 + row_l + 4 * i;
        if (r >= R) continue;
        float4 l_lo = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        float4 l_hi = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        if (MIX) {
          const float* lp = lbc + static_cast<size_t>(grp[i]) * C;
          const float4 a_lo = *reinterpret_cast<const float4*>(lp + c_lo);
          const float4 a_hi = *reinterpret_cast<const float4*>(lp + c_hi);
          l_lo.x += a_lo.x; l_lo.y += a_lo.y; l_lo.z += a_lo.z; l_lo.w += a_lo.w;
          l_hi.x += a_hi.x; l_hi.y += a_hi.y; l_hi.z += a_hi.z; l_hi.w += a_hi.w;
        }
        float* lo = lap_o + static_cast<size_t>(r) * C;
        *reinterpret_cast<float4*>(lo + c_lo) = l_lo;
        *reinterpret_cast<float4*>(lo + c_hi) = l_hi;
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + row_l + 4 * i;
    if (r < R) {
      float* sp = sq_part + (static_cast<size_t>(slice) * R + r) * C;
      *reinterpret_cast<float4*>(sp + c_lo) =
          make_float4(sq[i][0], sq[i][1], sq[i][2], sq[i][3]);
      *reinterpret_cast<float4*>(sp + c_hi) =
          make_float4(sq[i][4], sq[i][5], sq[i][6], sq[i][7]);
    }
  }
}

// lap_o = d * lap_o + (-2 t d) * sum over slices of sq_part, t = val_o;
// S = float (the wide variant) or double (the float64 wide variant).
template <typename S>
__global__ void finish_lap_kernel(const S* __restrict__ val_o,
                                  S* __restrict__ lap_o,
                                  const S* __restrict__ sq_part, int slices,
                                  size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    S sum = S(0);
    for (int k = 0; k < slices; ++k) sum += sq_part[k * n + i];
    const S t = val_o[i];
    const S d = S(1) - t * t;
    lap_o[i] = d * lap_o[i] + (S(-2) * t * d) * sum;
  }
}

// The open form: sq_o = sum over slices of sq_part, lap_o = d * lap_o.
template <typename S>
__global__ void finish_open_kernel(const S* __restrict__ val_o,
                                   S* __restrict__ lap_o,
                                   const S* __restrict__ sq_part,
                                   S* __restrict__ sq_o, int slices, size_t n) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    S sum = S(0);
    for (int k = 0; k < slices; ++k) sum += sq_part[k * n + i];
    const S t = val_o[i];
    sq_o[i] = sum;
    lap_o[i] = (S(1) - t * t) * lap_o[i];
  }
}

// Closes the Laplacian of a sliced launch (or, with sq_o, leaves it open)
// over its R x C outputs, in a fixed order of the slices.
template <typename S>
int launch_finish(const S* val_o, S* lap_o, const S* sq_part, S* sq_o,
                  int slices, int R, int C, cudaStream_t stream) {
  const size_t n = static_cast<size_t>(R) * C;
  const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
  if (sq_o != nullptr) {
    finish_open_kernel<S><<<blocks, 256, 0, stream>>>(val_o, lap_o, sq_part,
                                                      sq_o, slices, n);
  } else {
    finish_lap_kernel<S><<<blocks, 256, 0, stream>>>(val_o, lap_o, sq_part,
                                                     slices, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- the float64 wide variant: the 256-wide layers on the FP64 tensor cores
//
// The same algorithm as the wide variant, in double, with the products on
// the FP64 tensor cores (mma.sync .f64; wgmma has no f64 form). A block of
// 256 threads owns 64 rows x 64 columns and a slice of the tangents. Its
// column slice of w (d_in x 64 doubles, rows padded to 68 against bank
// conflicts) is copied to shared memory once and serves every product of
// the block; row tiles of 64 rows x 16 k stream through a four-stage ring
// of 16-byte cp.async copies that runs ahead across k-slices and products,
// one __syncthreads() per k-slice. The budget in double decides the tile:
// w takes 544 bytes per row of d_in (174 KB at 320), the ring 40 KB, and
// tanh z, the tangent square sum and the accumulators stay in registers
// (16 doubles each a thread), so 64 columns fit only with 64 rows and
// d_in <= 352 fills the 227 KB a block may use exactly. A warp owns 32
// rows x 16 columns, 4 x 2 tiles of 8 x 8: per k-slice a lane loads 16 A
// and 8 B fragment doubles (24 64-bit shared loads, conflict-free: the ring
// row stride 20 and the w row stride 68 are 4 mod 16 doubles) and runs
// the 16384 flops as 16 m16n8k4 products. On an H100 (time_dmma.py)
// m8n8k4 runs at half the FP64 tensor rate (33 of 67 TFLOP/s) where the
// m16 shapes reach 66-67; m16n8k4 takes the smallest fragments of those
// (250 registers in the mix rule, no spills). Each of the four column
// blocks of a row tile re-reads its rows, from L2. Tangent slices ride the
// grid's z axis as in the wide variant, and the finishing kernels close
// the Laplacian in double in a fixed order. Each product adds its k onto
// the accumulator in order, one rounding each (IEEE double), and
// k = 4 s + t runs in order across the steps, so on
// an H100 the sums round exactly as the general body's FMA chain does and,
// with one tangent slice, the outputs equal its bit for bit (time_kernels'
// same_bits; more slices add the square sum in parts).

constexpr int kDM = 64;                 // rows per block
constexpr int kDN = 64;                 // columns per block
constexpr int kDK = 16;                 // k-slice of a ring stage
constexpr int kDStages = 4;             // ring stages
constexpr int kDStrideA = kDK + 4;      // doubles of a ring row
constexpr int kDStrideW = kDN + 4;      // doubles of a resident row of w
constexpr int kDMaxK = 352;             // largest d_in whose w slice stays resident

// Dynamic shared memory of the float64 wide kernel: w slice and ring.
constexpr size_t dmma_smem_bytes(int K) {
  return sizeof(double) *
         (static_cast<size_t>(wide_k_pad(K, kDK)) * kDStrideW +
          static_cast<size_t>(kDStages) * kDM * kDStrideA);
}

// D += A B on the FP64 tensor cores, one warp: mma.sync m16n8k4 .f64 in
// the PTX ISA's fragments (g = lane / 4, t = lane % 4; row.col):
// a_i = A[g + 8 i][t]; b = B[t][g]; c_i = D[g + 8 (i / 2)][2t + i % 2].
__device__ __forceinline__ void mma_m16n8k4(double (&c0)[2], double (&c1)[2],
                                            double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c0[0]), "+d"(c0[1]), "+d"(c1[0]), "+d"(c1[1])
      : "d"(a0), "d"(a1), "d"(b));
}

// One k-slice of a warp's 32 x 16 tile: acc[i][j] is the 8 x 8 tile of
// rows 8 i .. and columns 8 j .. of the warp. `as` points at the lane's
// ring row (g) and k (t), `ws` at the lane's row of w (t) and column (g);
// the slice's k = 4 s + t in both.
__device__ __forceinline__ void dmma_slice(const double* __restrict__ as,
                                           const double* __restrict__ ws,
                                           double (&acc)[4][2][2]) {
  double a[4][4];  // [m8 tile i][k step s]
  double b[2][4];  // [n8 tile j][k step s]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int s = 0; s < 4; ++s) a[i][s] = as[8 * i * kDStrideA + 4 * s];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int s = 0; s < 4; ++s) b[j][s] = ws[4 * s * kDStrideW + 8 * j];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 4; i += 2)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mma_m16n8k4(acc[i][j], acc[i + 1][j], a[i][s], a[i + 1][s], b[j][s]);
}

template <bool MIX>
__global__ void __launch_bounds__(kThreads, 1) dense_tanh_jet_dmma_kernel(
    const double* __restrict__ val, const double* __restrict__ lap,
    const double* __restrict__ jac, const double* __restrict__ w,
    const double* __restrict__ b, const double* __restrict__ zbc,
    const double* __restrict__ lbc, const double* __restrict__ jbc,
    double* __restrict__ val_o, double* __restrict__ lap_o,
    double* __restrict__ jac_o, double* __restrict__ sq_part, int T, int R,
    int K, int C, int rows_per_group, int groups, int t_per_slice) {
  extern __shared__ __align__(16) double dmma_smem[];
  const int k_pad = wide_k_pad(K, kDK);
  double* w_s = dmma_smem;                  // [k_pad][kDStrideW]
  double* a_s = w_s + k_pad * kDStrideW;    // [kDStages][kDM][kDStrideA]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row_w = (warp >> 2) * 32;       // the warp's rows row_w .. + 31
  const int col_w = (warp & 3) * 16;        // and columns col_w .. + 15
  const int col0 = blockIdx.x * kDN;        // columns ride x: the blocks that
  const int row0 = blockIdx.y * kDM;        // share a row tile run together
  const int slice = blockIdx.z;
  const int t_begin = min(T, slice * t_per_slice);
  const int t_end = min(T, t_begin + t_per_slice);

  // products of this block: the value, its tangents, (slice 0) the Laplacian
  const int n_prod = 1 + (t_end - t_begin) + (slice == 0 ? 1 : 0);
  const int nk = k_pad / kDK;
  const int total = n_prod * nk;
  const size_t rk = static_cast<size_t>(R) * K;

  // ---- the producer side: every thread copies its chunks of each tile ----
  constexpr int kChunks = kDK / 2;             // 16-byte chunks of a tile row
  constexpr int kLdRows = kThreads / kChunks;  // tile rows copied in one pass
  const int ld_row = tid / kChunks;            // rows ld_row + kLdRows q
  const int ld_k = (tid % kChunks) * 2;
  int fetched = 0, f_stage = 0, f_prod = 0, f_kt = 0;
  const double* f_base = val;
  auto fetch_tile = [&]() {
    if (fetched < total) {
      double* dst = a_s + f_stage * (kDM * kDStrideA) + ld_row * kDStrideA + ld_k;
      const int gk = f_kt * kDK + ld_k;
#pragma unroll
      for (int q = 0; q < kDM / kLdRows; ++q) {
        const int gr = row0 + ld_row + kLdRows * q;
        const bool ok = gr < R && gk < K;  // K % 4 == 0: all in or all out
        cp_async16(dst + q * kLdRows * kDStrideA,
                   ok ? f_base + static_cast<size_t>(gr) * K + gk : f_base, ok);
      }
      if (++f_kt == nk) {
        f_kt = 0;
        ++f_prod;
        const int t = t_begin + f_prod - 1;
        f_base = t < t_end ? jac + static_cast<size_t>(t) * rk : lap;
      }
    }
    ++fetched;
    if (++f_stage == kDStages) f_stage = 0;
    cp_async_commit();  // one group per call, empty past the last tile
  };

  // the resident w slice rides the first group
  for (int e = tid; e < k_pad * (kDN / 2); e += kThreads) {
    const int kk = e / (kDN / 2);
    const int c2 = (e - kk * (kDN / 2)) * 2;
    const bool ok = kk < K;
    cp_async16(w_s + kk * kDStrideW + c2,
               ok ? w + static_cast<size_t>(kk) * C + col0 + c2 : w, ok);
  }
#pragma unroll
  for (int s = 0; s < kDStages - 1; ++s) fetch_tile();

  // the lane's outputs: rows row0 + row_w + 8 i + g, columns
  // col0 + col_w + 8 j + 2 t4 and the one after
  int rows[4], grp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rows[i] = row0 + row_w + 8 * i + g;
    grp[i] = (MIX && rows[i] < R) ? rows[i] / rows_per_group : 0;
  }
  int cols[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) cols[j] = col0 + col_w + 8 * j + 2 * t4;

  double acc[4][2][2];
  double tv[4][2][2];  // tanh z; d = 1 - t^2 is recomputed where needed
  double sq[4][2][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) sq[i][j][0] = sq[i][j][1] = 0.0;

  const double* a_lane = a_s + (row_w + g) * kDStrideA + t4;
  const double* w_lane = w_s + t4 * kDStrideW + col_w + g;
  int stage = 0;
  for (int p = 0; p < n_prod; ++p) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;

    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kDStages - 2>();  // this thread's share of the tile landed
      __syncthreads();                // everyone's did; the last one is consumed
      fetch_tile();                   // refills the last tile's stage
      dmma_slice(a_lane + stage * (kDM * kDStrideA),
                      w_lane + kt * kDK * kDStrideW, acc);
      if (++stage == kDStages) stage = 0;
    }

    // ---- epilogue of product p; the next tiles are already in flight ----
    if (p == 0) {  // the value: tanh z (and val_o)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const double2 bj = *reinterpret_cast<const double2*>(b + cols[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          double z0 = acc[i][j][0] + bj.x;
          double z1 = acc[i][j][1] + bj.y;
          if (MIX && rows[i] < R) {
            const double2 zb = *reinterpret_cast<const double2*>(
                zbc + static_cast<size_t>(grp[i]) * C + cols[j]);
            z0 += zb.x;
            z1 += zb.y;
          }
          tv[i][j][0] = tanh(z0);
          tv[i][j][1] = tanh(z1);
          if (slice == 0 && rows[i] < R) {
            *reinterpret_cast<double2*>(
                val_o + static_cast<size_t>(rows[i]) * C + cols[j]) =
                make_double2(tv[i][j][0], tv[i][j][1]);
          }
        }
      }
    } else if (p <= t_end - t_begin) {  // a tangent
      const int t = t_begin + p - 1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (rows[i] >= R) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          double y0 = acc[i][j][0];
          double y1 = acc[i][j][1];
          if (MIX) {
            const double2 jb = *reinterpret_cast<const double2*>(
                jbc + (static_cast<size_t>(t) * groups + grp[i]) * C + cols[j]);
            y0 += jb.x;
            y1 += jb.y;
          }
          const double u0 = tv[i][j][0];
          const double u1 = tv[i][j][1];
          *reinterpret_cast<double2*>(
              jac_o + (static_cast<size_t>(t) * R + rows[i]) * C + cols[j]) =
              make_double2((1.0 - u0 * u0) * y0, (1.0 - u1 * u1) * y1);
          sq[i][j][0] = fma(y0, y0, sq[i][j][0]);
          sq[i][j][1] = fma(y1, y1, sq[i][j][1]);
        }
      }
    } else {  // slice 0: the Laplacian's linear part; a finishing kernel closes it
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (rows[i] >= R) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          double l0 = acc[i][j][0];
          double l1 = acc[i][j][1];
          if (MIX) {
            const double2 lb = *reinterpret_cast<const double2*>(
                lbc + static_cast<size_t>(grp[i]) * C + cols[j]);
            l0 += lb.x;
            l1 += lb.y;
          }
          *reinterpret_cast<double2*>(
              lap_o + static_cast<size_t>(rows[i]) * C + cols[j]) =
              make_double2(l0, l1);
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (rows[i] >= R) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      *reinterpret_cast<double2*>(
          sq_part + (static_cast<size_t>(slice) * R + rows[i]) * C + cols[j]) =
          make_double2(sq[i][j][0], sq[i][j][1]);
    }
  }
}

// ---- the pair variant: d_out = 32, d_in = 4 or 32, plain rule -------------
//
// The two-electron layers move 1.9 GB per 64-walker chunk for 20 GFLOP:
// the bytes bound them, and what a block has to do is keep loads in
// flight and write full lines. w (4 KB at most) and b are copied to shared
// memory once and stay for the block's life. Every warp is then a pipeline
// of its own over tiles of 32 rows, tile after tile (a persistent grid,
// tiles dealt out warp by warp): the tile's T + 2 input planes (val,
// jac[0..T), lap) are each one contiguous run of 32 * d_in floats, copied
// with 16-byte cp.async into a three-stage ring that belongs to the warp
// and runs ahead across planes and across tiles, so a plane's arithmetic
// and stores overlap the next planes' loads and only __syncwarp() orders
// anything after the one barrier behind the copy of w. A lane owns 4 rows
// x 8 columns of the tile (rows 4 rg + i, columns 4 cg .. + 3 and 16 + 4 cg
// ..): 12 shared-memory values feed 32 FMAs, where a lane per row would
// draw a value per FMA and wait on the load path; the ring's row stride of
// d_in + 4 floats (d_in = 4: no padding, one 16-byte load is a row) keeps
// the 128-bit loads conflict-free. tanh z and the tangent square sum stay
// in registers across the tangent loop, and each output plane goes through
// a staging tile from which the warp writes 512 contiguous bytes per store
// instruction.

constexpr int kPC = 32;                // d_out
constexpr int kPRows = 32;             // rows of a warp's tile
constexpr int kPWarps = 6;             // independent pipelines of a block:
                                       // two blocks (12 warps) fill an SM's
                                       // shared memory at d_in = 32
constexpr int kPThreads = 32 * kPWarps;
constexpr int kPStages = 3;            // ring stages of one input plane tile
constexpr int kPOutStride = kPC + 4;   // staging rows, 16-byte aligned

template <int K>
struct PairTile {
  static constexpr int kStride = K == 4 ? 4 : K + 4;  // floats of a ring row
  static constexpr int kStage = kPRows * kStride;
  static constexpr int kWarpFloats = kPStages * kStage + kPRows * kPOutStride;
  static constexpr int kWFloats = (K + 1) * kPC;  // w, then b
  static constexpr size_t kSmem =
      sizeof(float) * (kWFloats + kPWarps * kWarpFloats);
};

template <int K, bool OPEN>
__global__ void __launch_bounds__(kPThreads, 2) dense_tanh_jet_pair_kernel(
    const float* __restrict__ val, const float* __restrict__ lap,
    const float* __restrict__ jac, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ val_o,
    float* __restrict__ lap_o, float* __restrict__ jac_o,
    float* __restrict__ sq_o, int T, int R) {
  using Tile = PairTile<K>;
  extern __shared__ __align__(16) float pair_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = lane >> 2;  // rows 4 rg + i of the tile
  const int cg = lane & 3;   // columns 4 cg .. + 3 and 16 + 4 cg .. + 3
  float* w_s = pair_smem;                  // [K][32]
  const float* b_s = w_s + K * kPC;        // [32]
  float* ring = pair_smem + Tile::kWFloats + warp * Tile::kWarpFloats;
  float* out_s = ring + kPStages * Tile::kStage;

  const int n_tiles = (R + kPRows - 1) / kPRows;
  const int n_warps = gridDim.x * kPWarps;
  const int first = blockIdx.x * kPWarps + warp;  // tiles first + i * n_warps
  const int my_tiles =
      first < n_tiles ? (n_tiles - first + n_warps - 1) / n_warps : 0;
  const int n_planes = T + 2;
  const int total = my_tiles * n_planes;
  const size_t plane_in = static_cast<size_t>(R) * K;
  const size_t plane_out = static_cast<size_t>(R) * kPC;

  // ---- the producer side: the warp copies one plane tile per call ----
  constexpr int kChunks = K / 4;  // 16-byte chunks of a row
  int fetched = 0, f_stage = 0, f_plane = 0, f_tile = first;
  auto fetch = [&]() {
    if (fetched < total) {
      const float* base =
          f_plane == 0 ? val
          : f_plane <= T ? jac + static_cast<size_t>(f_plane - 1) * plane_in
                         : lap;
      const int row0 = f_tile * kPRows;
      float* dst = ring + f_stage * Tile::kStage;
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        const int e = lane + 32 * q;  // consecutive lanes, consecutive chunks
        const int r = e / kChunks;
        const int kc = (e % kChunks) * 4;
        const bool ok = row0 + r < R;
        cp_async16(dst + r * Tile::kStride + kc,
                   ok ? base + static_cast<size_t>(row0 + r) * K + kc : base,
                   ok);
      }
      if (++f_plane == n_planes) {
        f_plane = 0;
        f_tile += n_warps;
      }
    }
    ++fetched;
    if (++f_stage == kPStages) f_stage = 0;
    cp_async_commit();  // one group per call, empty past the last tile
  };

  // one output plane of the tile: the lane's 4 x 8 values into the staging
  // tile, then the warp writes four whole rows (512 contiguous bytes) per
  // instruction
  auto store_plane = [&](float* __restrict__ dst, const float (&v)[4][8],
                         int row0) {
    __syncwarp();  // the last plane's read-back is done
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* mine = out_s + (4 * rg + i) * kPOutStride + 4 * cg;
      *reinterpret_cast<float4*>(mine) =
          make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
      *reinterpret_cast<float4*>(mine + 16) =
          make_float4(v[i][4], v[i][5], v[i][6], v[i][7]);
    }
    __syncwarp();
    const int r = lane >> 3;
    const int c = (lane & 7) * 4;
#pragma unroll
    for (int m = 0; m < kPRows / 4; ++m) {
      const int rr = 4 * m + r;
      const float4 x =
          *reinterpret_cast<const float4*>(out_s + rr * kPOutStride + c);
      if (row0 + rr < R) {
        *reinterpret_cast<float4*>(
            dst + static_cast<size_t>(row0 + rr) * kPC + c) = x;
      }
    }
  };

  // the ring starts filling while w and b are copied
#pragma unroll
  for (int s = 0; s < kPStages - 1; ++s) fetch();
  for (int e = threadIdx.x; e < K * kPC; e += kPThreads) w_s[e] = w[e];
  if (threadIdx.x < kPC) w_s[K * kPC + threadIdx.x] = b[threadIdx.x];
  __syncthreads();  // the block's only barrier

  float tv[4][8];  // tanh z of the lane's sub-tile; d = 1 - t^2 is recomputed
  float sq[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) tv[i][j] = sq[i][j] = 0.f;

  int stage = 0;
  for (int it = 0; it < my_tiles; ++it) {
    const int row0 = (first + it * n_warps) * kPRows;
    for (int p = 0; p < n_planes; ++p) {
      cp_async_wait<kPStages - 2>();  // this lane's share of the plane landed
      __syncwarp();                   // every lane's did; the last is consumed
      fetch();                        // refills the last plane's stage
      const float* as =
          ring + stage * Tile::kStage + 4 * rg * Tile::kStride;
      if (++stage == kPStages) stage = 0;

      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
      for (int k4 = 0; k4 < K; k4 += 4) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = *reinterpret_cast<const float4*>(as + i * Tile::kStride + k4);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* wr = w_s + (k4 + kk) * kPC + 4 * cg;
          const float4 w0 = *reinterpret_cast<const float4*>(wr);
          const float4 w1 = *reinterpret_cast<const float4*>(wr + 16);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float av = kk == 0   ? a[i].x
                             : kk == 1 ? a[i].y
                             : kk == 2 ? a[i].z
                                       : a[i].w;
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, wv[j], acc[i][j]);
          }
        }
      }

      if (p == 0) {  // the value
        const float4 b0 = *reinterpret_cast<const float4*>(b_s + 4 * cg);
        const float4 b1 = *reinterpret_cast<const float4*>(b_s + 16 + 4 * cg);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float t = tanhf(acc[i][j] + bv[j]);
            tv[i][j] = t;
            sq[i][j] = 0.f;
            acc[i][j] = t;
          }
        store_plane(val_o, acc, row0);
      } else if (p <= T) {  // a tangent
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float y = acc[i][j];
            sq[i][j] = fmaf(y, y, sq[i][j]);
            acc[i][j] = (1.f - tv[i][j] * tv[i][j]) * y;
          }
        store_plane(jac_o + static_cast<size_t>(p - 1) * plane_out, acc, row0);
      } else {  // the Laplacian, closed here or left open with sq_o
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float t = tv[i][j];
            const float d = 1.f - t * t;
            acc[i][j] = OPEN ? d * acc[i][j]
                             : d * acc[i][j] + (-2.f * t * d) * sq[i][j];
          }
        store_plane(lap_o, acc, row0);
        if (OPEN) store_plane(sq_o, sq, row0);
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left
}

// ---- the pair variant in double: the same layers at precision='float64' --
//
// The float32 pair variant's design in double: w and b resident in shared
// memory, every warp a pipeline over its own row tiles with a three-stage
// cp.async ring that runs ahead across planes and tiles, tanh z and the
// square sum in registers across the tangent loop, whole 128-byte lines
// out, one block barrier, no atomics. Double changes the tile. A lane
// keeps its outputs, tanh z and square sum in registers, 3 doubles an
// output: the float32 lane tile of 4 x 8 would take 192 registers where two
// blocks of 192 threads leave 170, so a warp owns 16 rows, a lane 4 rows x
// 4 columns (rows rg + 4 i, columns 2 cg, 2 cg + 1, 16 + 2 cg, 17 + 2 cg):
// 48 doubles, 160-164 registers, no spill. Each pair of k draws 4 16-byte
// row loads (4 distinct addresses on disjoint banks with the ring row
// stride of d_in + 2 doubles) and 4 16-byte w loads (one 128-byte row half
// each) for 32 DFMAs. The eight lanes of a row group hold two whole
// 128-byte lines of each of their rows, so the outputs leave straight from
// the registers; the float32 body's staging tile, which makes its lines
// whole, only added shared-memory traffic and two warp barriers a plane in
// double and measured slower (time_pair_variants). At 32 -> 32 the DFMAs
// are ~40% of the bytes' time at the FMA-only rate and hide under the
// copies (a copy-only build is within a few percent), so the tensor cores
// are not used. Each output is the general body in double's arithmetic in
// the general body's order (one accumulator from 0, k ascending, fma; the
// tangents' squares summed in order), and the epilogue's roundings are
// written out as nvcc contracts the general body's (1 - t^2) and d * yl +
// (-2 t d) * sq on sm_90a: fma(-t, t, 1) and fma(d, yl, (-2 t d) * sq).
// Left to the compiler here, the Laplacian contracted the other way (1 ulp
// apart); written out, the two bodies agree bit for bit (time_kernels' and
// chip_smoke's same_bits).

constexpr int kPRowsD = 16;   // rows of a warp's tile in double

// Shared memory of a block in double: w and b (33 x 32 doubles at d_in 32)
// and per warp kPStagesD ring stages of 16 rows x (d_in + 2) doubles:
// 86,784 B at d_in 32 with three stages, so two blocks (12 warps) with the
// 1 KB the system keeps per block fit an SM's 228 KB; registers allow no
// third block (160-164 a thread).
constexpr int kPStagesD = 3;  // ring stages of one input plane tile in double
template <int K>
struct PairTileD {
  static constexpr int kStride = K == 4 ? 4 : K + 2;  // doubles of a ring row
  static constexpr int kStage = kPRowsD * kStride;
  static constexpr int kWarpDoubles = kPStagesD * kStage;
  static constexpr int kWDoubles = (K + 1) * kPC;  // w, then b
  static constexpr size_t kSmem =
      sizeof(double) * (kWDoubles + kPWarps * kWarpDoubles);
};
static_assert(2 * (PairTileD<32>::kSmem + 1024) <= 228 * 1024,
              "two blocks of the pair variant in double fit an SM");

template <int K, bool OPEN>
__global__ void __launch_bounds__(kPThreads, 2) dense_tanh_jet_pair_double_kernel(
    const double* __restrict__ val, const double* __restrict__ lap,
    const double* __restrict__ jac, const double* __restrict__ w,
    const double* __restrict__ b, double* __restrict__ val_o,
    double* __restrict__ lap_o, double* __restrict__ jac_o,
    double* __restrict__ sq_o, int T, int R) {
  using Tile = PairTileD<K>;
  extern __shared__ __align__(16) double pair_double_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = lane >> 3;  // rows rg + 4 i of the tile
  const int cg = lane & 7;   // columns 2 cg, 2 cg + 1 and 16 + 2 cg, 17 + 2 cg
  double* w_s = pair_double_smem;           // [K][32]
  const double* b_s = w_s + K * kPC;        // [32]
  double* ring = pair_double_smem + Tile::kWDoubles + warp * Tile::kWarpDoubles;

  const int n_tiles = (R + kPRowsD - 1) / kPRowsD;
  const int n_warps = gridDim.x * kPWarps;
  const int first = blockIdx.x * kPWarps + warp;  // tiles first + i * n_warps
  const int my_tiles =
      first < n_tiles ? (n_tiles - first + n_warps - 1) / n_warps : 0;
  const int n_planes = T + 2;
  const int total = my_tiles * n_planes;
  const size_t plane_in = static_cast<size_t>(R) * K;
  const size_t plane_out = static_cast<size_t>(R) * kPC;

  // ---- the producer side: the warp copies one plane tile per call ----
  constexpr int kChunks = K / 2;                       // 16-byte chunks of a row
  constexpr int kCopies = kPRowsD * kChunks / 32;      // per lane: 8 or 1
  int fetched = 0, f_stage = 0, f_plane = 0, f_tile = first;
  auto fetch = [&]() {
    if (fetched < total) {
      const double* base =
          f_plane == 0 ? val
          : f_plane <= T ? jac + static_cast<size_t>(f_plane - 1) * plane_in
                         : lap;
      const int row0 = f_tile * kPRowsD;
      double* dst = ring + f_stage * Tile::kStage;
#pragma unroll
      for (int q = 0; q < kCopies; ++q) {
        const int e = lane + 32 * q;  // consecutive lanes, consecutive chunks
        const int r = e / kChunks;
        const int kc = (e % kChunks) * 2;
        const bool ok = row0 + r < R;
        cp_async16(dst + r * Tile::kStride + kc,
                   ok ? base + static_cast<size_t>(row0 + r) * K + kc : base,
                   ok);
      }
      if (++f_plane == n_planes) {
        f_plane = 0;
        f_tile += n_warps;
      }
    }
    ++fetched;
    if (++f_stage == kPStagesD) f_stage = 0;
    cp_async_commit();  // one group per call, empty past the last tile
  };

  // one output plane of the tile, straight from the registers: for each
  // of its rows a lane writes two 16-byte pieces, and the eight lanes of a
  // row group fill the row's two 128-byte lines, one per instruction
  auto store_plane = [&](double* __restrict__ dst, const double (&v)[4][4],
                         int row0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + rg + 4 * i;
      if (r < R) {
        double* o = dst + static_cast<size_t>(r) * kPC + 2 * cg;
        *reinterpret_cast<double2*>(o) = make_double2(v[i][0], v[i][1]);
        *reinterpret_cast<double2*>(o + 16) = make_double2(v[i][2], v[i][3]);
      }
    }
  };

  // the ring starts filling while w and b are copied
#pragma unroll
  for (int s = 0; s < kPStagesD - 1; ++s) fetch();
  for (int e = threadIdx.x; e < K * kPC; e += kPThreads) w_s[e] = w[e];
  if (threadIdx.x < kPC) w_s[K * kPC + threadIdx.x] = b[threadIdx.x];
  __syncthreads();  // the block's only barrier

  double tv[4][4];  // tanh z of the lane's sub-tile; d = 1 - t^2 is recomputed
  double sq[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) tv[i][j] = sq[i][j] = 0.0;

  int stage = 0;
  for (int it = 0; it < my_tiles; ++it) {
    const int row0 = (first + it * n_warps) * kPRowsD;
    for (int p = 0; p < n_planes; ++p) {
      cp_async_wait<kPStagesD - 2>();  // this lane's share of the plane landed
      __syncwarp();                   // every lane's did; the last is consumed
      fetch();                        // refills the last plane's stage
      const double* as = ring + stage * Tile::kStage + rg * Tile::kStride;
      if (++stage == kPStagesD) stage = 0;

      double acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0;
#pragma unroll
      for (int k2 = 0; k2 < K; k2 += 2) {
        double2 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = *reinterpret_cast<const double2*>(as + 4 * i * Tile::kStride + k2);
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const double* wr = w_s + (k2 + kk) * kPC + 2 * cg;
          const double2 w0 = *reinterpret_cast<const double2*>(wr);
          const double2 w1 = *reinterpret_cast<const double2*>(wr + 16);
          const double wv[4] = {w0.x, w0.y, w1.x, w1.y};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const double av = kk == 0 ? a[i].x : a[i].y;
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fma(av, wv[j], acc[i][j]);
          }
        }
      }

      if (p == 0) {  // the value
        const double2 b0 = *reinterpret_cast<const double2*>(b_s + 2 * cg);
        const double2 b1 = *reinterpret_cast<const double2*>(b_s + 16 + 2 * cg);
        const double bv[4] = {b0.x, b0.y, b1.x, b1.y};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            double z = acc[i][j];
            z += bv[j];
            const double t = tanh(z);
            tv[i][j] = t;
            sq[i][j] = 0.0;
            acc[i][j] = t;
          }
        store_plane(val_o, acc, row0);
      } else if (p <= T) {  // a tangent
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const double y = acc[i][j];
            acc[i][j] = fma(-tv[i][j], tv[i][j], 1.0) * y;
            sq[i][j] = fma(y, y, sq[i][j]);
          }
        store_plane(jac_o + static_cast<size_t>(p - 1) * plane_out, acc, row0);
      } else {  // the Laplacian, closed here or left open with sq_o
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const double yl = acc[i][j];
            const double t = tv[i][j];
            const double d = fma(-t, t, 1.0);
            acc[i][j] = OPEN ? d * yl : fma(d, yl, (-2.0 * t * d) * sq[i][j]);
          }
        store_plane(lap_o, acc, row0);
        if (OPEN) store_plane(sq_o, sq, row0);
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left
}

// The pair variant's kernel and block budget by scalar type: float32's
// 32-row warp tiles or double's 16-row ones.
template <int K, typename S>
struct PairBody;
template <int K>
struct PairBody<K, float> {
  static constexpr int kRows = kPRows;
  static constexpr size_t kSmem = PairTile<K>::kSmem;
  static auto kernel(bool open) {
    return open ? dense_tanh_jet_pair_kernel<K, true>
                : dense_tanh_jet_pair_kernel<K, false>;
  }
};
template <int K>
struct PairBody<K, double> {
  static constexpr int kRows = kPRowsD;
  static constexpr size_t kSmem = PairTileD<K>::kSmem;
  static auto kernel(bool open) {
    return open ? dense_tanh_jet_pair_double_kernel<K, true>
                : dense_tanh_jet_pair_double_kernel<K, false>;
  }
};

template <int K, typename S>
int launch_pair(const S* val, const S* lap, const S* jac, const S* w,
                const S* b, S* val_o, S* lap_o, S* jac_o, S* sq_o, int T,
                int R, cudaStream_t stream) {
  using Body = PairBody<K, S>;
  auto kernel = Body::kernel(sq_o != nullptr);
  const size_t smem = Body::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // a persistent grid: as many blocks as the card holds at once
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPThreads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (R + Body::kRows - 1) / Body::kRows;
  const int blocks = std::max(
      1, std::min((n_tiles + kPWarps - 1) / kPWarps, sms * std::max(per_sm, 1)));
  kernel<<<blocks, kPThreads, smem, stream>>>(val, lap, jac, w, b, val_o, lap_o,
                                              jac_o, sq_o, T, R);
  return static_cast<int>(cudaGetLastError());
}

template <bool MIX, int BK>
cudaError_t launch_wide_main(const float* val, const float* lap,
                             const float* jac, const float* w, const float* b,
                             const float* zbc, const float* lbc,
                             const float* jbc, float* val_o, float* lap_o,
                             float* jac_o, float* sq_part, int slices, int T,
                             int R, int K, int C, int rows_per_group,
                             int groups, cudaStream_t stream) {
  const size_t smem = wide_smem_bytes<BK>(K);
  const cudaError_t err = cudaFuncSetAttribute(
      dense_tanh_jet_wide_kernel<MIX, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int t_per_slice = (T + slices - 1) / slices;
  const dim3 grid(C / kWN, (R + kWM - 1) / kWM, slices);
  dense_tanh_jet_wide_kernel<MIX, BK><<<grid, kThreads, smem, stream>>>(
      val, lap, jac, w, b, zbc, lbc, jbc, val_o, lap_o, jac_o, sq_part, T, R,
      K, C, rows_per_group, groups, t_per_slice);
  return cudaGetLastError();
}

template <bool MIX>
int launch_wide(const float* val, const float* lap, const float* jac,
                const float* w, const float* b, const float* zbc,
                const float* lbc, const float* jbc, float* val_o, float* lap_o,
                float* jac_o, float* sq_part, float* sq_o, int slices, int T,
                int R, int K, int C, int rows_per_group, int groups,
                cudaStream_t stream) {
  if (K > kWMaxK || K % 4 != 0 || C % kWN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the deeper k-slice when it pads d_in no further and its ring fits
  // beside the w slice in the 227 KB a block may use
  const cudaError_t err =
      (wide_k_pad(K, 32) == wide_k_pad(K, 16) &&
       wide_smem_bytes<32>(K) <= kWMaxSmem)
          ? launch_wide_main<MIX, 32>(val, lap, jac, w, b, zbc, lbc, jbc, val_o,
                                      lap_o, jac_o, sq_part, slices, T, R, K,
                                      C, rows_per_group, groups, stream)
          : launch_wide_main<MIX, 16>(val, lap, jac, w, b, zbc, lbc, jbc, val_o,
                                      lap_o, jac_o, sq_part, slices, T, R, K,
                                      C, rows_per_group, groups, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_finish<float>(val_o, lap_o, sq_part, sq_o, slices, R, C,
                              stream);
}

template <bool MIX>
int launch_dmma(const double* val, const double* lap, const double* jac,
                const double* w, const double* b, const double* zbc,
                const double* lbc, const double* jbc, double* val_o,
                double* lap_o, double* jac_o, double* sq_part, double* sq_o,
                int slices, int T, int R, int K, int C, int rows_per_group,
                int groups, cudaStream_t stream) {
  if (K > kDMaxK || K % 4 != 0 || C % kDN != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = dense_tanh_jet_dmma_kernel<MIX>;
  const size_t smem = dmma_smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int t_per_slice = (T + slices - 1) / slices;
  const dim3 grid(C / kDN, (R + kDM - 1) / kDM, slices);
  kernel<<<grid, kThreads, smem, stream>>>(val, lap, jac, w, b, zbc, lbc, jbc,
                                           val_o, lap_o, jac_o, sq_part, T, R,
                                           K, C, rows_per_group, groups,
                                           t_per_slice);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_finish<double>(val_o, lap_o, sq_part, sq_o, slices, R, C,
                               stream);
}

template <int TN, bool MIX, typename S>
int launch(const S* val, const S* lap, const S* jac, const S* w, const S* b,
           const S* zbc, const S* lbc, const S* jbc, S* val_o, S* lap_o,
           S* jac_o, S* sq_o, int T, int R, int K, int C, int rows_per_group,
           int groups, cudaStream_t stream) {
  const dim3 grid((R + kBM - 1) / kBM, (C + 16 * TN - 1) / (16 * TN));
  if (sq_o != nullptr) {
    dense_tanh_jet_kernel<TN, MIX, true, S><<<grid, kThreads, 0, stream>>>(
        val, lap, jac, w, b, zbc, lbc, jbc, val_o, lap_o, jac_o, sq_o, T, R, K,
        C, rows_per_group, groups);
  } else {
    dense_tanh_jet_kernel<TN, MIX, false, S><<<grid, kThreads, 0, stream>>>(
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
// The caller chooses the variant (jet_kernels.kernel_variant): slices > 0
// runs the wide one, which needs C % 64 == 0, K % 4 == 0, K <= 384, every
// pointer 16-byte aligned and `slices` * R * C floats of scratch;
// slices < 0 runs the pair one, which needs the plain rule, C == 32, K ==
// 4 or 32 and every pointer 16-byte aligned (either returns
// cudaErrorInvalidValue for another shape); slices = 0 runs the general
// one (scratch unused). Returns the cudaError_t of the launches.
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
  if (slices < 0) {
    if (mix || C != kPC || (K != 4 && K != 32)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return K == 4 ? launch_pair<4>(v, l, jc, wp, bp, vo, lo, jo, so, T, R, st)
                  : launch_pair<32>(v, l, jc, wp, bp, vo, lo, jo, so, T, R, st);
  }
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

// The float64 form of dense_tanh_jet_launch: the same arguments and
// layouts in double. slices > 0 runs the float64 wide variant on the FP64
// tensor cores, which needs C % 64 == 0, K % 4 == 0, K <= 352, every
// pointer 16-byte aligned and `slices` * R * C doubles of scratch; slices
// < 0 runs the pair variant in double, which needs the plain rule, C ==
// 32, K == 4 or 32 and every pointer 16-byte aligned (either returns
// cudaErrorInvalidValue for another shape); slices = 0 runs the general
// variant in double (scratch unused). Returns the cudaError_t of the
// launches.
int dense_tanh_jet_launch_f64(const void* val, const void* lap,
                              const void* jac, const void* w, const void* b,
                              const void* zbc, const void* lbc,
                              const void* jbc, void* val_o, void* lap_o,
                              void* jac_o, void* scratch, void* sq_out,
                              int slices, int T, int R, int K, int C,
                              int rows_per_group, int groups, void* stream) {
  const auto* v = static_cast<const double*>(val);
  const auto* l = static_cast<const double*>(lap);
  const auto* jc = static_cast<const double*>(jac);
  const auto* wp = static_cast<const double*>(w);
  const auto* bp = static_cast<const double*>(b);
  const auto* zp = static_cast<const double*>(zbc);
  const auto* lp = static_cast<const double*>(lbc);
  const auto* jp = static_cast<const double*>(jbc);
  auto* vo = static_cast<double*>(val_o);
  auto* lo = static_cast<double*>(lap_o);
  auto* jo = static_cast<double*>(jac_o);
  auto* so = static_cast<double*>(sq_out);
  auto st = static_cast<cudaStream_t>(stream);
  if (slices < 0) {
    if (zbc != nullptr || C != kPC || (K != 4 && K != 32)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return K == 4 ? launch_pair<4>(v, l, jc, wp, bp, vo, lo, jo, so, T, R, st)
                  : launch_pair<32>(v, l, jc, wp, bp, vo, lo, jo, so, T, R, st);
  }
  if (slices > 0) {
    auto* sp = static_cast<double*>(scratch);
    return zbc != nullptr
               ? launch_dmma<true>(v, l, jc, wp, bp, zp, lp, jp, vo, lo, jo,
                                   sp, so, slices, T, R, K, C, rows_per_group,
                                   groups, st)
               : launch_dmma<false>(v, l, jc, wp, bp, zp, lp, jp, vo, lo, jo,
                                    sp, so, slices, T, R, K, C, rows_per_group,
                                    groups, st);
  }
  return zbc != nullptr
             ? launch<2, true>(v, l, jc, wp, bp, zp, lp, jp, vo, lo, jo, so, T,
                               R, K, C, rows_per_group, groups, st)
             : launch<2, false>(v, l, jc, wp, bp, zp, lp, jp, vo, lo, jo, so,
                                T, R, K, C, rows_per_group, groups, st);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
