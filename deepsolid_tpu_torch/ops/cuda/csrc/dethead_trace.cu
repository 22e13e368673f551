// The determinant head's tangent stream for Hopper (sm_90a): complex64 and
// complex128, one template on the scalar.
//
// Replaces no TPU kernel: deepsolid_tpu/ops/pallas/ has none for this
// stream, which the JAX package leaves to XLA (deepsolid_tpu/ops/fwdlap.py:
// mul_row, then slogdet_jet's batched product and trace contractions).
// On this card the same chain ran as six
// passes over the orbital Jacobian (a broadcast add, the complex copy, the
// envelope-phase product, a strided reshape, a complex GEMM that wrote
// A^-1 J_t at full width, and a permuted reduction), each one a read and a
// write of the largest tensor of the determinant head.
//
// What it computes, per (walker b, determinant d) matrix of one spin
// channel (n electrons of the channel = n orbitals) and per tangent t of
// this call's window [t0, t0 + T_loc) of the 3 N_total coordinates:
//   J_t[i][k]  = complex(jr[t, b, i, d n + k] + jbc[t, b, d n + k],
//                        jr[t, b, i, P + d n + k] + jbc[t, b, P + d n + k])
//                * ep_val[b, d, i, k]                          (P = ndet n)
//              + [i == (t0 + t) / 3 - offset] orb_val0[b, d, i, k]
//                * ep_jac3[(t0 + t) % 3, b, d, i, k]
//   M_t = A^-1 J_t
//   trb[t, b, d] = tr M_t,   l2[b, d] = sum_t sum_ik M_t[i][k] M_t[k][i]
// (fl.mul_row's Jacobian, then slogdet_jet's tr(A^-1 J_t) and
// sum_t tr((A^-1 J_t)^2)); jbc, the row-constant block's tangents, may be
// absent. With the tangents split over S blocks a matrix, each block
// writes its partial l2, which the caller sums in a fixed order.
//
// What bounds it on this card: the operations. A^-1 J_t costs 8 n^3 flops
// a matrix and tangent against 8 n^2 bytes of jr read (complex64), about
// n flops a byte: 48 at C-diamond's n = 48, 81 at bcc-Li's, both above
// the card's ridge of ~20 (67 TFLOP/s of FP32 FMA over 3.35 TB/s). At the
// FP32 FMA peak C-diamond's 512 matrices x 288 tangents take 1.95 ms a
// channel; reading jr once takes 0.81 ms.
//
// Design. One block a matrix (and a slice of its tangents), a loop over
// the tangents inside the block. A^-1 stays in shared memory for the whole
// loop (transposed, so that a thread's four rows of a column are one
// 32-byte read). Each tangent's J_t is formed once, on its way from
// device memory into shared memory: the row-constant add, the
// envelope-phase product and the slab row in registers, nothing written
// back. The product runs out of shared memory with a 4 x TC register tile
// of M_t a thread (rows 4r..4r+3, columns 2c, 2c+1, 2c+2G, 2c+2G+1, ... for
// G column groups): per k, 2 + TC/2 reads of 16 or 32 bytes feed 16 TC
// FMAs (complex64), so the FMA pipes and not the shared-memory port set
// the pace. TC is 4 up to n = 84 (448 threads at most) and 6 above.
// M_t then goes to shared memory, so that each thread reads the transposed
// partner of its entries for sum M_ik M_ki, and one warp sums the
// diagonal. Complex64 stages M_t in a buffer of its own up to n = 96,
// which leaves two block barriers a tangent (J_t stored; M_t stored);
// complex128, and complex64 above 96, stage it over J_t (three buffers
// would not fit a block: at n = 112 two take 202 KB) and take four.
// Above n = 96 complex64 takes 4 x 8 tiles (n = 112: 392 threads, one
// block an SM): per k, 6 reads of 16 bytes feed 128 FMAs; Si 2x2x2's 256
// matrices of 112 and 672 tangents took 79 ms against a bound of 28.9.
// What the chip showed: the loop is bound by latency
// (each tangent's reads of device memory and its barriers), so the
// resident blocks decide the time. Complex64 is compiled to 96 registers,
// which lets four blocks of C-diamond's n = 48 share an SM (three at 109
// registers took 1.5x as long); reading the next tangent into registers
// during the product cost more registers than it hid latency. The
// tangents of a matrix are split over up to 8 blocks (grid.y): more and
// shorter blocks balance the last wave and overlap one block's loads of
// A^-1 with another's products. At C-diamond's 512 matrices of 48 and 288
// tangents, 8 blocks a matrix took 5.56 ms against one block's 6.04
// (complex128 10.03 against 11.35); at 256 matrices of 48 and 144
// tangents 1.45 against 1.87; bcc-Li's n = 81 (one block an SM) read
// the same at every split, and so does every n above 96.
// Every sum has a fixed order (a tangent's share of l2 in the working
// precision, the per-thread sum over the tangents and the block's sum in
// double; shuffles in a fixed pattern): no atomics, so two runs agree bit
// for bit. A float32 sum over a thread's thousands of terms rounded by up
// to 1.4e-3 Ha/cell of E_L between a sharded and an unsharded run at a
// walker near a node; in double that gap no longer shows. Complex
// products are four real FMAs: plain FP32 (or FP64) FMA, no TF32, no
// split. Shared memory: n x np entries of
// A^-1 and one or two n x (np + 16 / entry bytes) buffers for J_t and M_t,
// np = n rounded up to the tile: complex64 serves n <= 119 (224 KB at 96
// with M_t's own buffer, 225 KB at 119 without), complex128 n <= 84 (227
// KB at 84, the block's limit).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

template <typename R>
struct Cx;
template <>
struct Cx<float> {
  using C = float2;
  static constexpr int kMaxN = 119;  // np = 120: two 120-wide buffers fill a block
  __device__ static float2 make(float x, float y) { return make_float2(x, y); }
  __device__ static float mad(float a, float b, float c) { return __fmaf_rn(a, b, c); }
  // two consecutive entries, 16-byte aligned, as one 128-bit read
  __device__ static void load2(const float2* p, float2& x, float2& y) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x = make_float2(v.x, v.y);
    y = make_float2(v.z, v.w);
  }
};
template <>
struct Cx<double> {
  using C = double2;
  static constexpr int kMaxN = 84;  // two n x 84 buffers of 16-byte entries fill a block
  __device__ static double2 make(double x, double y) { return make_double2(x, y); }
  __device__ static double mad(double a, double b, double c) { return __fma_rn(a, b, c); }
  __device__ static void load2(const double2* p, double2& x, double2& y) {
    x = p[0];
    y = p[1];
  }
};

constexpr int kRows = 4;      // rows of a thread's tile of M_t
constexpr int kWideN = 84;    // above it (complex64 only), 6 columns a thread
constexpr int kStagedN = 96;  // above it (complex64 only), 8 columns, M_t over J_t

// Columns of a thread's tile at n: 4 up to kWideN, 6 up to kStagedN
// (complex64), where 4 x 4 tiles would take more than 448 threads, 8
// above, where 4 x 6 tiles would take more than 512.
__host__ __device__ inline int tile_cols(int n) {
  return n > kStagedN ? 8 : n > kWideN ? 6 : 4;
}

// The tile grid for n x n matrices with TC columns a thread: n rounded up
// to np, a multiple of 4 and of TC; gr x gc threads of 4 x TC entries, in
// whole warps (at most 448 for TC 4, 384 for TC 6, 480 for TC 8).
template <int TC>
struct Grid {
  int np, gr, gc;
  __host__ __device__ explicit Grid(int n) {
    const int unit = TC == 4 ? 4 : TC == 6 ? 12 : 8;
    np = (n + unit - 1) / unit * unit;
    gr = np / kRows;
    gc = np / TC;
  }
  __host__ __device__ int threads() const { return (gr * gc + 31) / 32 * 32; }
};

// Row stride of the J_t / M_t buffer, in entries: even for complex64 so
// that a pair of entries is one aligned 128-bit read, and not a multiple
// of 4 so that the transposed reads spread over the banks.
template <typename R>
__host__ __device__ inline int j_stride(int np) {
  return np + static_cast<int>(16 / sizeof(typename Cx<R>::C));
}

// complex64 up to n = 96 stages M_t in a buffer of its own, so that a
// tangent takes two block barriers where sharing J_t's takes four;
// complex128's three n x np buffers would not fit a block at bcc-Li's n,
// nor complex64's above 96
template <typename R, int TC>
constexpr bool kOwnM = sizeof(R) == 4 && TC != 8;

// The launch bound each kernel is compiled to, which caps its registers:
// complex64 at 4 columns for 576 threads (at most 112 registers; ptxas
// took 96), so that four blocks of C-diamond's n = 48 fit an SM, the
// occupancy its latency needs (bound to 448 it took 109 registers, three
// blocks fit, and a launch took 1.5x as long); at 8 columns for the 480
// threads of n = 119 (one block an SM).
template <typename R, int TC>
constexpr int kBoundThreads = sizeof(R) == 8 ? 448 : TC == 4 ? 576 : TC == 6 ? 384 : 480;

constexpr int kMaxWarps = 16;  // 480 threads at most: one double2 a warp for l2

template <typename R, int TC>
inline size_t smem_bytes(int n) {
  const int np = Grid<TC>(n).np;
  const size_t m_buffer = kOwnM<R, TC> ? static_cast<size_t>(n) * j_stride<R>(np) : 0;
  return sizeof(typename Cx<R>::C) * (static_cast<size_t>(n) * np +
                                      static_cast<size_t>(n) * j_stride<R>(np) + m_buffer) +
         sizeof(double2) * kMaxWarps;
}

template <typename C, typename R>
__device__ __forceinline__ C cmul(C a, C b) {
  return Cx<R>::make(Cx<R>::mad(a.x, b.x, -a.y * b.y), Cx<R>::mad(a.x, b.y, a.y * b.x));
}

template <typename C, typename R>
__device__ __forceinline__ void cfma(C& acc, C a, C b) {
  acc.x = Cx<R>::mad(a.x, b.x, acc.x);
  acc.x = Cx<R>::mad(-a.y, b.y, acc.x);
  acc.y = Cx<R>::mad(a.x, b.y, acc.y);
  acc.y = Cx<R>::mad(a.y, b.x, acc.y);
}

template <typename R, int TC>
__global__ void __launch_bounds__(kBoundThreads<R, TC>)
dethead_trace_kernel(const R* __restrict__ jr, const R* __restrict__ jbc,
                     const typename Cx<R>::C* __restrict__ ep_val,
                     const typename Cx<R>::C* __restrict__ ep_jac3,
                     const typename Cx<R>::C* __restrict__ orb_val0,
                     const typename Cx<R>::C* __restrict__ a_inv,
                     typename Cx<R>::C* __restrict__ trb,
                     typename Cx<R>::C* __restrict__ l2_part, int n, int ndet,
                     int batch, int t_loc, int t_per_block, int offset, int t0) {
  using C = typename Cx<R>::C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Grid<TC> grid(n);
  const int np = grid.np;
  const int ldj = j_stride<R>(np);
  C* as = reinterpret_cast<C*>(smem_raw);  // as[k * np + i] = A^-1[i][k]
  C* js = as + static_cast<size_t>(n) * np;  // J_t[k][j]
  C* ms = kOwnM<R, TC> ? js + static_cast<size_t>(n) * ldj : js;  // M_t[i][j]
  // one l2 a warp, 16-byte aligned (complex64: n np and 2 n ldj entries are even)
  double2* red = reinterpret_cast<double2*>(ms + static_cast<size_t>(n) * ldj);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int matrices = batch * ndet;
  const int m = blockIdx.x;
  const int b = m / ndet, d = m - b * ndet;
  const size_t nn = static_cast<size_t>(n) * n;
  const C zero = Cx<R>::make(R(0), R(0));

  const C* ainv_m = a_inv + m * nn;
  for (int e = tid; e < n * np; e += nthreads) {
    const int k = e / np, i = e - k * np;
    as[e] = i < n ? ainv_m[static_cast<size_t>(i) * n + k] : zero;
  }
  // the padding columns of J_t stay zero; the padding rows of A^-1 are
  // zero, so M_t's padding entries are zero and are never read
  for (int e = tid; e < n * ldj; e += nthreads) js[e] = zero;
  __syncthreads();  // before any thread stores J_t over the zeros

  const bool active = tid < grid.gr * grid.gc;
  const int r = active ? tid / grid.gc : 0, c = active ? tid - r * grid.gc : 0;
  int rows[kRows], cols[TC];
#pragma unroll
  for (int a = 0; a < kRows; ++a) rows[a] = kRows * r + a;
#pragma unroll
  for (int q = 0; q < TC; ++q) cols[q] = 2 * c + (q & 1) + 2 * grid.gc * (q >> 1);

  const int p = ndet * n;
  const size_t row2p = 2 * static_cast<size_t>(p);
  const C* epv = ep_val + m * nn;
  const C* ov0 = orb_val0 + m * nn;
  const int t_begin = blockIdx.y * t_per_block;
  const int t_end = min(t_loc, t_begin + t_per_block);
  // each tangent's share of l2 in R, summed over the tangents and the
  // block in double: a sum of thousands of terms in float32 rounds by
  // more than float32 E_L holds at a walker near a node
  double l2x = 0.0, l2y = 0.0;

  for (int t = t_begin; t < t_end; ++t) {
    const int g = t0 + t;
    const int slab_row = g / 3 - offset;  // the row tangent g moves, if in the channel
    const R* jr_t = jr + (static_cast<size_t>(t) * batch + b) * n * row2p + d * n;
    const R* jbc_t = jbc ? jbc + (static_cast<size_t>(t) * batch + b) * row2p + d * n
                         : nullptr;
    const C* ej3 = ep_jac3 + (static_cast<size_t>(g % 3) * matrices + m) * nn;

    if (!kOwnM<R, TC>) __syncthreads();  // the previous tangent's M_t has been read
    for (int e = tid; e < n * n; e += nthreads) {
      const int i = e / n, k = e - i * n;
      R re = jr_t[i * row2p + k], im = jr_t[i * row2p + p + k];
      if (jbc_t) {
        re += jbc_t[k];
        im += jbc_t[p + k];
      }
      C v = cmul<C, R>(Cx<R>::make(re, im), epv[e]);
      if (i == slab_row) {
        const C u = cmul<C, R>(ov0[e], ej3[e]);
        v.x += u.x;
        v.y += u.y;
      }
      js[i * ldj + k] = v;
    }
    __syncthreads();

    C acc[kRows][TC];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int q = 0; q < TC; ++q) acc[a][q] = zero;
    if (active) {
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        C av[kRows], bv[TC];
        const C* arow = as + k * np + kRows * r;
        Cx<R>::load2(arow, av[0], av[1]);
        Cx<R>::load2(arow + 2, av[2], av[3]);
        const C* brow = js + k * ldj + 2 * c;
#pragma unroll
        for (int q = 0; q < TC; q += 2) Cx<R>::load2(brow + grid.gc * q, bv[q], bv[q + 1]);
#pragma unroll
        for (int a = 0; a < kRows; ++a)
#pragma unroll
          for (int q = 0; q < TC; ++q) cfma<C, R>(acc[a][q], av[a], bv[q]);
      }
    }
    if (!kOwnM<R, TC>) __syncthreads();  // every thread is done with J_t

    if (active) {
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int q = 0; q < TC; ++q)
          if (rows[a] < n && cols[q] < n) ms[rows[a] * ldj + cols[q]] = acc[a][q];
    }
    // M_t is whole; with its own buffer, also every read of J_t is done
    __syncthreads();
    if (active) {
      C part = zero;
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int q = 0; q < TC; ++q)
          if (rows[a] < n && cols[q] < n)
            cfma<C, R>(part, acc[a][q], ms[cols[q] * ldj + rows[a]]);
      l2x += part.x;
      l2y += part.y;
    }
    if (warp == 0) {
      C s = zero;
      for (int i = lane; i < n; i += 32) {
        const C v = ms[i * ldj + i];
        s.x += v.x;
        s.y += v.y;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s.x += __shfl_down_sync(0xffffffffu, s.x, off);
        s.y += __shfl_down_sync(0xffffffffu, s.y, off);
      }
      if (lane == 0) trb[static_cast<size_t>(t) * matrices + m] = s;
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    l2x += __shfl_down_sync(0xffffffffu, l2x, off);
    l2y += __shfl_down_sync(0xffffffffu, l2y, off);
  }
  if (lane == 0) red[warp] = make_double2(l2x, l2y);
  __syncthreads();
  if (tid == 0) {
    double sx = 0.0, sy = 0.0;
    for (int w = 0; w < nthreads / 32; ++w) {
      sx += red[w].x;
      sy += red[w].y;
    }
    l2_part[static_cast<size_t>(blockIdx.y) * matrices + m] = Cx<R>::make(R(sx), R(sy));
  }
}

// Opts the kernel into the shared memory n needs, on the current device:
// every launch sets it, as a static cache would miss another card.
template <typename R, int TC>
cudaError_t reserve(int n) {
  const size_t smem = smem_bytes<R, TC>(n);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(dethead_trace_kernel<R, TC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename R>
bool serves(int n) {
  return n >= 1 && n <= Cx<R>::kMaxN;
}

template <typename R, int TC>
int launch_tc(const void* jr, const void* jbc, const void* ep_val, const void* ep_jac3,
              const void* orb_val0, const void* a_inv, void* trb, void* l2_part, int n,
              int ndet, int batch, int t_loc, int splits, int offset, int t0,
              cudaStream_t st) {
  using C = typename Cx<R>::C;
  const cudaError_t err = reserve<R, TC>(n);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per = (t_loc + splits - 1) / splits;
  const dim3 grid(batch * ndet, splits);
  dethead_trace_kernel<R, TC><<<grid, Grid<TC>(n).threads(), smem_bytes<R, TC>(n), st>>>(
      static_cast<const R*>(jr), static_cast<const R*>(jbc),
      static_cast<const C*>(ep_val), static_cast<const C*>(ep_jac3),
      static_cast<const C*>(orb_val0), static_cast<const C*>(a_inv),
      static_cast<C*>(trb), static_cast<C*>(l2_part), n, ndet, batch, t_loc, per,
      offset, t0);
  return static_cast<int>(cudaGetLastError());
}

template <typename R>
int launch(const void* jr, const void* jbc, const void* ep_val, const void* ep_jac3,
           const void* orb_val0, const void* a_inv, void* trb, void* l2_part, int n,
           int ndet, int batch, int t_loc, int splits, int offset, int t0,
           cudaStream_t st) {
  if (!serves<R>(n) || splits < 1 || splits > 65535 || t_loc < 1 || batch < 1 ||
      ndet < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (sizeof(R) == 4) {
    if (tile_cols(n) == 8) {
      return launch_tc<R, 8>(jr, jbc, ep_val, ep_jac3, orb_val0, a_inv, trb, l2_part, n,
                             ndet, batch, t_loc, splits, offset, t0, st);
    }
    if (tile_cols(n) == 6) {
      return launch_tc<R, 6>(jr, jbc, ep_val, ep_jac3, orb_val0, a_inv, trb, l2_part, n,
                             ndet, batch, t_loc, splits, offset, t0, st);
    }
  }
  return launch_tc<R, 4>(jr, jbc, ep_val, ep_jac3, orb_val0, a_inv, trb, l2_part, n, ndet,
                         batch, t_loc, splits, offset, t0, st);
}

}  // namespace

extern "C" {

// Largest n each scalar serves: 119 complex64, 84 complex128.
int dethead_max_n(int is_double) {
  return is_double ? Cx<double>::kMaxN : Cx<float>::kMaxN;
}

// Columns of a thread's tile of M_t, which names the instantiation that
// launches for n (4, 6 or 8); 0 where the scalar does not serve n.
int dethead_tile_cols(int n, int is_double) {
  if (is_double) return serves<double>(n) ? 4 : 0;
  return serves<float>(n) ? tile_cols(n) : 0;
}

// jr: (t_loc, batch, n, 2 ndet n) float; jbc: (t_loc, batch, 2 ndet n) or
// null; ep_val, orb_val0, a_inv: (batch, ndet, n, n) complex64; ep_jac3:
// (3, batch, ndet, n, n); trb: (t_loc, batch, ndet); l2_part: (splits,
// batch, ndet). Returns the cudaError_t of the launch.
int dethead_trace_launch(const void* jr, const void* jbc, const void* ep_val,
                         const void* ep_jac3, const void* orb_val0, const void* a_inv,
                         void* trb, void* l2_part, int n, int ndet, int batch,
                         int t_loc, int splits, int offset, int t0, void* stream) {
  return launch<float>(jr, jbc, ep_val, ep_jac3, orb_val0, a_inv, trb, l2_part, n,
                       ndet, batch, t_loc, splits, offset, t0,
                       static_cast<cudaStream_t>(stream));
}

// The same in double: jr, jbc float64; the rest complex128.
int dethead_trace_launch_c128(const void* jr, const void* jbc, const void* ep_val,
                              const void* ep_jac3, const void* orb_val0,
                              const void* a_inv, void* trb, void* l2_part, int n,
                              int ndet, int batch, int t_loc, int splits, int offset,
                              int t0, void* stream) {
  return launch<double>(jr, jbc, ep_val, ep_jac3, orb_val0, a_inv, trb, l2_part, n,
                        ndet, batch, t_loc, splits, offset, t0,
                        static_cast<cudaStream_t>(stream));
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
