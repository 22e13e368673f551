// The determinant head's tangent stream for Hopper (sm_90a): one template
// on the scalar and the tile on the FMA pipes (complex64; complex128 up to
// n = 40), and complex128 above on the FP64 tensor cores
// (dethead_trace_kernel_dmma, below).
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
// Complex64. One block a matrix (and a slice of its tangents), a loop over
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
// above 96 it stages it over J_t (three buffers would not fit a block: at
// n = 112 two take 202 KB) and takes four, as complex128 does.
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
// (the FMA body complex128 had before its tensor-core one: 10.03 against
// 11.35); at 256 matrices of 48 and 144
// tangents 1.45 against 1.87; bcc-Li's n = 81 (one block an SM) read
// the same at every split, and so does every n above 96.
// Every sum has a fixed order (a tangent's share of l2 in the working
// precision, the per-thread sum over the tangents and the block's sum in
// double; shuffles in a fixed pattern): no atomics, so two runs agree bit
// for bit. A float32 sum over a thread's thousands of terms rounded by up
// to 1.4e-3 Ha/cell of E_L between a sharded and an unsharded run at a
// walker near a node; in double that gap no longer shows. Complex
// products are four real FMAs: plain FP32 (or FP64) FMA, no TF32, no
// split. Shared memory: n x np entries of A^-1 and one or two n x (np +
// 16 / entry bytes) buffers for J_t and M_t, np = n rounded up to the
// tile: complex64 serves n <= 119 (224 KB at 96 with M_t's own buffer, 225
// KB at 119 without).

#include <cuda.h>
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

bool bad_launch(int n, int max_n, int splits, int t_loc, int batch, int ndet) {
  return n < 1 || n > max_n || splits < 1 || splits > 65535 || t_loc < 1 || batch < 1 ||
         ndet < 1;
}

int launch_c64(const void* jr, const void* jbc, const void* ep_val, const void* ep_jac3,
               const void* orb_val0, const void* a_inv, void* trb, void* l2_part, int n,
               int ndet, int batch, int t_loc, int splits, int offset, int t0,
               cudaStream_t st) {
  if (bad_launch(n, Cx<float>::kMaxN, splits, t_loc, batch, ndet)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tile_cols(n) == 8) {
    return launch_tc<float, 8>(jr, jbc, ep_val, ep_jac3, orb_val0, a_inv, trb, l2_part, n,
                               ndet, batch, t_loc, splits, offset, t0, st);
  }
  if (tile_cols(n) == 6) {
    return launch_tc<float, 6>(jr, jbc, ep_val, ep_jac3, orb_val0, a_inv, trb, l2_part, n,
                               ndet, batch, t_loc, splits, offset, t0, st);
  }
  return launch_tc<float, 4>(jr, jbc, ep_val, ep_jac3, orb_val0, a_inv, trb, l2_part, n, ndet,
                             batch, t_loc, splits, offset, t0, st);
}

// ---- complex128: M_t = A^-1 J_t on the FP64 tensor cores
//
// The same function in double, computed as real products on the FP64
// tensor cores (mma.sync m16n8k4 .f64: IEEE double, as the FMA it
// replaced; wgmma has no f64 form), where fma_faster says no (46-49,
// 58-84: C-diamond's 48, bcc-Li's 81). 8 n^3 flops a matrix
// and tangent, at the card's 67 TFLOP/s FP64 tensor rate where plain FP64
// FMA peaks at 34: the FMA body above took 10.0 ms at C-diamond's (512,
// 48, 288) and 19.8 ms at bcc-Li's (128, 81, 486), 19.6% of the
// tensor-rate bound; this body 8.85 and 16.7 (H100, 700 W). Where the
// blocks pad n far (16 nb / n) and few warps fit an SM, the FMA body stays.
//
// The complex product. [Re M; Im M] = [[Re A^-1, -Im A^-1], [Im A^-1,
// Re A^-1]] [Re J_t; Im J_t]: per 16 x 8 tile and k-step four m16n8k4
// products, Re += Ar Jr, Re += (-Ai) Ji, Im += Ai Jr, Im += Ar Ji, the sign
// flipped on the A fragment in registers as it is loaded from the n x n
// complex A^-1 (the 2n x 2n real embedding would not fit a block at 81);
// an accumulator's two products are four products apart.
//
// Who holds what. M_t is cut into 16 x 16 blocks (nb = ceil(n / 16) a
// side), each two 16 x 8 accumulator tiles in a warp's registers. For l2
// = sum M_ik M_ki each entry meets its transposed partner without staging
// M_t (at n = 81 a staged M_t, 105 KB, does not fit beside A^-1's 109 KB
// and the rings): an off-diagonal pair P < Q takes two slots of one warp,
// block (P, Q) as A^-1 J_t and block (Q, P) transposed, as J_t^T A^-T
// (left operand J_t's columns of block P, right operand A^-1's rows of
// block Q), so that both land on the same lanes at the same places and
// the pair's share of l2 is 2 sum D[e] T[e] over a lane's own registers;
// a diagonal block takes one slot and finds its partners by shuffles. A
// host plan packs the blocks: two slots a warp up to n = 64 (n = 48: 5
// warps, two blocks an SM), five above in 8 warps (n = 81: 61 tiles, 6-8
// a warp, two warps on each SM sub-partition; 256 threads, so that ptxas
// may give 255 registers, 160 of them accumulators: at 9 warps or more it
// caps at 168 and the accumulators spilled).
//
// Streaming J_t. kDK = 8 rows of J_t a slab, across tangents. The copy
// engine brings a slab's rows of jr (two 2D boxes, real and imaginary
// parts, through a tensor map: one row copy each cost ~50 cycles of the
// copy engine a copy, and 19 a slab made it the bottleneck), of ep_val and
// the tangent's jbc into one of three raw stages; every warp forms its
// entries of J_t (row-constant add, envelope-phase product, slab row)
// into one of three ring stages, then runs its products of an earlier
// slab. No block barrier in the loop: mbarriers say when a raw stage has
// landed, when every warp formed a ring stage (full) and when every warp's
// products read it (empty), so warps drift up to two slabs apart; the last
// warp to form from a raw stage issues its next copies, three slabs ahead.
// The trace: a shuffle sum a warp into a shared slot by tangent, closed
// by one thread once every warp's products of the tangent are done.
// What the card showed: at n = 81 a slab's products take ~3.6k cycles a
// warp (the tensor pipe ~1.95k at its peak), its forming ~1.5k and the
// waits for the slowest warp ~1k; forming is latency-bound (loading one
// entry a thread before forming it beat three), and neither a deeper
// ring, warps ordered in ping-pong, nor waiting on lane 0 helped;
// m16n8k8 took more registers (one block an SM at 48, spills at 81) and
// was slower.
//
// Layout. A^-1 row-major with a stride of 4 mod 8 entries, the ring with
// 2 mod 8 (16-byte reads by eight lanes of distinct banks for both
// operands' fragments); rows of A^-1 past n are read as row n - 1 (their
// products only ever meet J_t's zero columns past n, so no 16-row padding
// is stored), columns past n of A^-1 and rows past n of J_t are zero. A
// box starts on a 16-byte column (for odd d n one column early) and is n
// + 1 wide, rounded up to even; raw regions are 128-byte aligned. Shared
// memory: 220,800 bytes at n = 84, 214,144 at 81, 100,224 at 48.
//
// Sums. Each mma adds its four k in the tensor core's order, k-steps in
// order; a lane's l2 terms in double in a fixed order, the per-lane sum
// over the tangents, warp shuffles and the block's sum over the warps in
// a fixed order: no atomic sums, so two runs agree bit for bit (one
// shared counter only picks the warp that issues the next copies).

constexpr int kDK = 8;         // rows of J_t a stage holds: two k-steps
constexpr int kRing = 3;       // stages of formed J_t rows
constexpr int kRaw = 3;        // stages of raw rows in flight
constexpr int kTraces = 4;     // tangents whose traces the warps may hold at once
constexpr int kBarriers = 2 * kRing + 2 * kRaw;
constexpr int kDMaxN = 84;

// Whether complex128 takes the FMA body (the template above, 4 x 4 tiles)
// at n: where the card timed it faster, in turns at 512 matrices and 6 n
// tangents (ms FMA / tensor cores): 40 4.83 / -, 44 7.33 / 7.79, 48 10.02
// / 8.90, 52 14.07 / 17.74, 56 17.75 / 19.70, 60 27.78 / 23.46, 64 28.80
// / 25.65 (between readings: 45 with 44, 46-49 with 48, 50-57 with 52 and
// 56, 58-59 with 60). From 49 to 56 the blocks pad n to 64, and one block
// of 8 warps fits an SM.
__host__ __device__ inline bool fma_faster(int n) { return n <= 45 || (n >= 50 && n <= 57); }
constexpr int kDMaxBlocks = (kDMaxN + 15) / 16;
constexpr int kDMaxWarps = 8;  // 256 threads: ptxas then allows 255 registers a thread
constexpr int kDSmallBlocks = 4;  // up to 4 blocks a side (n <= 64) two slots a warp, five above

// A warp's slot: one 16 x 16 block of M_t in registers.
enum : unsigned char { kNone, kDirect, kTransposed, kDiagonal };
struct DSlot {
  unsigned char kind;  // kDirect: block (p, q), p < q, of A^-1 J_t; its partner, block
  unsigned char p, q;  // (q, p) transposed (J_t^T A^-T), sits in the next slot; kDiagonal: (p, p)
};
struct DPlan {
  DSlot slot[kDMaxWarps][5];
  int warps;
};

// The complex128 body's cut of n x n matrices.
struct DLayout {
  int nb;     // 16 x 16 blocks of M_t a side
  int kp;     // n rounded up to the k-step, 4
  int lda;    // row stride of A^-1 in shared memory: >= kp, 4 mod 8 entries
  int ldj;    // row stride of the ring: 16 nb + 2 entries, 2 mod 8
  int slabs;  // stages of the ring a tangent takes
  int spw;    // slots a warp
  int rl;     // doubles a row of jr's box and a run of jbc take: n + 1, even
  int box;    // bytes of a box of kDK rows of jr's real (or imaginary) parts
  int ebytes; // bytes of kDK rows of ep_val
  int stage;  // bytes of a raw stage: the two boxes, ep_val's rows, jbc's two
              // runs, each 128-byte aligned
  int raw;    // offset of the raw stages in shared memory
  __host__ __device__ explicit DLayout(int n) {
    nb = (n + 15) / 16;
    kp = (n + 3) / 4 * 4;
    lda = kp % 8 == 4 ? kp : kp + 4;
    ldj = 16 * nb + 2;
    slabs = (kp + kDK - 1) / kDK;
    spw = nb <= kDSmallBlocks ? 2 : 5;
    rl = (n + 2) / 2 * 2;
    box = align128(kDK * rl * 8);
    ebytes = align128(kDK * n * 16);
    stage = 2 * box + ebytes + align128(2 * rl * 8);
    raw = align128(16 * (n * lda + kRing * kDK * ldj + (kTraces + 1) * kDMaxWarps) +
                   8 * kBarriers + 4 * kRaw);
  }
  __host__ __device__ static int align128(int bytes) { return (bytes + 127) / 128 * 128; }
};

inline size_t dmma_smem_bytes(int n) {
  const DLayout lay(n);
  return static_cast<size_t>(lay.raw) + kRaw * static_cast<size_t>(lay.stage);
}

// The blocks to the warps, as even as the slots allow: the off-diagonal
// pairs (P, Q), P < Q, each two slots of one warp, and the diagonal
// blocks, one slot each, heaviest first (in 16 x 8 tiles: a block whose
// columns start past n - 8 has one), each to the least loaded warp with
// room. Two slots a warp up to n = 64 (a pair a warp, the diagonal blocks
// two a warp), five above in 8 warps (n = 81: 15 pairs and 6 diagonal
// blocks, 61 tiles, 6-8 a warp, two warps on each of the four SM
// sub-partitions, each with its own tensor core).
DPlan plan(int n) {
  const DLayout lay(n);
  const int pairs = lay.nb * (lay.nb - 1) / 2;
  const int units = pairs + lay.nb;
  int weight[kDMaxBlocks * (kDMaxBlocks + 1) / 2], order[kDMaxBlocks * (kDMaxBlocks + 1) / 2];
  unsigned char up[kDMaxBlocks * (kDMaxBlocks + 1) / 2], uq[kDMaxBlocks * (kDMaxBlocks + 1) / 2];
  int u = 0;
  for (int pp = 0; pp < lay.nb; ++pp)
    for (int qq = pp; qq < lay.nb; ++qq, ++u) {
      const int tiles = 16 * qq + 8 < n ? 2 : 1;
      weight[u] = qq > pp ? 2 * tiles : tiles;
      up[u] = static_cast<unsigned char>(pp);
      uq[u] = static_cast<unsigned char>(qq);
      order[u] = u;
    }
  for (int i = 1; i < units; ++i)  // heaviest first, pairs before a diagonal block of equal weight
    for (int j = i; j > 0; --j) {
      const int x = order[j], y = order[j - 1];
      const bool before = weight[x] > weight[y] ||
                          (weight[x] == weight[y] && up[x] != uq[x] && up[y] == uq[y]);
      if (!before) break;
      order[j] = y;
      order[j - 1] = x;
    }
  DPlan out;
  out.warps = lay.spw == 2 ? pairs + (lay.nb + 1) / 2 : kDMaxWarps;
  int load[kDMaxWarps], used[kDMaxWarps];
  for (int w = 0; w < kDMaxWarps; ++w) {
    load[w] = used[w] = 0;
    for (int k = 0; k < 5; ++k) out.slot[w][k] = DSlot{kNone, 0, 0};
  }
  for (int i = 0; i < units; ++i) {
    const int x = order[i];
    const int need = up[x] != uq[x] ? 2 : 1;
    int best = -1;
    for (int w = 0; w < out.warps; ++w)
      if (used[w] + need <= lay.spw && (best < 0 || load[w] < load[best])) best = w;
    if (best < 0) {  // no room: cannot happen for n <= kDMaxN
      out.warps = 0;
      return out;
    }
    if (need == 2) {
      out.slot[best][used[best]] = DSlot{kDirect, up[x], uq[x]};
      out.slot[best][used[best] + 1] = DSlot{kTransposed, up[x], uq[x]};
    } else {
      out.slot[best][used[best]] = DSlot{kDiagonal, up[x], uq[x]};
    }
    used[best] += need;
    load[best] += weight[x];
  }
  return out;
}

// ---- PTX: the complex128 body's tensor-core product, bulk and tensor
// copies and barriers, and the host's tensor description for the copies
// (tests/test_torch_dethead_emulation.py stands in for this block with
// plain C++ on the CPU)

// D += A B, one warp: mma.sync m16n8k4 .f64 in the PTX ISA's fragments
// (g = lane / 4, t = lane % 4; row.col): a_i = A[g + 8 i][t]; b = B[t][g];
// c_i = D[g + 8 (i / 2)][2 t + i % 2] (time_dmma.py checked them on an H100).
__device__ __forceinline__ void dmma_m16n8k4(double (&c)[4], double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// a barrier whose phase completes once it has `count` arrivals and the
// bytes they announced have landed
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_address(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive on `bar`, announcing `bytes` of bulk copies to come
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_address(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from device memory
// to shared memory by the copy engine, landing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_address(dst)),
      "l"(src), "r"(bytes), "r"(smem_address(bar))
      : "memory");
}

// one arrival on `bar`
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_address(bar)) : "memory");
}

// shared memory that generic loads read, handed to the copy engine
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// kDK rows from row c1 of the 2D tensor `map` describes, its columns c0 to
// c0 + box - 1 (zeros past its edge), by the copy engine, landing on `bar`
__device__ __forceinline__ void tensor_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                               unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(smem_address(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1), "r"(smem_address(bar))
      : "memory");
}

// The host's description of a row-major (rows, cols) float64 tensor for
// the copy engine, in boxes of box_rows x box_cols (box_cols even), by
// cuTensorMapEncodeTiled, found through the runtime. False where it fails.
inline bool rows_map(CUtensorMap* map, const double* base, unsigned long long cols,
                     unsigned long long rows, unsigned box_cols, unsigned box_rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
          cudaSuccess ||
      found != cudaDriverEntryPointSuccess || fn == nullptr) {
    return false;
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(double)};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return reinterpret_cast<Encode>(fn)(
             map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 2, const_cast<double*>(base), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_address(bar)),
      "r"(parity)
      : "memory");
}

// ---- end of PTX

__device__ __forceinline__ double2 cmul_d(double2 a, double2 b) {
  return make_double2(__fma_rn(a.x, b.x, -a.y * b.y), __fma_rn(a.x, b.y, a.y * b.x));
}

// A run of n doubles at x, widened to 16-byte boundaries: its first double
// (x - (x's parity)) and bytes.
__device__ __forceinline__ const double* run_start(const double* x) {
  return x - ((reinterpret_cast<size_t>(x) >> 3) & 1);
}
__device__ __forceinline__ unsigned run_bytes(const double* x, int n) {
  const size_t a = reinterpret_cast<size_t>(x) >> 3;
  return static_cast<unsigned>(8 * (((a + n + 1) & ~size_t{1}) - (a & ~size_t{1})));
}

template <int SPW>
__global__ void __launch_bounds__(32 * kDMaxWarps, 1)
dethead_trace_kernel_dmma(const double* __restrict__ jbc,
                          const double2* __restrict__ ep_val,
                          const double2* __restrict__ ep_jac3,
                          const double2* __restrict__ orb_val0,
                          const double2* __restrict__ a_inv, double2* __restrict__ trb,
                          double2* __restrict__ l2_part, int n, int ndet, int batch,
                          int t_loc, int t_per_block, int offset, int t0, DPlan plan,
                          const __grid_constant__ CUtensorMap jr_map) {
  extern __shared__ __align__(128) unsigned char dmma_smem[];
  const DLayout lay(n);
  const int lda = lay.lda, ldj = lay.ldj, slabs = lay.slabs, rl = lay.rl;
  double2* as = reinterpret_cast<double2*>(dmma_smem);  // as[i * lda + k] = A^-1[i][k]
  double2* js = as + static_cast<size_t>(n) * lda;     // ring: js[(stage kDK + r) ldj + j]
  double2* trs = js + kRing * kDK * ldj;               // warps' traces by tangent
  double2* red = trs + kTraces * kDMaxWarps;           // one l2 a warp
  // raw stages: jr's real and imaginary boxes (kDK x rl), ep_val's rows,
  // jbc's two runs
  unsigned char* raw = dmma_smem + lay.raw;
  // a ring stage is full once every warp formed its rows, empty once every
  // warp's products read it; a raw stage full once its bytes landed, empty
  // once every warp formed from it (one arrival a warp, after its lanes'
  // loads and stores: a warp barrier, then lane 0)
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(red + kDMaxWarps);
  unsigned long long *jfull = bars, *jempty = bars + kRing;
  unsigned long long *rfull = bars + 2 * kRing, *rempty = rfull + kRaw;
  int* formed = reinterpret_cast<int*>(bars + kBarriers);  // warps done with a raw stage

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int matrices = batch * ndet;
  const int m = blockIdx.x;
  const int b = m / ndet, d = m - b * ndet;
  const size_t nn = static_cast<size_t>(n) * n;
  const int p = ndet * n;
  const size_t row2p = 2 * static_cast<size_t>(p);
  const double2 zero = make_double2(0.0, 0.0);
  const auto parity = [](const double* x) {
    return static_cast<int>((reinterpret_cast<size_t>(x) >> 3) & 1);
  };

  if (tid == 0) {
    for (int k = 0; k < kRing; ++k) {
      mbar_init(jfull + k, nwarps);
      mbar_init(jempty + k, nwarps);
    }
    for (int k = 0; k < kRaw; ++k) {
      mbar_init(rfull + k, 1);
      mbar_init(rempty + k, nwarps);
      formed[k] = 0;
    }
  }
  const double2* ainv_m = a_inv + m * nn;
  for (int e = tid; e < n * lda; e += blockDim.x) {
    const int i = e / lda, k = e - i * lda;
    as[e] = k < n ? ainv_m[static_cast<size_t>(i) * n + k] : zero;
  }
  // the ring's columns past n stay zero
  for (int e = tid; e < kRing * kDK * ldj; e += blockDim.x) js[e] = zero;

  const int t_begin = blockIdx.y * t_per_block;
  const int t_end = min(t_loc, t_begin + t_per_block);
  const int total = max(0, t_end - t_begin) * slabs;  // slabs of this block, all tangents

  const int par_re = (d * n) & 1, par_im = (p + d * n) & 1;  // jr's base is 16-byte aligned
  const int bpar_re = jbc ? parity(jbc + d * n) : 0, bpar_im = jbc ? parity(jbc + d * n + p) : 0;
  // one thread (thread 0 for the first kRaw slabs, then lane 0 of the last
  // warp to form slab x - kRaw): slab x's rows of jr (two boxes, real and
  // imaginary parts, kDK rows from the copy engine, each starting on a
  // 16-byte column: an odd first column one earlier; rows past the matrix
  // are never read), of ep_val and its tangent's jbc (each run widened to
  // 16 bytes) into raw stage x % kRaw
  auto fetch = [&](int x) {
    if (x >= total) return;
    unsigned long long* bar = rfull + x % kRaw;
    if (x >= kRaw) mbar_wait(rempty + x % kRaw, ((x / kRaw) & 1) ^ 1);  // every warp's reads
    const int t = t_begin + x / slabs, k0 = (x % slabs) * kDK;
    const int rows = min(kDK, n - k0);
    unsigned char* st = raw + (x % kRaw) * lay.stage;
    const double* bsrc = jbc ? jbc + (static_cast<size_t>(t) * batch + b) * row2p + d * n
                             : nullptr;
    const unsigned e_bytes = rows * n * static_cast<unsigned>(sizeof(double2));
    unsigned bytes = 2 * kDK * rl * static_cast<unsigned>(sizeof(double)) + e_bytes;
    if (bsrc) bytes += run_bytes(bsrc, n) + run_bytes(bsrc + p, n);
    fence_async_shared();
    mbar_expect(bar, bytes);
    const int row0 = (t * batch + b) * n + k0;
    tensor_load_2d(st, &jr_map, d * n - par_re, row0, bar);
    tensor_load_2d(st + lay.box, &jr_map, p + d * n - par_im, row0, bar);
    bulk_load(st + 2 * lay.box, ep_val + m * nn + static_cast<size_t>(k0) * n, e_bytes, bar);
    if (bsrc) {
      double* brow = reinterpret_cast<double*>(st + 2 * lay.box + lay.ebytes);
      bulk_load(brow, run_start(bsrc), run_bytes(bsrc, n), bar);
      bulk_load(brow + rl, run_start(bsrc + p), run_bytes(bsrc + p, n), bar);
    }
  };

  // every thread: its entries of slab x of J_t, from raw stage x % kRaw
  // into ring stage x % kRing, once the raw rows landed and every warp's
  // products of slab x - kRing are done; the last warp to finish hands the
  // raw stage to slab x + kRaw
  auto form = [&](int x) {
    if (x >= total) return;
    __syncwarp();
    if (x >= kRing) mbar_wait(jempty + x % kRing, ((x / kRing) & 1) ^ 1);
    mbar_wait(rfull + x % kRaw, (x / kRaw) & 1);
    const int t = t_begin + x / slabs, k0 = (x % slabs) * kDK;
    const int gt = t0 + t;
    const int slab_row = gt / 3 - offset;  // the row tangent gt moves, if in the channel
    const int entries = min(kDK, lay.kp - k0) * n;
    const unsigned char* st = raw + (x % kRaw) * lay.stage;
    const double* bre = reinterpret_cast<const double*>(st);
    const double* bim = reinterpret_cast<const double*>(st + lay.box);
    const double2* est = reinterpret_cast<const double2*>(st + 2 * lay.box);
    const double* brow = reinterpret_cast<const double*>(st + 2 * lay.box + lay.ebytes);
    double2* dst = js + (x % kRing) * kDK * ldj;
    for (int e = tid; e < entries; e += blockDim.x) {
      const int r = e / n, j = e - r * n, k = k0 + r;
      double2 v = zero;  // rows past n: zero
      if (k < n) {
        double re = bre[r * rl + par_re + j], im = bim[r * rl + par_im + j];
        if (jbc) {
          re += brow[bpar_re + j];
          im += brow[rl + bpar_im + j];
        }
        v = cmul_d(make_double2(re, im), est[r * n + j]);
        if (k == slab_row) {
          const size_t at = m * nn + static_cast<size_t>(k) * n + j;
          const double2 w =
              cmul_d(orb_val0[at], ep_jac3[static_cast<size_t>(gt % 3) * matrices * nn + at]);
          v.x += w.x;
          v.y += w.y;
        }
      }
      dst[r * ldj + j] = v;
    }
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(jfull + x % kRing);
      mbar_arrive(rempty + x % kRaw);
      if (atomicAdd(formed + x % kRaw, 1) == nwarps - 1) {
        formed[x % kRaw] = 0;
        fetch(x + kRaw);
      }
    }
  };

  // The warp's slots, read from the plan where used (registers go to the
  // accumulators). Per slot the left operand's 16 rows (offsets of a_0,
  // a_1: A^-1's rows, or J_t's columns of a transposed block) and the right
  // operand's two groups of 8 columns (b of each 16 x 8 tile: J_t's
  // columns, or A^-1's rows); A^-1's rows past n read as row n - 1 (their
  // products only meet J_t's zero columns past n).
  const DSlot* slots = plan.slot[warp];
  auto left = [&](const DSlot& slot, int i) {
    const int row = 16 * slot.p + g + 8 * i;
    return slot.kind == kTransposed ? tq * ldj + row : min(row, n - 1) * lda + tq;
  };
  auto right = [&](const DSlot& slot, int c) {
    const int col = 16 * slot.q + 8 * c + g;
    return slot.kind == kTransposed ? min(col, n - 1) * lda + tq : tq * ldj + col;
  };

  double re[SPW][2][4], im[SPW][2][4];  // [slot][16 x 8 tile][fragment]
  auto clear = [&]() {
#pragma unroll
    for (int sl = 0; sl < SPW; ++sl)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) re[sl][c][i] = im[sl][c][i] = 0.0;
  };

  // slab x's k-steps on ring stage x % kRing, once every warp formed it
  auto product = [&](int x) {
    __syncwarp();
    mbar_wait(jfull + x % kRing, (x / kRing) & 1);
    const int k0 = (x % slabs) * kDK;
    const int steps = min(kDK, lay.kp - k0) / 4;
    const double2* ring = js + (x % kRing) * kDK * ldj;
#pragma unroll
    for (int kk = 0; kk < kDK / 4; ++kk) {
      if (kk >= steps) break;
      const double2* ab = as + k0 + 4 * kk;
      const double2* jb = ring + 4 * kk * ldj;
#pragma unroll
      for (int sl = 0; sl < SPW; ++sl) {
        const DSlot slot = slots[sl];
        if (slot.kind == kNone) continue;
        const bool tr = slot.kind == kTransposed;
        const double2* lb = tr ? jb : ab;
        const double2* rb = tr ? ab : jb;
        const double2 l0 = lb[left(slot, 0)], l1 = lb[left(slot, 1)];
        const bool wide = 16 * slot.q + 8 < n;  // the second tile is not past n
        const double2 r0 = rb[right(slot, 0)], r1 = wide ? rb[right(slot, 1)] : zero;
        // four independent accumulators between an accumulator's two products
        dmma_m16n8k4(re[sl][0], l0.x, l1.x, r0.x);
        dmma_m16n8k4(im[sl][0], l0.y, l1.y, r0.x);
        if (wide) {
          dmma_m16n8k4(re[sl][1], l0.x, l1.x, r1.x);
          dmma_m16n8k4(im[sl][1], l0.y, l1.y, r1.x);
        }
        dmma_m16n8k4(re[sl][0], -l0.y, -l1.y, r0.y);
        dmma_m16n8k4(im[sl][0], l0.x, l1.x, r0.y);
        if (wide) {
          dmma_m16n8k4(re[sl][1], -l0.y, -l1.y, r1.y);
          dmma_m16n8k4(im[sl][1], l0.x, l1.x, r1.y);
        }
      }
    }
  };

  // a whole M_t's l2 terms and trace (the diagonal blocks')
  double l2x = 0.0, l2y = 0.0;
  auto close = [&](int t) {
    double sx = 0.0, sy = 0.0;
#pragma unroll
    for (int sl = 0; sl < SPW; ++sl) {
      const unsigned char kind = slots[sl].kind;
      if (sl + 1 < SPW && kind == kDirect) {  // its transposed partner in slot sl + 1
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const double dr = re[sl][c][i], di = im[sl][c][i];
            const double tr = re[sl + 1][c][i], ti = im[sl + 1][c][i];
            l2x += 2.0 * (dr * tr - di * ti);
            l2y += 2.0 * (dr * ti + di * tr);
          }
      }
      if (kind != kDiagonal) continue;
      // entry (h, c, e) of a diagonal block: row 8 h + g, column 8 c + 2 tq
      // + e (fragment i = 2 h + e of tile c); its partner, row 8 c + 2 tq +
      // e and column 8 h + g, is fragment 2 c + (g & 1) of tile h on lane
      // 4 (2 tq + e) + g / 2
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int src = 4 * (2 * tq + e) + (g >> 1);
            const double r0 = __shfl_sync(0xffffffffu, re[sl][h][2 * c], src);
            const double r1 = __shfl_sync(0xffffffffu, re[sl][h][2 * c + 1], src);
            const double i0 = __shfl_sync(0xffffffffu, im[sl][h][2 * c], src);
            const double i1 = __shfl_sync(0xffffffffu, im[sl][h][2 * c + 1], src);
            const double pr = (g & 1) ? r1 : r0, pi = (g & 1) ? i1 : i0;
            const double mr = re[sl][c][2 * h + e], mi = im[sl][c][2 * h + e];
            l2x += mr * pr - mi * pi;
            l2y += mr * pi + mi * pr;
            if (h == c && g == 2 * tq + e) {
              sx += mr;
              sy += mi;
            }
          }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sx += __shfl_down_sync(0xffffffffu, sx, off);
      sy += __shfl_down_sync(0xffffffffu, sy, off);
    }
    if (lane == 0) trs[(t % kTraces) * kDMaxWarps + warp] = make_double2(sx, sy);
  };

  // thread 0: the warps' traces of tangent t, in warp order, once every
  // warp closed it
  int traced = t_begin;  // tangents before it have their trace written
  auto write_trace = [&](int t) {
    double sx = 0.0, sy = 0.0;
    for (int w = 0; w < nwarps; ++w) {
      sx += trs[(t % kTraces) * kDMaxWarps + w].x;
      sy += trs[(t % kTraces) * kDMaxWarps + w].y;
    }
    trb[static_cast<size_t>(t) * matrices + m] = make_double2(sx, sy);
    traced = t + 1;
  };

  __syncthreads();  // the barriers initialized, A^-1 and the zeroed ring stored
  if (tid == 0) {
    for (int x = 0; x < kRaw; ++x) fetch(x);
  }
  for (int x = 0; x < kRing - 1; ++x) form(x);
  clear();
  // Slab s: form s + kRing - 1 (after every warp's products of s - 1),
  // products of s (after every warp formed s). Warps run up to kRing - 1
  // slabs apart: one's forming beside another's products.
  for (int s = 0; s < total; ++s) {
    form(s + kRing - 1);
    // every warp closed the tangents of slabs up to s - 1
    if (tid == 0 && s + kRing - 1 < total && s >= 1 && s % slabs == 0) write_trace(t_begin + s / slabs - 1);
    product(s);
    if (s % slabs == slabs - 1) {
      close(t_begin + s / slabs);
      clear();
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(jempty + s % kRing);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    l2x += __shfl_down_sync(0xffffffffu, l2x, off);
    l2y += __shfl_down_sync(0xffffffffu, l2y, off);
  }
  if (lane == 0) red[warp] = make_double2(l2x, l2y);
  __syncthreads();
  if (tid == 0) {
    while (traced < t_end && total > 0) write_trace(traced);
    double sx = 0.0, sy = 0.0;
    for (int w = 0; w < nwarps; ++w) {
      sx += red[w].x;
      sy += red[w].y;
    }
    l2_part[static_cast<size_t>(blockIdx.y) * matrices + m] = make_double2(sx, sy);
  }
}

template <int SPW>
int launch_dmma(const void* jr, const void* jbc, const void* ep_val, const void* ep_jac3,
                const void* orb_val0, const void* a_inv, void* trb, void* l2_part, int n,
                int ndet, int batch, int t_loc, int splits, int offset, int t0,
                cudaStream_t st) {
  const size_t smem = dmma_smem_bytes(n);
  if (smem > 48 * 1024) {  // every launch: a static cache would miss another card
    const cudaError_t err = cudaFuncSetAttribute(
        dethead_trace_kernel_dmma<SPW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const DPlan blocks = plan(n);
  if (blocks.warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  // jr as (t_loc batch n) rows of 2 ndet n, in boxes of kDK rows x rl
  CUtensorMap jr_map;
  if (!rows_map(&jr_map, static_cast<const double*>(jr), 2ull * ndet * n,
                static_cast<unsigned long long>(t_loc) * batch * n, DLayout(n).rl, kDK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per = (t_loc + splits - 1) / splits;
  const dim3 grid(batch * ndet, splits);
  dethead_trace_kernel_dmma<SPW><<<grid, 32 * blocks.warps, dmma_smem_bytes(n), st>>>(
      static_cast<const double*>(jbc), static_cast<const double2*>(ep_val),
      static_cast<const double2*>(ep_jac3), static_cast<const double2*>(orb_val0),
      static_cast<const double2*>(a_inv), static_cast<double2*>(trb),
      static_cast<double2*>(l2_part), n, ndet, batch, t_loc, per, offset, t0, blocks, jr_map);
  return static_cast<int>(cudaGetLastError());
}

int launch_c128(const void* jr, const void* jbc, const void* ep_val, const void* ep_jac3,
                const void* orb_val0, const void* a_inv, void* trb, void* l2_part, int n,
                int ndet, int batch, int t_loc, int splits, int offset, int t0,
                cudaStream_t st) {
  if (bad_launch(n, kDMaxN, splits, t_loc, batch, ndet)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (fma_faster(n)) {
    return launch_tc<double, 4>(jr, jbc, ep_val, ep_jac3, orb_val0, a_inv, trb, l2_part, n,
                                ndet, batch, t_loc, splits, offset, t0, st);
  }
  if (DLayout(n).spw == 2) {
    return launch_dmma<2>(jr, jbc, ep_val, ep_jac3, orb_val0, a_inv, trb, l2_part, n, ndet,
                          batch, t_loc, splits, offset, t0, st);
  }
  return launch_dmma<5>(jr, jbc, ep_val, ep_jac3, orb_val0, a_inv, trb, l2_part, n, ndet,
                        batch, t_loc, splits, offset, t0, st);
}

// Blocks of `kernel` at `threads` and `smem` bytes that fit an SM of the
// current device; 0 where the query fails. Like a launch, it raises the
// kernel's shared-memory limit only past the default 48 KB, so that it
// never lowers it below what another n needs.
template <typename K>
int blocks_per_sm(K kernel, int threads, size_t smem) {
  int blocks = 0;
  if ((smem > 48 * 1024 &&
       cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(smem)) != cudaSuccess) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem) !=
          cudaSuccess) {
    return 0;
  }
  return blocks;
}

}  // namespace

extern "C" {

// Largest n each scalar serves: 119 complex64, 84 complex128.
int dethead_max_n(int is_double) {
  return is_double ? kDMaxN : Cx<float>::kMaxN;
}

// The body that launches for n: by the columns of a thread's tile of M_t
// (complex64 4, 6 or 8; complex128 4 where fma_faster), or 16, the side of
// a warp's blocks of M_t on the tensor cores (complex128 elsewhere); 0
// where the scalar does not serve n.
int dethead_tile_cols(int n, int is_double) {
  if (is_double) return n < 1 || n > kDMaxN ? 0 : fma_faster(n) ? 4 : 16;
  return serves<float>(n) ? tile_cols(n) : 0;
}

// Blocks of the body n takes that fit an SM of the current device; 0
// where the scalar does not serve n.
int dethead_blocks_per_sm(int n, int is_double) {
  if (is_double) {
    if (n < 1 || n > kDMaxN) return 0;
    if (fma_faster(n)) {
      return blocks_per_sm(dethead_trace_kernel<double, 4>, Grid<4>(n).threads(),
                           smem_bytes<double, 4>(n));
    }
    const int threads = 32 * plan(n).warps;
    return DLayout(n).spw == 2
               ? blocks_per_sm(dethead_trace_kernel_dmma<2>, threads, dmma_smem_bytes(n))
               : blocks_per_sm(dethead_trace_kernel_dmma<5>, threads, dmma_smem_bytes(n));
  }
  if (!serves<float>(n)) return 0;
  if (tile_cols(n) == 8) {
    return blocks_per_sm(dethead_trace_kernel<float, 8>, Grid<8>(n).threads(),
                         smem_bytes<float, 8>(n));
  }
  if (tile_cols(n) == 6) {
    return blocks_per_sm(dethead_trace_kernel<float, 6>, Grid<6>(n).threads(),
                         smem_bytes<float, 6>(n));
  }
  return blocks_per_sm(dethead_trace_kernel<float, 4>, Grid<4>(n).threads(),
                       smem_bytes<float, 4>(n));
}

// Dynamic shared memory of a block of the body n takes, in bytes; 0 where
// the scalar does not serve n.
int dethead_smem_bytes(int n, int is_double) {
  if (is_double) {
    if (n < 1 || n > kDMaxN) return 0;
    return static_cast<int>(fma_faster(n) ? smem_bytes<double, 4>(n) : dmma_smem_bytes(n));
  }
  if (!serves<float>(n)) return 0;
  const int tc = tile_cols(n);
  return static_cast<int>(tc == 8 ? smem_bytes<float, 8>(n)
                          : tc == 6 ? smem_bytes<float, 6>(n) : smem_bytes<float, 4>(n));
}

// jr: (t_loc, batch, n, 2 ndet n) float; jbc: (t_loc, batch, 2 ndet n) or
// null; ep_val, orb_val0, a_inv: (batch, ndet, n, n) complex64; ep_jac3:
// (3, batch, ndet, n, n); trb: (t_loc, batch, ndet); l2_part: (splits,
// batch, ndet). Returns the cudaError_t of the launch.
int dethead_trace_launch(const void* jr, const void* jbc, const void* ep_val,
                         const void* ep_jac3, const void* orb_val0, const void* a_inv,
                         void* trb, void* l2_part, int n, int ndet, int batch,
                         int t_loc, int splits, int offset, int t0, void* stream) {
  return launch_c64(jr, jbc, ep_val, ep_jac3, orb_val0, a_inv, trb, l2_part, n, ndet, batch,
                    t_loc, splits, offset, t0, static_cast<cudaStream_t>(stream));
}

// The same in double: jr, jbc float64; the rest complex128.
int dethead_trace_launch_c128(const void* jr, const void* jbc, const void* ep_val,
                              const void* ep_jac3, const void* orb_val0,
                              const void* a_inv, void* trb, void* l2_part, int n,
                              int ndet, int batch, int t_loc, int splits, int offset,
                              int t0, void* stream) {
  return launch_c128(jr, jbc, ep_val, ep_jac3, orb_val0, a_inv, trb, l2_part, n, ndet, batch,
                     t_loc, splits, offset, t0, static_cast<cudaStream_t>(stream));
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
