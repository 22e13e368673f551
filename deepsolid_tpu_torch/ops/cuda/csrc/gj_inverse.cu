// Batched complex64 Gauss-Jordan inverse + slogdet for Hopper (sm_90a).
//
// Replaces the TPU kernel deepsolid_tpu/ops/pallas/det_kernels.py
// (_gj_kernel, launched by _gj_flat through gj_inverse_slogdet), which
// laid the matrix batch across the 128 vector lanes of a TPU core.
//
// What it computes, per matrix A (n x n): A^-1, sign = prod piv/|piv| *
// (-1)^swaps and log|det A| = sum 0.5 log|piv|^2. The pivot at step k is
// the largest |A[r, k]|^2 among the unused rows r >= k, the smallest r on
// a tie (the TPU kernel's rule). The inverse is formed in place: column
// k keeps the multipliers, and the columns are unscrambled in reverse
// pivot order at the end.
//
// What bounds it on this card: at the main path's shape (8192 matrices
// of 48 x 48 per launch) the work is 8 n^3 flops per matrix, 7.2 GFLOP,
// and 302 MB of input and output; both would take ~0.1 ms at the card's
// peaks. The elimination is a chain of n dependent steps, so what bounds
// this simple design is the block-wide barrier of every step, not
// arithmetic or memory.
//
// Design: one thread block per matrix, the whole matrix in shared memory
// (18 KB at n = 48; up to n = 168 with the dynamic shared-memory opt-in).
// Per step, warp 0 picks the pivot with a shuffle reduction and updates
// the sign and log|det|; then the block buffers the old row k, the scaled
// pivot row and the multiplier column, and one pass over the n^2 entries
// applies the row swap and the elimination together. Three barriers per
// step; the batch rides the grid, one launch for all matrices. Plain FP32
// arithmetic, no fast-math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__global__ void __launch_bounds__(kThreads)
gj_inverse_slogdet_kernel(const float2* __restrict__ a,
                          float2* __restrict__ ainv,
                          float2* __restrict__ sign_out,
                          float* __restrict__ logdet_out, int n) {
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
        const float ob = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, bidx, off);
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

    for (int i = tid; i < nn; i += blockDim.x) {
      const int r = i / n;
      const int j = i - r * n;
      float2 out;
      if (r == k) {
        out = (j == k) ? d : prow[j];
      } else {
        const float2 f = fcol[r];
        if (j == k) {
          const float2 fd = cmul(f, d);
          out = make_float2(-fd.x, -fd.y);
        } else {
          const float2 src = (r == p) ? rowk[j] : m[i];
          const float2 fp = cmul(f, prow[j]);
          out = make_float2(src.x - fp.x, src.y - fp.y);
        }
      }
      m[i] = out;
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

// Dynamic shared memory the kernel needs for n x n matrices.
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
  const size_t smem = static_cast<size_t>(gj_smem_bytes(n));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gj_inverse_slogdet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gj_inverse_slogdet_kernel<<<batch, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(a), static_cast<float2*>(ainv),
      static_cast<float2*>(sign), static_cast<float*>(logdet), n);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
