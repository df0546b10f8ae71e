// Batched lower Cholesky factorization, fp32 -- for sm_90a.
//
// Replaces: fine_grained_gaussian_process_forcasting_tpu/ops/pallas/
//   cholesky.py `_make_kernel(..., blocked=False)` `kernel_unblocked`
//   (reached through `batched_cholesky`, `_cholesky_impl`): one program per
//   matrix runs a masked column recurrence over the whole (n, n) matrix in
//   VMEM and returns the lower factor with the upper triangle zero.  Its
//   pullback is plain XLA; here it is plain PyTorch.
//
// What bounds it on an H100: not the card's rates.  At (256, 192, 192) the
// function moves 75.5 MB (0.0225 ms at 3.35 TB/s) and does 0.60 GFLOP
// (0.009 ms), but each matrix is a chain of n dependent steps: pivot, then
// the column below it, then the rank-1 update of the trailing triangle.
// With one block per matrix every step costs two block-wide barriers and a
// pass over the trailing triangle, so the kernel is bound by that latency
// chain, far off its bound; the right-looking recurrence is kept because it
// is simple and exact (the Pallas kernel's own, column for column).
//
// Design.  One block of 512 threads per matrix.  For n <= 240 the lower
// triangle lives in shared memory (row stride n + 1, so that the column
// reads of a step hit distinct banks; 148 KB at n = 192).  Above that the
// matrix does not fit a block's 227 KB (590 KB at n = 384) and the same
// recurrence runs in place in the output, in device memory (L2), with the
// current column cached in shared memory.  Step j:
//   1. every thread reads the pivot p = A[j][j]; the threads that own rows
//      i > j write L[i][j] = A[i][j] / sqrt(p) to the matrix and to the
//      column cache; barrier;
//   2. one warp per row i > j, lanes along k: A[i][k] -= L[i][j] L[k][j]
//      for j < k <= i; thread 0 writes L[j][j] = sqrt(p); barrier.
// A pivot that is not > 0 (the matrix is not positive definite, as LAPACK
// tests it) marks the matrix failed, and the whole output is then NaN, as
// jnp.linalg.cholesky and the port's plain version return.  No exception.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_MAX_N = 240;  // n + n (n + 1) floats within 232,448 bytes

template <bool IN_SMEM>
__global__ void __launch_bounds__(THREADS)
cholesky_kernel(const float* __restrict__ a, float* __restrict__ out, int n) {
  extern __shared__ float smem[];
  __shared__ int failed;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* A = a + (size_t)blockIdx.x * n * n;
  float* O = out + (size_t)blockIdx.x * n * n;
  float* col = smem;  // n floats: column j of L, below the diagonal
  float* W = IN_SMEM ? smem + n : O;  // the working lower triangle
  const int ld = IN_SMEM ? n + 1 : n;

  if (tid == 0) failed = 0;
  for (int i = warp; i < n; i += WARPS) {
    for (int k = lane; k < n; k += 32) {
      if (IN_SMEM) {
        if (k <= i) W[i * ld + k] = A[(size_t)i * n + k];
      } else {
        W[i * ld + k] = k <= i ? A[(size_t)i * n + k] : 0.f;
      }
    }
  }
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const float p = W[j * ld + j];
    const bool ok = p > 0.f;  // false for NaN too
    const float dj = ok ? sqrtf(p) : __int_as_float(0x7fc00000);
    for (int i = j + 1 + tid; i < n; i += THREADS) {
      const float l = W[i * ld + j] / dj;
      col[i] = l;
      W[i * ld + j] = l;
    }
    __syncthreads();
    for (int i = j + 1 + warp; i < n; i += WARPS) {
      const float li = col[i];
      float* row = W + i * ld;
      for (int k = j + 1 + lane; k <= i; k += 32)
        row[k] = fmaf(-li, col[k], row[k]);
    }
    if (tid == 0) {
      W[j * ld + j] = dj;  // nothing reads it during this step
      if (!ok) failed = 1;
    }
    __syncthreads();
  }

  const bool bad = failed != 0;
  const float nan = __int_as_float(0x7fc00000);
  if (IN_SMEM || bad) {
    for (int i = warp; i < n; i += WARPS)
      for (int k = lane; k < n; k += 32)
        O[(size_t)i * n + k] = bad ? nan : (k <= i ? W[i * ld + k] : 0.f);
  }
}

template <bool IN_SMEM>
int launch(const float* a, float* out, int B, int n, cudaStream_t stream) {
  const size_t floats = IN_SMEM ? (size_t)n + (size_t)n * (n + 1) : n;
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cholesky_kernel<IN_SMEM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cholesky_kernel<IN_SMEM><<<B, THREADS, bytes, stream>>>(a, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a (B, n, n) fp32, contiguous, read in its lower triangle; out (B, n, n):
// the lower factor, zeros above, or all NaN where a is not positive
// definite.  Returns the cudaError_t of the launch (cudaErrorInvalidValue
// for an empty batch or n outside 1..46340, where n^2 leaves 32 bits).
int batched_cholesky_fwd(const float* a, float* out, int B, int n,
                         void* stream) {
  if (B < 1 || n < 1 || n > 46340) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= SMEM_MAX_N) return launch<true>(a, out, B, n, s);
  return launch<false>(a, out, B, n, s);
}

}  // extern "C"
