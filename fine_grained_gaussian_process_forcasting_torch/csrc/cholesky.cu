// Batched lower Cholesky factorization, fp32 -- for sm_90a.
//
// Replaces: fine_grained_gaussian_process_forcasting_tpu/ops/pallas/
//   cholesky.py `_make_kernel(..., blocked=False)` `kernel_unblocked`
//   (reached through `batched_cholesky`, `_cholesky_impl`; the blocked
//   variant `kernel_blocked` computes the same factor): one program per
//   matrix over the whole (n, n) matrix in VMEM, returning the lower factor
//   with the upper triangle zero.  Its pullback is plain XLA; here it is
//   plain PyTorch.
//
// What bounds it on an H100: not the card's rates.  At (256, 192, 192) the
// function moves 56.6 MB (0.017 ms at 3.35 TB/s) and does 0.60 GFLOP
// (0.009 ms), but each matrix is a chain of dependent steps (a pivot, the
// column below it, the update of the trailing triangle), so the time is the
// length of that chain: barriers, latencies of shared and L2 accesses.  The
// first design (one column a step, two block-wide barriers each, the
// triangle in shared memory) paid n steps of it and lost to cuSOLVER.
//
// Design: blocked, right-looking, panels of NB = 32 columns, one block of
// 256 threads per matrix.  The factor is built in place in the output, in
// device memory (L2 holds it: 37.7 MB at (256, 192)); shared memory holds
// only the current panel, so a block takes 25 KB at n 192 and 50 KB at n
// 384, and two or more matrices share an SM at every shape of the exact
// blur.  Panel k (columns k0 .. k0 + 31, trailing rows k1 = k0 + 32 ..):
//   1. one warp factors the 32 x 32 diagonal block in registers, lane i
//      holding row i, the pivot and column broadcast by shuffles: no
//      block-wide barrier per column.  A pivot that is not > 0 (LAPACK's
//      test; false for NaN) marks the matrix failed;
//   2. the panel below it, L21 = A21 L11^-T: the block loads it, transposed,
//      into shared memory, each thread solves whole rows against L11
//      (broadcast from shared memory), and writes them to the output;
//   3. the trailing update A22 -= L21 L21^T over the lower 64 x 64 tiles:
//      each thread owns a 4 x 4 register tile and takes the 32 rank-1 steps
//      from the panel in shared memory (16 FMAs for two 16-byte shared
//      reads), so every trailing element is read and written once per panel
//      through L2, not once per column.
// Three barriers a panel, not two a column.  Panel 0 reads the input (lower
// triangle only) and writes the output; later panels work in the output.
// Where the trailing rows exceed PANEL_CAP (n > 1056) the panel is solved in
// chunks and each update tile stages its two 64-row slices of the panel from
// the output.  A failed matrix stops at the panel that failed and comes back
// all NaN, as jnp.linalg.cholesky and the port's plain version return it.
// No exception.  n is any of 1 .. 46340; a last diagonal block narrower than
// 32 is padded with the identity in registers.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NB = 32;          // panel width
constexpr int THREADS = 256;    // 8 warps; 16 x 16 threads in the update
constexpr int WARPS = THREADS / 32;
constexpr int TT = 64;          // update tile: 64 x 64, 4 x 4 a thread
constexpr int PANEL_CAP = 1024; // panel rows held in shared memory
constexpr int STAGE_LD = TT + 4;
constexpr unsigned FULL = 0xffffffffu;

// Leading dimension of the transposed panel buffer for `rows` rows: a
// multiple of 4 (16-byte reads of four rows) that is 4 mod 32, so that a
// warp storing 4 rows x 8 columns hits 32 distinct banks.
__host__ __device__ inline int panel_ld(int rows) {
  return (rows + 31) / 32 * 32 + 4;
}

__host__ __device__ inline int panel_rows(int n) {
  const int rows = n - NB;
  return rows < 1 ? 1 : (rows > PANEL_CAP ? PANEL_CAP : rows);
}

__host__ inline size_t smem_bytes(int n) {
  return ((size_t)NB * (NB + 1) + NB + (size_t)NB * panel_ld(panel_rows(n)))
         * sizeof(float);
}

// Rows [r0, r0 + rows) x columns [c0, c0 + 32) of the (n, n) matrix m into
// buf[j * ld + r] (or back, STORE).  A warp moves 4 rows x 8 columns: 32-byte
// runs in device memory, 32 banks in shared memory.
template <bool STORE>
__device__ __forceinline__ void move_panel(float* buf, int ld,
                                           const float* src, float* dst,
                                           int n, int r0, int rows, int c0) {
  const int span = (rows + 3) / 4 * 4 * NB;  // whole groups of 4 rows
  for (int i = threadIdx.x; i < span; i += THREADS) {
    const int w = i >> 5;
    const int j = (w & 3) * 8 + (i & 7);
    const int r = (w >> 2) * 4 + ((i >> 3) & 3);
    if (r >= rows) continue;
    const size_t at = (size_t)(r0 + r) * n + c0 + j;
    if (STORE) dst[at] = buf[j * ld + r];
    else buf[j * ld + r] = src[at];
  }
}

__global__ void __launch_bounds__(THREADS, 2)
cholesky_kernel(const float* __restrict__ a, float* __restrict__ out, int n) {
  extern __shared__ __align__(16) float smem[];
  float* dg = smem;                    // [NB][NB + 1]  L11
  float* inv = dg + NB * (NB + 1);     // [NB]          1 / diag(L11)
  float* pan = inv + NB;               // [NB][ld]      the panel, transposed
  __shared__ int failed;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* A = a + (size_t)blockIdx.x * n * n;
  float* O = out + (size_t)blockIdx.x * n * n;
  const int cap = panel_rows(n);
  const int ld = panel_ld(cap);

  if (tid == 0) failed = 0;
  for (int i = warp; i < n; i += WARPS)  // the upper triangle is zero
    for (int k = i + 1 + lane; k < n; k += 32) O[(size_t)i * n + k] = 0.f;

  for (int k0 = 0; k0 < n; k0 += NB) {
    const float* src = k0 == 0 ? A : O;  // panel 0 reads the input
    const int nbk = min(NB, n - k0);
    const int k1 = k0 + nbk;
    const int nt = n - k1;

    // 1. the diagonal block, by warp 0
    if (warp == 0) {
      for (int i = 0; i < nbk; ++i)  // row i, coalesced along the columns
        dg[i * (NB + 1) + lane] =
            lane <= i ? src[(size_t)(k0 + i) * n + k0 + lane] : 0.f;
      __syncwarp();
      float r[NB];
#pragma unroll
      for (int k = 0; k < NB; ++k)
        r[k] = lane < nbk ? (k <= lane ? dg[lane * (NB + 1) + k] : 0.f)
                          : (k == lane ? 1.f : 0.f);  // identity padding
      bool bad = false;
      float my_inv = 1.f;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float p = __shfl_sync(FULL, r[j], j);
        bad |= !(p > 0.f);
        const float dj = sqrtf(p);
        const float ij = 1.f / dj;
        if (lane == j) { r[j] = dj; my_inv = ij; }
        else if (lane > j) r[j] *= ij;
#pragma unroll
        for (int k = j + 1; k < NB; ++k) {
          const float lkj = __shfl_sync(FULL, r[j], k);
          if (lane >= k) r[k] = fmaf(-r[j], lkj, r[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < NB; ++k) dg[lane * (NB + 1) + k] = r[k];
      inv[lane] = my_inv;
      __syncwarp();
      for (int i = 0; i < nbk; ++i)
        if (lane <= i) O[(size_t)(k0 + i) * n + k0 + lane] = dg[i * (NB + 1) + lane];
      if (__any_sync(FULL, bad) && lane == 0) failed = 1;
    }
    __syncthreads();
    if (failed || nt == 0) break;

    // 2. the panel below: L21 = A21 L11^-T, row by row, in chunks of cap
    for (int c0 = 0; c0 < nt; c0 += cap) {
      const int rows = min(cap, nt - c0);
      if (c0 > 0) __syncthreads();  // the previous chunk is stored
      move_panel<false>(pan, ld, src, nullptr, n, k1 + c0, rows, k0);
      __syncthreads();
      for (int rr = tid; rr < rows; rr += THREADS) {
        float v[NB];
#pragma unroll
        for (int j = 0; j < NB; ++j) v[j] = pan[j * ld + rr];
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          v[j] *= inv[j];
#pragma unroll
          for (int m = j + 1; m < NB; ++m)
            v[m] = fmaf(-v[j], dg[m * (NB + 1) + j], v[m]);
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) pan[j * ld + rr] = v[j];
      }
      __syncthreads();
      move_panel<true>(pan, ld, nullptr, O, n, k1 + c0, rows, k0);
    }
    const bool staged = nt > cap;
    if (staged) __syncthreads();  // the panel's rows are in the output

    // 3. the trailing update, lower 64 x 64 tiles (I >= J)
    const int tiles = (nt + TT - 1) / TT;
    const int ty = tid >> 4, tx = tid & 15;
    for (int I = 0; I < tiles; ++I) {
      for (int J = 0; J <= I; ++J) {
        const float* pa = pan + I * TT;
        const float* pb = pan + J * TT;
        int pld = ld;
        if (staged) {  // both 64-row slices of the panel from the output
          float* sa = pan;
          float* sb = pan + NB * STAGE_LD;
          __syncthreads();  // the previous tile is done with them
          move_panel<false>(sa, STAGE_LD, O, nullptr, n, k1 + I * TT,
                            min(TT, nt - I * TT), k0);
          move_panel<false>(sb, STAGE_LD, O, nullptr, n, k1 + J * TT,
                            min(TT, nt - J * TT), k0);
          __syncthreads();
          pa = sa;
          pb = sb;
          pld = STAGE_LD;
        }
        if (I == J && ty < tx) continue;  // wholly above the diagonal
        const int i0 = I * TT + ty * 4, j0 = J * TT + tx * 4;
        if (i0 >= nt || j0 >= nt) continue;
        float c[4][4], acc[4][4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = i0 + p, j = j0 + q;
            c[p][q] = (i < nt && j < nt && j <= i)
                          ? src[(size_t)(k1 + i) * n + k1 + j] : 0.f;
            acc[p][q] = 0.f;
          }
#pragma unroll 8
        for (int kk = 0; kk < NB; ++kk) {
          const float4 x = *reinterpret_cast<const float4*>(pa + kk * pld + ty * 4);
          const float4 y = *reinterpret_cast<const float4*>(pb + kk * pld + tx * 4);
          const float xa[4] = {x.x, x.y, x.z, x.w};
          const float ya[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(xa[p], ya[q], acc[p][q]);
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = i0 + p, j = j0 + q;
            if (i < nt && j < nt && j <= i)
              O[(size_t)(k1 + i) * n + k1 + j] = c[p][q] - acc[p][q];
          }
      }
    }
    __syncthreads();  // the trailing matrix is updated; the panel is free
  }

  if (failed) {
    const float nan = __int_as_float(0x7fc00000);
    for (int i = warp; i < n; i += WARPS)
      for (int k = lane; k < n; k += 32) O[(size_t)i * n + k] = nan;
  }
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
  const size_t bytes = smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      cholesky_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cholesky_kernel<<<B, THREADS, bytes, (cudaStream_t)stream>>>(a, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
