// Fused whitened-GP marginals, forward, affine, fp32 -- for sm_90a.
//
// Replaces: fine_grained_gaussian_process_forcasting_tpu/ops/pallas/fused_gp.py
//   `_fwd_kernel` with affine=True, bf16=False (reached through
//   `whitened_marginals_affine`, `_forward`).
//
// Per row r of the flattened (B*N, d) raw input x:
//   xs      = x[r] * inv_ls
//   K[r, m] = os * exp(-0.5 * |xs - zs[m]|^2)           m < M inducing points
//   mean[r] = x[r] . mean_w + mean_b + sum_m K[r, m] u[m]
//   var[r]  = os - sum_n K[r, n] * (K W)[r, n]
//
// What bounds it on an H100: arithmetic.  The (K W) product is 2*M*M flops
// per row (at the flagship 73,728 rows x M=512 about 39 GFLOP), all fp32:
// the parity tolerance (2e-5) rules out TF32, so it runs on the CUDA cores
// (67 TFLOP/s peak) -- about 0.6 ms -- while the bytes (x in, two vectors
// out, W once) take a few microseconds.
//
// Design: one block of 256 threads per tile of 64 rows.  The TPU kernel held
// a 2048-row tile, all of W and the (tile, M) K in VMEM; here W alone (1 MiB
// at M=512) exceeds a block's shared memory, so
//   1. the tile's K is computed once into shared memory, transposed
//      (K^T, M x 64, 136 KB at M=512), with the direct difference
//      |xs - zs|^2 (no cancellation, never negative);
//   2. W streams through shared memory in 16 x 256 chunks, double-buffered
//      through registers, and each thread accumulates an 8 x 8 register tile
//      of K W (warp w owns rows 8w..8w+7, lane c owns columns 4c..4c+3 and
//      128+4c..128+4c+3 of each 256-column panel);
//   3. at the end of each panel the register tile is multiplied by K and
//      summed into per-row partial variances; a warp shuffle finishes the
//      row sums.  K and K W never reach device memory.
// Rows past the end are zero inputs whose results are never stored (no
// padding in device memory).  fp32 FMA throughout.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TR = 64;             // rows per block
constexpr int THREADS = 256;       // 8 warps x 8 rows
constexpr int PANEL = 256;         // W columns per panel
constexpr int BK = 16;             // W rows per shared-memory chunk
constexpr int KT_STRIDE = TR + 4;  // padded K^T row, keeps float4 alignment
constexpr int PREFETCH = BK * PANEL / THREADS;  // 16 W values per thread

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// chunk c = (panel p, row chunk kc); element (i, tid) = W[k0 + i, n0 + tid]
__device__ __forceinline__ void load_w_chunk(const float* __restrict__ w, int M,
                                             int n_chunks, int c, int tid,
                                             float (&regs)[PREFETCH]) {
  const int p = c / n_chunks;
  const int k0 = (c - p * n_chunks) * BK;
  const int n = p * PANEL + tid;
#pragma unroll
  for (int i = 0; i < PREFETCH; ++i) {
    const int k = k0 + i;
    regs[i] = (k < M && n < M) ? __ldg(w + (size_t)k * M + n) : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
fused_gp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ zs,
                    const float* __restrict__ u, const float* __restrict__ w,
                    const float* __restrict__ os_ptr,
                    const float* __restrict__ inv_ls,
                    const float* __restrict__ mean_w,
                    const float* __restrict__ mean_b_ptr,
                    float* __restrict__ mean_out, float* __restrict__ var_out,
                    int R, int d, int M, int m_pad) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                     // [m_pad][KT_STRIDE]  K^T of the tile
  float* xt = kt + m_pad * KT_STRIDE;   // [d][TR]             scaled x^T
  float* wbuf = xt + d * TR;            // [2][BK][PANEL]      W chunks

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * TR;
  const float os = *os_ptr;

  // scaled x^T of the tile; rows past R are zeros and are never stored
  for (int i = tid; i < TR * d; i += THREADS) {
    const int r = i / d;
    const int k = i - r * d;
    const int row = row0 + r;
    xt[k * TR + r] = row < R ? x[(size_t)row * d + k] * inv_ls[k] : 0.f;
  }
  __syncthreads();

  // 1. K^T[m][r]; thread owns whole columns m, rows accumulate in registers
  for (int m = tid; m < m_pad; m += THREADS) {
    float4* ktm = reinterpret_cast<float4*>(kt + m * KT_STRIDE);
    if (m >= M) {
#pragma unroll
      for (int r4 = 0; r4 < TR / 4; ++r4) ktm[r4] = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    float d2[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) d2[r] = 0.f;
    const float* zm = zs + (size_t)m * d;
    for (int k = 0; k < d; ++k) {
      const float z = __ldg(zm + k);
      const float4* xk = reinterpret_cast<const float4*>(xt + k * TR);
#pragma unroll
      for (int r4 = 0; r4 < TR / 4; ++r4) {
        const float4 xv = xk[r4];
        float a;
        a = xv.x - z; d2[4 * r4 + 0] = fmaf(a, a, d2[4 * r4 + 0]);
        a = xv.y - z; d2[4 * r4 + 1] = fmaf(a, a, d2[4 * r4 + 1]);
        a = xv.z - z; d2[4 * r4 + 2] = fmaf(a, a, d2[4 * r4 + 2]);
        a = xv.w - z; d2[4 * r4 + 3] = fmaf(a, a, d2[4 * r4 + 3]);
      }
    }
#pragma unroll
    for (int r4 = 0; r4 < TR / 4; ++r4) {
      ktm[r4] = make_float4(os * expf(-0.5f * d2[4 * r4 + 0]),
                            os * expf(-0.5f * d2[4 * r4 + 1]),
                            os * expf(-0.5f * d2[4 * r4 + 2]),
                            os * expf(-0.5f * d2[4 * r4 + 3]));
    }
  }
  __syncthreads();

  // mean: warp w sums K[r, :] u over its 8 rows, lanes stride over m
  {
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int m = lane; m < M; m += 32) {
      const float um = __ldg(u + m);
      const float4* km = reinterpret_cast<const float4*>(kt + m * KT_STRIDE + warp * 8);
      const float4 a = km[0], b = km[1];
      acc[0] = fmaf(a.x, um, acc[0]); acc[1] = fmaf(a.y, um, acc[1]);
      acc[2] = fmaf(a.z, um, acc[2]); acc[3] = fmaf(a.w, um, acc[3]);
      acc[4] = fmaf(b.x, um, acc[4]); acc[5] = fmaf(b.y, um, acc[5]);
      acc[6] = fmaf(b.z, um, acc[6]); acc[7] = fmaf(b.w, um, acc[7]);
    }
    float mine = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float s = warp_sum(acc[i]);
      if (lane == i) mine = s;
    }
    const int row = row0 + warp * 8 + lane;
    if (lane < 8 && row < R) {
      float mx = *mean_b_ptr;
      const float* xr = x + (size_t)row * d;
      for (int k = 0; k < d; ++k) mx = fmaf(xr[k], mean_w[k], mx);
      mean_out[row] = mx + mine;
    }
  }

  // 2. var: (K W) panel by panel, W streamed through shared memory
  const int n_panels = (M + PANEL - 1) / PANEL;
  const int n_chunks = m_pad / BK;
  const int total = n_panels * n_chunks;

  float g[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) g[i][j] = 0.f;
  float var_part[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) var_part[i] = 0.f;

  float pre[PREFETCH];
  load_w_chunk(w, M, n_chunks, 0, tid, pre);
#pragma unroll
  for (int i = 0; i < PREFETCH; ++i) wbuf[i * PANEL + tid] = pre[i];
  __syncthreads();

  for (int c = 0; c < total; ++c) {
    const int p = c / n_chunks;
    const int kc = c - p * n_chunks;
    if (c + 1 < total) load_w_chunk(w, M, n_chunks, c + 1, tid, pre);

    const float* wb = wbuf + (c & 1) * (BK * PANEL);
    const float* ktk = kt + kc * BK * KT_STRIDE + warp * 8;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4* kr = reinterpret_cast<const float4*>(ktk + kk * KT_STRIDE);
      const float4 ka = kr[0], kb = kr[1];
      const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
      const float4 wa = reinterpret_cast<const float4*>(wb + kk * PANEL)[lane];
      const float4 wc = reinterpret_cast<const float4*>(wb + kk * PANEL + PANEL / 2)[lane];
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wc.x, wc.y, wc.z, wc.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) g[i][j] = fmaf(kv[i], wv[j], g[i][j]);
    }

    if (kc == n_chunks - 1) {
      // end of panel p: var_part[i] += sum_j (K W)[r_i, n_j] * K[r_i, n_j]
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = p * PANEL + (j < 4 ? 4 * lane + j : PANEL / 2 + 4 * lane + (j - 4));
        if (n < M) {
          const float4* kn = reinterpret_cast<const float4*>(kt + n * KT_STRIDE + warp * 8);
          const float4 a = kn[0], b = kn[1];
          const float kv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) var_part[i] = fmaf(g[i][j], kv[i], var_part[i]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) g[i][j] = 0.f;
      }
    }

    if (c + 1 < total) {
      float* nb = wbuf + ((c + 1) & 1) * (BK * PANEL);
#pragma unroll
      for (int i = 0; i < PREFETCH; ++i) nb[i * PANEL + tid] = pre[i];
    }
    __syncthreads();
  }

  float mine = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float s = warp_sum(var_part[i]);
    if (lane == i) mine = s;
  }
  const int row = row0 + warp * 8 + lane;
  if (lane < 8 && row < R) var_out[row] = os - mine;
}

}  // namespace

extern "C" {

// Shared memory the launch needs, in bytes (the wrapper checks it against
// the card's per-block limit before launching).
long long fused_gp_fwd_smem_bytes(int d, int M) {
  const long long m_pad = (M + BK - 1) / BK * BK;
  return (m_pad * KT_STRIDE + (long long)d * TR + 2LL * BK * PANEL) * (long long)sizeof(float);
}

// x (R, d) raw rows; zs (M, d) = Z / lengthscale; u (M,); w (M, M) row-major;
// os, mean_b: device scalars; inv_ls, mean_w (d,); mean, var (R,) outputs.
// Returns the cudaError_t of the launch.
int fused_gp_fwd(const float* x, const float* zs, const float* u, const float* w,
                 const float* os, const float* inv_ls, const float* mean_w,
                 const float* mean_b, float* mean, float* var, int R, int d,
                 int M, void* stream) {
  const int m_pad = (M + BK - 1) / BK * BK;
  const int smem = (int)fused_gp_fwd_smem_bytes(d, M);
  cudaError_t err = cudaFuncSetAttribute(
      fused_gp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (R + TR - 1) / TR;
  fused_gp_fwd_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, zs, u, w, os, inv_ls, mean_w, mean_b, mean, var, R, d, M, m_pad);
  return (int)cudaGetLastError();
}

}  // extern "C"
