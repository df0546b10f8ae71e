// Fused whitened-GP marginals, forward and backward, affine, fp32 -- for
// sm_90a.
//
// Replaces: fine_grained_gaussian_process_forcasting_tpu/ops/pallas/fused_gp.py
//   `_fwd_kernel` and `_bwd_kernel` with affine=True, bf16=False (reached
//   through `whitened_marginals_affine`, `_forward` and `_bwd_rule`).
//
// Per row r of the flattened (B*N, d) raw input x:
//   xs      = x[r] * inv_ls
//   K[r, m] = os * exp(-0.5 * |xs - zs[m]|^2)           m < M inducing points
//   mean[r] = x[r] . mean_w + mean_b + sum_m K[r, m] u[m]
//   var[r]  = os - sum_n K[r, n] * (K W)[r, n]
// and, for cotangents dmean, dvar, the VJP (W symmetric, as the Pallas
// kernel takes it):
//   E    = (dmean u^T - 2 dvar o (K W)) o K
//   dxs  = E zs - rowsum(E) o xs      (wrt the scaled x)
//   dx   = dxs o inv_ls + dmean o mean_w                    per row
//   dzs  = E^T xs - colsum(E) o zs,  du = K^T dmean,
//   dW   = -K^T diag(dvar) K,        dos = sum(E) / os + sum(dvar),
//   dinv_ls = sum_r dxs o x,  dmean_w = sum_r dmean o x,  dmean_b = sum dmean
//                                                        summed over rows.
//
// What bounds it on an H100: arithmetic.  The (K W) product is 2*M*M flops
// per row (at the flagship 73,728 rows x M=512 about 39 GFLOP), all fp32:
// the parity tolerance (2e-5) rules out TF32, so it runs on the CUDA cores
// (67 TFLOP/s peak) -- about 0.6 ms -- while the bytes (x in, two vectors
// out, W once) take a few microseconds.  The backward does (K W) again and a
// second product of the same size, dW = K^T diag(dvar) K, so about twice
// the forward's arithmetic (~1.26 ms at peak).
//
// Forward design: one block of 256 threads per tile of 64 rows.  The TPU
// kernel held a 2048-row tile, all of W and the (tile, M) K in VMEM; here W
// alone (1 MiB at M=512) exceeds a block's shared memory, so
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
//
// Backward design.  The Pallas backward sums the parameter cotangents across
// its grid with init-at-step-0-then-add, which is right only on the TPU's
// sequential grid; CUDA blocks run concurrently and in no order.  The port
// instead splits the work so that every sum over rows is taken by one thread
// in a fixed order -- no atomics, so the gradients are equal bit for bit
// from run to run -- in four launches:
//   1. rows (as the forward, one block per 64-row tile): recompute K^T into
//      shared memory and (K W) panel by panel; at each panel's end form E in
//      registers.  Per row: rowsum(E), then dxs = E zs - rowsum(E) xs from an
//      E^T tile re-read into the K^T buffer, and dx.  Per tile: partial
//      du = K^T dmean and colsum(E) (M each) and the partial scalar sums.
//      K and E are written to device memory (R x M each, 151 MB at the
//      flagship) for the two column products: those bytes take ~0.1 ms at
//      3.35 TB/s against ~1.3 ms of arithmetic, where recomputing K inside a
//      tiled product would cost one exponential and 2d flops per element for
//      every output tile that reads it.
//   2. dW partials: (K^T diag(dvar) K) over S contiguous row ranges, one
//      (S, M, M) slab, a 128 x 128 output tile per block with an 8 x 8
//      register tile per thread; dW is symmetric, so only the tiles on and
//      above the diagonal are computed (10 of 16 at M = 512);
//   3. dzs partials: E^T x over row ranges the same way, (S', M, d);
//   4. a reduction that sums the partials in a fixed order and applies the
//      column terms: dW, du, dzs = inv_ls o (E^T x) - colsum(E) o zs, and
//      the scalars.
// Tail rows are masked as in the forward: their cotangents count as zero and
// nothing is written for them.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TR = 64;             // rows per block
constexpr int THREADS = 256;       // 8 warps x 8 rows
constexpr int PANEL = 256;         // W columns per panel
constexpr int BK = 16;             // W rows per shared-memory chunk
constexpr int KT_STRIDE = TR + 4;  // padded K^T row, keeps float4 alignment
constexpr int PREFETCH = BK * PANEL / THREADS;  // 16 W values per thread

// column products (launches 2 and 3)
constexpr int CK = 8;              // rows per shared-memory chunk
constexpr int CBM = 128;           // output rows (m) per block
constexpr int DW_TILE = 128;       // dW output tile: 16 x 8 per side
constexpr int TARGET_BLOCKS = 264; // two blocks per SM on 132 SMs

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// sum of v over the block's threads, in a fixed order; every thread gets it
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  return s;
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

// scaled x^T of the tile into xt [d][TR] (rows past R are zeros), then K^T
// of the tile into kt [m_pad][KT_STRIDE] (columns m >= M are zeros)
__device__ __forceinline__ void tile_kt(const float* __restrict__ x,
                                        const float* __restrict__ zs,
                                        const float* __restrict__ inv_ls,
                                        float os, float* kt, float* xt,
                                        int row0, int R, int d, int M,
                                        int m_pad) {
  const int tid = threadIdx.x;
  for (int i = tid; i < TR * d; i += THREADS) {
    const int r = i / d;
    const int k = i - r * d;
    const int row = row0 + r;
    xt[k * TR + r] = row < R ? x[(size_t)row * d + k] * inv_ls[k] : 0.f;
  }
  __syncthreads();

  // thread owns whole columns m, rows accumulate in registers
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
}

// column of the thread's register tile j within panel p
__device__ __forceinline__ int panel_col(int p, int lane, int j) {
  return p * PANEL + (j < 4 ? 4 * lane + j : PANEL / 2 + 4 * lane + (j - 4));
}

// (K W) of the tile, panel by panel, W streamed through shared memory;
// at the end of panel p calls epi(p, g) with the thread's 8 x 8 tile g of
// (K W)[8 warp + i, panel_col(p, lane, j)], then zeroes g.
template <class Epilogue>
__device__ __forceinline__ void kw_panels(const float* __restrict__ w,
                                          const float* kt, float* wbuf, int M,
                                          int m_pad, Epilogue& epi) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_panels = (M + PANEL - 1) / PANEL;
  const int n_chunks = m_pad / BK;
  const int total = n_panels * n_chunks;

  float g[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) g[i][j] = 0.f;

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
      epi(p, g);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) g[i][j] = 0.f;
    }

    if (c + 1 < total) {
      float* nb = wbuf + ((c + 1) & 1) * (BK * PANEL);
#pragma unroll
      for (int i = 0; i < PREFETCH; ++i) nb[i * PANEL + tid] = pre[i];
    }
    __syncthreads();
  }
}

// forward epilogue: var_part[i] += sum_j (K W)[r_i, n_j] * K[r_i, n_j]
struct VarEpilogue {
  const float* kt;
  int M, lane, warp;
  float var_part[8];

  __device__ __forceinline__ void operator()(int p, float (&g)[8][8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = panel_col(p, lane, j);
      if (n < M) {
        const float4* kn = reinterpret_cast<const float4*>(kt + n * KT_STRIDE + warp * 8);
        const float4 a = kn[0], b = kn[1];
        const float kv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) var_part[i] = fmaf(g[i][j], kv[i], var_part[i]);
      }
    }
  }
};

// backward epilogue: E[r_i, n_j] = (dm_i u_j - 2 dv_i (K W)_ij) K_ij, stored
// to device memory, and summed per row
struct EEpilogue {
  const float* kt;
  const float* __restrict__ u;
  float* emat;
  int M, R, lane, warp, row0;
  float dm[8], dv[8], rowsum[8];

  __device__ __forceinline__ void operator()(int p, float (&g)[8][8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = panel_col(p, lane, j);
      if (n < M) {
        const float4* kn = reinterpret_cast<const float4*>(kt + n * KT_STRIDE + warp * 8);
        const float4 a = kn[0], b = kn[1];
        const float kv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        const float un = __ldg(u + n);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float e = (dm[i] * un - 2.f * dv[i] * g[i][j]) * kv[i];
          rowsum[i] += e;
          const int row = row0 + warp * 8 + i;
          if (row < R) emat[(size_t)row * M + n] = e;
        }
      }
    }
  }
};

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

  // 1. K^T of the tile
  tile_kt(x, zs, inv_ls, os, kt, xt, row0, R, d, M, m_pad);

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

  // 2.-3. var: (K W) panel by panel, each panel's tile met with K
  VarEpilogue epi{kt, M, lane, warp, {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}};
  kw_panels(w, kt, wbuf, M, m_pad, epi);

  float mine = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float s = warp_sum(epi.var_part[i]);
    if (lane == i) mine = s;
  }
  const int row = row0 + warp * 8 + lane;
  if (lane < 8 && row < R) var_out[row] = os - mine;
}

// Backward launch 1: per-row cotangents, per-tile partial sums, K and E.
// part_m: [tile][2][M] = (K^T dmean, colsum E) of the tile;
// part_s: [tile][2d + 3] = (sum dxs o x, sum dmean o x, sum E, sum dvar,
//                           sum dmean) of the tile.
__global__ void __launch_bounds__(THREADS, 1)
fused_gp_bwd_rows_kernel(const float* __restrict__ x,
                         const float* __restrict__ zs,
                         const float* __restrict__ u,
                         const float* __restrict__ w,
                         const float* __restrict__ os_ptr,
                         const float* __restrict__ inv_ls,
                         const float* __restrict__ mean_w,
                         const float* __restrict__ dmean,
                         const float* __restrict__ dvar,
                         float* __restrict__ dx, float* kmat, float* emat,
                         float* __restrict__ part_m,
                         float* __restrict__ part_s, int R, int d, int M,
                         int m_pad) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                     // [m_pad][KT_STRIDE]  K^T, then E^T
  float* xt = kt + m_pad * KT_STRIDE;   // [d][TR]             scaled x^T
  float* wbuf = xt + d * TR;            // [2][BK][PANEL]      W chunks
  float* sd = wbuf + 2 * BK * PANEL;    // [TR][d]             dxs of the tile
  float* dm_s = sd + TR * d;            // [TR]
  float* dv_s = dm_s + TR;              // [TR]
  float* rse_s = dv_s + TR;             // [TR]                rowsum(E)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int row0 = tile * TR;
  const float os = *os_ptr;

  if (tid < TR) {
    const int row = row0 + tid;
    dm_s[tid] = row < R ? dmean[row] : 0.f;  // tail rows: zero cotangents
    dv_s[tid] = row < R ? dvar[row] : 0.f;
  }
  tile_kt(x, zs, inv_ls, os, kt, xt, row0, R, d, M, m_pad);

  // K to device memory, and the tile's K^T dmean
  for (int m = tid; m < M; m += THREADS) {
    const float* ktm = kt + m * KT_STRIDE;
    float acc = 0.f;
#pragma unroll 16
    for (int r = 0; r < TR; ++r) {
      acc = fmaf(ktm[r], dm_s[r], acc);
      const int row = row0 + r;
      if (row < R) kmat[(size_t)row * M + m] = ktm[r];
    }
    part_m[((size_t)tile * 2 + 0) * M + m] = acc;
  }

  // E panel by panel
  EEpilogue epi;
  epi.kt = kt; epi.u = u; epi.emat = emat;
  epi.M = M; epi.R = R; epi.lane = lane; epi.warp = warp; epi.row0 = row0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    epi.dm[i] = dm_s[warp * 8 + i];
    epi.dv[i] = dv_s[warp * 8 + i];
    epi.rowsum[i] = 0.f;
  }
  kw_panels(w, kt, wbuf, M, m_pad, epi);  // ends with __syncthreads()
  {
    float mine = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float s = warp_sum(epi.rowsum[i]);
      if (lane == i) mine = s;
    }
    if (lane < 8) rse_s[warp * 8 + lane] = mine;
  }

  // E^T of the tile back into the K^T buffer (this block's own writes,
  // visible after the barrier), and the tile's colsum(E)
  __syncthreads();
  for (int m = tid; m < m_pad; m += THREADS) {
    float* ktm = kt + m * KT_STRIDE;
    float acc = 0.f;
#pragma unroll 16  // independent loads in flight together
    for (int r = 0; r < TR; ++r) {
      const int row = row0 + r;
      const float e = (m < M && row < R) ? emat[(size_t)row * M + m] : 0.f;
      ktm[r] = e;
      acc += e;
    }
    if (m < M) part_m[((size_t)tile * 2 + 1) * M + m] = acc;
  }
  __syncthreads();

  // dxs[r, k] = sum_m E[r, m] zs[m, k] - rowsum(E)[r] xs[r, k]; thread
  // (r, g) takes row r and columns g*8.. of each 32-column group
  {
    const int r = tid & (TR - 1);
    const int grp = tid >> 6;  // 0..3
    const int row = row0 + r;
    for (int k0 = grp * 8; k0 < d; k0 += 32) {
      const int nk = min(8, d - k0);
      float acc[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc[jj] = 0.f;
      if (nk == 8 && (d & 3) == 0 && ((size_t)zs & 15) == 0) {  // float4
        for (int m = 0; m < M; ++m) {
          const float e = kt[m * KT_STRIDE + r];
          const float4* zm = reinterpret_cast<const float4*>(zs + (size_t)m * d + k0);
          const float4 za = __ldg(zm), zb = __ldg(zm + 1);
          acc[0] = fmaf(e, za.x, acc[0]); acc[1] = fmaf(e, za.y, acc[1]);
          acc[2] = fmaf(e, za.z, acc[2]); acc[3] = fmaf(e, za.w, acc[3]);
          acc[4] = fmaf(e, zb.x, acc[4]); acc[5] = fmaf(e, zb.y, acc[5]);
          acc[6] = fmaf(e, zb.z, acc[6]); acc[7] = fmaf(e, zb.w, acc[7]);
        }
      } else {
        for (int m = 0; m < M; ++m) {
          const float e = kt[m * KT_STRIDE + r];
          const float* zm = zs + (size_t)m * d + k0;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            if (jj < nk) acc[jj] = fmaf(e, __ldg(zm + jj), acc[jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (jj < nk) {
          const int k = k0 + jj;
          const float dxs = acc[jj] - rse_s[r] * xt[k * TR + r];
          sd[r * d + k] = dxs;
          if (row < R) dx[(size_t)row * d + k] = fmaf(dxs, inv_ls[k], dm_s[r] * mean_w[k]);
        }
      }
    }
  }
  __syncthreads();

  // the tile's scalar sums
  const int ns = 2 * d + 3;
  for (int q = tid; q < ns; q += THREADS) {
    float acc = 0.f;
    if (q < 2 * d) {
      const int k = q < d ? q : q - d;
#pragma unroll 16
      for (int r = 0; r < TR; ++r) {
        const int row = row0 + r;
        if (row < R) {
          const float xv = x[(size_t)row * d + k];
          acc = fmaf(q < d ? sd[r * d + k] : dm_s[r], xv, acc);
        }
      }
    } else {
      const float* src = q == 2 * d ? rse_s : (q == 2 * d + 1 ? dv_s : dm_s);
      for (int r = 0; r < TR; ++r) acc += src[r];
    }
    part_s[(size_t)tile * ns + q] = acc;
  }
}

template <int N>
__device__ __forceinline__ void frag(const float* p, float (&out)[N]) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

// Backward launches 2 and 3: for row range s of `rows_per` rows,
//   part[s, m, n] = sum_r A[r, m] * (rw ? rw[r] : 1) * B[r, n]
// with A (R, Mdim) and B (R, Ndim) row-major.  256 threads as 16 x 16; a
// block owns a (16 TM) x (16 TN) output tile and a thread a TM x TN register
// tile (rows ty*TM/2.. and BM/2 + ty*TM/2.., columns likewise).  Row chunks
// of CK stream through two shared-memory buffers: the next chunk's loads are
// in flight in registers while the current one is multiplied.  SYM (A = B,
// the product symmetric): blockIdx.x enumerates only the tiles on and above
// the diagonal, and the reduction reads the others transposed.
template <int TM, int TN, bool SYM>
__global__ void __launch_bounds__(THREADS)
fused_gp_bwd_cols_kernel(const float* A, const float* B,
                         const float* __restrict__ rw,
                         float* __restrict__ part, int R, int Mdim, int Ndim,
                         int rows_per) {
  constexpr int BM = 16 * TM;
  constexpr int BN = 16 * TN;
  constexpr int HM = TM / 2;
  constexpr int HN = TN / 2;
  constexpr int LA = (CK * BM + THREADS - 1) / THREADS;
  constexpr int LB = (CK * BN + THREADS - 1) / THREADS;
  __shared__ __align__(16) float as[2][CK][BM];
  __shared__ __align__(16) float bs[2][CK][BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  int bm = blockIdx.y, bn = blockIdx.x;
  if (SYM) {  // the t-th tile of the upper triangle, row by row
    const int nt = (Ndim + BN - 1) / BN;
    int t = blockIdx.x, len = nt;
    bm = 0;
    while (t >= len) { t -= len; ++bm; --len; }
    bn = bm + t;
  }
  const int m0 = bm * BM;
  const int n0 = bn * BN;
  const int s = blockIdx.z;
  const int r0 = s * rows_per;
  const int r1 = min(R, r0 + rows_per);

  float pa[LA], pb[LB];
  auto fetch = [&](int rc) {
#pragma unroll
    for (int c = 0; c < LA; ++c) {
      const int i = tid + c * THREADS;
      const int rr = i / BM;
      const int r = rc + rr;
      const int m = m0 + (i - rr * BM);
      float a = 0.f;
      if (i < CK * BM && r < r1 && m < Mdim) {
        a = A[(size_t)r * Mdim + m];
        if (rw != nullptr) a *= rw[r];
      }
      pa[c] = a;
    }
#pragma unroll
    for (int c = 0; c < LB; ++c) {
      const int i = tid + c * THREADS;
      const int rr = i / BN;
      const int r = rc + rr;
      const int n = n0 + (i - rr * BN);
      pb[c] = (i < CK * BN && r < r1 && n < Ndim) ? B[(size_t)r * Ndim + n] : 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int c = 0; c < LA; ++c) {
      const int i = tid + c * THREADS;
      if (i < CK * BM) as[buf][i / BM][i % BM] = pa[c];
    }
#pragma unroll
    for (int c = 0; c < LB; ++c) {
      const int i = tid + c * THREADS;
      if (i < CK * BN) bs[buf][i / BN][i % BN] = pb[c];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  fetch(r0);
  stash(0);
  __syncthreads();
  int buf = 0;
  for (int rc = r0; rc < r1; rc += CK) {
    const bool more = rc + CK < r1;
    if (more) fetch(rc + CK);
#pragma unroll
    for (int kk = 0; kk < CK; ++kk) {
      float a[TM], b[TN];
      float lo[HM], hi[HM], bl[HN], bh[HN];
      frag<HM>(&as[buf][kk][ty * HM], lo);
      frag<HM>(&as[buf][kk][BM / 2 + ty * HM], hi);
      frag<HN>(&bs[buf][kk][tx * HN], bl);
      frag<HN>(&bs[buf][kk][BN / 2 + tx * HN], bh);
#pragma unroll
      for (int i = 0; i < HM; ++i) { a[i] = lo[i]; a[HM + i] = hi[i]; }
#pragma unroll
      for (int j = 0; j < HN; ++j) { b[j] = bl[j]; b[HN + j] = bh[j]; }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  float* out = part + (size_t)s * Mdim * Ndim;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i < HM ? ty * HM + i : BM / 2 + ty * HM + (i - HM));
    if (m >= Mdim) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j < HN ? tx * HN + j : BN / 2 + tx * HN + (j - HN));
      if (n < Ndim) out[(size_t)m * Ndim + n] = acc[i][j];
    }
  }
}

// Backward launch 4: fixed-order sums of every partial.  Blocks 0..M-1 own
// inducing point m (du, dzs row, dW row); blocks M.. own one scalar output
// each: dinv_ls[k], dmean_w[k], dos, dmean_b.
__global__ void __launch_bounds__(THREADS)
fused_gp_bwd_reduce_kernel(const float* __restrict__ part_m,
                           const float* __restrict__ part_s,
                           const float* __restrict__ pw,
                           const float* __restrict__ pz,
                           const float* __restrict__ zs,
                           const float* __restrict__ inv_ls,
                           const float* __restrict__ os_ptr,
                           float* __restrict__ dzs, float* __restrict__ du,
                           float* __restrict__ dw, float* __restrict__ dos,
                           float* __restrict__ dinv_ls,
                           float* __restrict__ dmean_w,
                           float* __restrict__ dmean_b, int n_tiles, int d,
                           int M, int s_w, int s_z) {
  __shared__ float red[THREADS / 32];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  if (b < M) {
    const int m = b;
    float a = 0.f, c = 0.f;
    for (int t = tid; t < n_tiles; t += THREADS) {
      a += part_m[((size_t)t * 2 + 0) * M + m];
      c += part_m[((size_t)t * 2 + 1) * M + m];
    }
    a = block_sum(a, red);
    c = block_sum(c, red);  // colsum(E)[m]
    if (tid == 0) du[m] = a;
    for (int k = tid; k < d; k += THREADS) {
      float e = 0.f;
      for (int s = 0; s < s_z; ++s) e += pz[((size_t)s * M + m) * d + k];
      dzs[(size_t)m * d + k] = e * inv_ls[k] - c * zs[(size_t)m * d + k];
    }
    // dW is symmetric and only the tiles on and above the diagonal were
    // computed: below it, read the mirror element
    for (int n = tid; n < M; n += THREADS) {
      const bool upper = m / DW_TILE <= n / DW_TILE;
      const size_t at = upper ? (size_t)m * M + n : (size_t)n * M + m;
      float e = 0.f;
      for (int s = 0; s < s_w; ++s) e += pw[(size_t)s * M * M + at];
      dw[(size_t)m * M + n] = -e;
    }
    return;
  }
  const int q = b - M;
  const int ns = 2 * d + 3;
  float a = 0.f, c = 0.f;
  const int qa = q < 2 * d ? q : (q == 2 * d ? 2 * d : 2 * d + 2);
  for (int t = tid; t < n_tiles; t += THREADS) {
    a += part_s[(size_t)t * ns + qa];
    if (q == 2 * d) c += part_s[(size_t)t * ns + 2 * d + 1];
  }
  a = block_sum(a, red);
  if (q == 2 * d) c = block_sum(c, red);
  if (tid != 0) return;
  if (q < d) dinv_ls[q] = a;
  else if (q < 2 * d) dmean_w[q - d] = a;
  else if (q == 2 * d) *dos = a / *os_ptr + c;
  else *dmean_b = a;
}

struct BwdPlan {
  int n_tiles, m_pad, s_w, rows_w, s_z, rows_z;
  long long kmat, emat, part_m, part_s, pw, pz, total;  // scratch offsets
};

// splits over rows so that each column product fills one wave of at most
// TARGET_BLOCKS blocks (rounding up would start a second, nearly empty wave)
__host__ void split_rows(int R, int tiles, int& s, int& rows_per) {
  s = TARGET_BLOCKS / tiles;
  const int max_s = (R + CK - 1) / CK;
  if (s > max_s) s = max_s;
  if (s < 1) s = 1;
  rows_per = (R + s - 1) / s;
  rows_per = (rows_per + CK - 1) / CK * CK;
  s = (R + rows_per - 1) / rows_per;
}

__host__ BwdPlan plan(int R, int d, int M) {
  BwdPlan p;
  p.n_tiles = (R + TR - 1) / TR;
  p.m_pad = (M + BK - 1) / BK * BK;
  const int mt = (M + CBM - 1) / CBM;
  const int nt = (M + DW_TILE - 1) / DW_TILE;
  split_rows(R, nt * (nt + 1) / 2, p.s_w, p.rows_w);
  split_rows(R, mt * ((d + 31) / 32), p.s_z, p.rows_z);
  long long o = 0;
  p.kmat = o; o += (long long)R * M;
  p.emat = o; o += (long long)R * M;
  p.part_m = o; o += (long long)p.n_tiles * 2 * M;
  p.part_s = o; o += (long long)p.n_tiles * (2 * d + 3);
  p.pw = o; o += (long long)p.s_w * M * M;
  p.pz = o; o += (long long)p.s_z * M * d;
  p.total = o;
  return p;
}

}  // namespace

extern "C" {

// Shared memory the forward launch needs, in bytes (the wrapper checks it
// against the card's per-block limit before launching).
long long fused_gp_fwd_smem_bytes(int d, int M) {
  const long long m_pad = (M + BK - 1) / BK * BK;
  return (m_pad * KT_STRIDE + (long long)d * TR + 2LL * BK * PANEL) * (long long)sizeof(float);
}

// Shared memory of the backward's row launch, in bytes.
long long fused_gp_bwd_smem_bytes(int d, int M) {
  return fused_gp_fwd_smem_bytes(d, M) + ((long long)TR * d + 3LL * TR) * (long long)sizeof(float);
}

// Floats of device scratch the backward needs (the wrapper allocates it).
long long fused_gp_bwd_scratch_floats(int R, int d, int M) {
  return plan(R, d, M).total;
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

// The VJP.  Inputs as the forward's, plus dmean, dvar (R,); outputs dx
// (R, d), dzs (M, d), du (M,), dw (M, M), and device scalars / vectors dos,
// dinv_ls (d,), dmean_w (d,), dmean_b; scratch of
// fused_gp_bwd_scratch_floats(R, d, M) floats.  Four launches on `stream`;
// returns the first failure.
int fused_gp_bwd(const float* x, const float* zs, const float* u, const float* w,
                 const float* os, const float* inv_ls, const float* mean_w,
                 const float* dmean, const float* dvar, float* dx, float* dzs,
                 float* du, float* dw, float* dos, float* dinv_ls,
                 float* dmean_w, float* dmean_b, float* scratch, int R, int d,
                 int M, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const BwdPlan p = plan(R, d, M);
  float* kmat = scratch + p.kmat;
  float* emat = scratch + p.emat;
  float* part_m = scratch + p.part_m;
  float* part_s = scratch + p.part_s;
  float* pw = scratch + p.pw;
  float* pz = scratch + p.pz;

  const int smem = (int)fused_gp_bwd_smem_bytes(d, M);
  cudaError_t err = cudaFuncSetAttribute(
      fused_gp_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_gp_bwd_rows_kernel<<<p.n_tiles, THREADS, smem, st>>>(
      x, zs, u, w, os, inv_ls, mean_w, dmean, dvar, dx, kmat, emat, part_m,
      part_s, R, d, M, p.m_pad);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int mt = (M + CBM - 1) / CBM;
  const int nt = (M + DW_TILE - 1) / DW_TILE;
  fused_gp_bwd_cols_kernel<8, 8, true><<<dim3(nt * (nt + 1) / 2, 1, p.s_w), THREADS, 0, st>>>(
      kmat, kmat, dvar, pw, R, M, M, p.rows_w);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fused_gp_bwd_cols_kernel<8, 2, false><<<dim3((d + 31) / 32, mt, p.s_z), THREADS, 0, st>>>(
      emat, x, nullptr, pz, R, M, d, p.rows_z);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  fused_gp_bwd_reduce_kernel<<<M + 2 * d + 2, THREADS, 0, st>>>(
      part_m, part_s, pw, pz, zs, inv_ls, os, dzs, du, dw, dos, dinv_ls,
      dmean_w, dmean_b, p.n_tiles, d, M, p.s_w, p.s_z);
  return (int)cudaGetLastError();
}

}  // extern "C"
