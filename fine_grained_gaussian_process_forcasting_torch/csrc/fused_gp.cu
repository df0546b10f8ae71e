// Fused whitened-GP marginals, forward and backward, affine, fp32 and bf16
// -- for sm_90a.
//
// Replaces: fine_grained_gaussian_process_forcasting_tpu/ops/pallas/fused_gp.py
//   `_fwd_kernel` and `_bwd_kernel` with affine=True, bf16=False (reached
//   through `whitened_marginals_affine`, `_forward` and `_bwd_rule`) and
//   bf16=True (`whitened_marginals_affine_bf16`).
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
// The bf16 variant means what the Pallas body means by it: only the two
// products K W and K^T (dvar o K) take inputs rounded to bf16, summed in
// fp32; the distance, the exponential, E, E zs, E^T x, every sum and every
// output stay fp32.
//
// What bounds it on an H100: arithmetic.  In fp32 the (K W) product is
// 2*M*M flops per row and the distance 3*M*d, all on the CUDA cores
// (67 TFLOP/s peak; the 2e-5 parity rules out TF32).  At the flagship (73,728
// rows, d 32, M 512) K W is 39 GFLOP, ~0.6 ms; at the production width
// (40,960 rows, d 512, M 512) the distance (32 GFLOP) outweighs it.  In the
// bf16 forward the K W product moves to the tensor cores
// (`mma.sync.m16n8k16`, 989 TFLOP/s peak) and the fp32 distance is what
// remains; the bf16 backward puts every product there (see its section).
// The bytes (x in, two vectors out, W once) take microseconds.
//
// Forward design: one block of 256 threads per tile of 64 rows.  The TPU
// kernel held a 2048-row tile, all of W and the (tile, M) K in VMEM and
// shrank the row tile for wide d; here W alone (1 MiB at M=512) exceeds a
// block's shared memory, so
//   1. the tile's K is computed once into shared memory, transposed
//      (K^T, M x 64, 136 KB at M=512), with the direct difference
//      |xs - zs|^2 (no cancellation, never negative).  x and zs stream
//      through shared memory 16 columns of d at a time while each thread
//      keeps the 64 partial distances of its inducing point in registers,
//      so the shared memory a block needs does not grow with d;
//   2. fp32: W streams through shared memory in 16 x 256 chunks,
//      double-buffered through registers, and each thread accumulates an
//      8 x 8 register tile of K W (warp w owns rows 8w..8w+7, lane c owns
//      columns 4c..4c+3 and 128+4c..128+4c+3 of each 256-column panel);
//      bf16: each warp owns the 64 rows x 32 columns of a panel as 4 x 4
//      `mma` tiles, K rounded to bf16 as it leaves shared memory, W^T read
//      as bf16 pairs from device memory (cast and transposed once per call
//      by the wrapper; 512 KB, resident in L2);
//   3. at the end of each panel the accumulators are multiplied by K and
//      summed into per-row partial variances.  K and K W never reach device
//      memory.
// Rows past the end are zero inputs whose results are never stored (no
// padding in device memory).  K^T over all of M fits a block up to M 720;
// beyond, the chunked kernels further down hold one chunk of 512 inducing
// points and recompute K^T chunk by chunk for each panel (the wrapper's
// `layout` picks the chunk and passes it to the launchers).
//
// Backward design.  The Pallas backward sums the parameter cotangents across
// its grid with init-at-step-0-then-add, which is right only on the TPU's
// sequential grid; CUDA blocks run concurrently and in no order.  The port
// instead splits the work so that every sum over rows is taken by one thread
// in a fixed order -- no atomics, so the gradients are equal bit for bit
// from run to run.  The bf16 backward is the `wgmma` design at the end of
// this file; the fp32 one runs in four launches:
//   1. rows (as the forward, one block per 64-row tile): recompute K^T into
//      shared memory and (K W) panel by panel; at each panel's end form E in
//      registers.  Per row: rowsum(E), then dxs = E zs - rowsum(E) xs from an
//      E^T tile re-read into the K^T buffer (d <= 64: a row and 8 columns
//      per thread; wider: the product is as large as K W and runs through
//      the same register-tiled panels, zs streamed like W), x re-read from
//      device memory, and dx.  Per tile: partial du = K^T dmean and colsum(E) (M each) and the
//      partial scalar sums.  K and E are written to device memory (R x M
//      floats each) for the two column products: those bytes take ~0.1 ms
//      at 3.35 TB/s, where recomputing K inside a tiled product would cost
//      one exponential and 2d flops per element for every output tile.
//   2. dW partials: (K^T diag(dvar) K) over S contiguous row ranges, one
//      (S, M, M) slab: a 128 x 128 output tile per block with an 8 x 8
//      register tile per thread; dW is symmetric, so only the tiles on and
//      above the diagonal are computed (10 of 16 at M = 512);
//   3. dzs partials: E^T x over row ranges the same way, (S', M, d);
//   4. a reduction that sums the partials in a fixed order and applies the
//      column terms: dW, du, dzs = inv_ls o (E^T x) - colsum(E) o zs, and
//      the scalars.
// Tail rows are masked as in the forward: their cotangents count as zero and
// nothing is written for them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int TR = 64;             // rows per block
constexpr int THREADS = 256;       // 8 warps x 8 rows
constexpr int PANEL = 256;         // W columns per panel
constexpr int BK = 16;             // W rows per shared-memory chunk
constexpr int KT_STRIDE = TR + 4;  // padded K^T row, keeps float4 alignment
constexpr int PREFETCH = BK * PANEL / THREADS;  // 16 W values per thread
constexpr int WBUF = 2 * BK * PANEL;            // floats of the W buffers

// distance staging (aliases the W buffers, which are idle until K is done)
constexpr int DC = 16;             // columns of d per chunk
constexpr int XC_STRIDE = TR + 4;  // x chunk [DC][XC_STRIDE]
constexpr int ZC_STRIDE = DC + 1;  // zs chunk [THREADS][ZC_STRIDE]
static_assert(DC * XC_STRIDE + THREADS * ZC_STRIDE <= WBUF, "staging fits");

// column products (launches 2 and 3)
constexpr int CK = 8;              // rows per shared-memory chunk
constexpr int CBM = 128;           // output rows (m) per block
constexpr int DW_TILE = 128;       // dW output tile: 16 x 8 per side
constexpr int TARGET_BLOCKS = 264; // two blocks per SM on 132 SMs
constexpr int SMALL_D = 64;        // up to here dxs is taken row by row

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
// of the (M, ncols) row-major W
__device__ __forceinline__ void load_w_chunk(const float* __restrict__ w, int M,
                                             int ncols, int n_chunks, int c,
                                             int tid, float (&regs)[PREFETCH]) {
  const int p = c / n_chunks;
  const int k0 = (c - p * n_chunks) * BK;
  const int n = p * PANEL + tid;
#pragma unroll
  for (int i = 0; i < PREFETCH; ++i) {
    const int k = k0 + i;
    regs[i] = (k < M && n < ncols) ? __ldg(w + (size_t)k * ncols + n) : 0.f;
  }
}

// K^T of the tile into kt [m_pad][KT_STRIDE] (columns m >= M are zeros, rows
// past R are those of a zero x).  `stage` is WBUF floats of scratch: chunks
// of DC columns of the scaled x^T and of zs pass through it.
__device__ __forceinline__ void tile_kt(const float* __restrict__ x,
                                        const float* __restrict__ zs,
                                        const float* __restrict__ inv_ls,
                                        float os, float* kt, float* stage,
                                        int row0, int R, int d, int M,
                                        int m_pad) {
  const int tid = threadIdx.x;
  float* xc = stage;                   // [DC][XC_STRIDE]
  float* zc = stage + DC * XC_STRIDE;  // [THREADS][ZC_STRIDE]

  // thread owns whole columns m, rows accumulate in registers
  for (int mb = 0; mb < m_pad; mb += THREADS) {
    const int m = mb + tid;
    float d2[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) d2[r] = 0.f;
    for (int k0 = 0; k0 < d; k0 += DC) {
      __syncthreads();  // the previous chunk is consumed
      for (int i = tid; i < TR * DC; i += THREADS) {
        const int r = i / DC;
        const int k = i - r * DC;
        const int row = row0 + r;
        const int kk = k0 + k;
        xc[k * XC_STRIDE + r] =
            (row < R && kk < d) ? x[(size_t)row * d + kk] * inv_ls[kk] : 0.f;
      }
      for (int i = tid; i < THREADS * DC; i += THREADS) {
        const int mm = i / DC;
        const int k = i - mm * DC;
        const int kk = k0 + k;
        zc[mm * ZC_STRIDE + k] =
            (mb + mm < M && kk < d) ? __ldg(zs + (size_t)(mb + mm) * d + kk) : 0.f;
      }
      __syncthreads();
      if (m < M) {
        const float* zr = zc + tid * ZC_STRIDE;
#pragma unroll
        for (int k = 0; k < DC; ++k) {  // columns past d hold zeros in both
          const float z = zr[k];
          const float4* xk = reinterpret_cast<const float4*>(xc + k * XC_STRIDE);
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
      }
    }
    if (m < m_pad) {
      float4* ktm = reinterpret_cast<float4*>(kt + m * KT_STRIDE);
#pragma unroll
      for (int r4 = 0; r4 < TR / 4; ++r4) {
        ktm[r4] = m < M ? make_float4(os * expf(-0.5f * d2[4 * r4 + 0]),
                                      os * expf(-0.5f * d2[4 * r4 + 1]),
                                      os * expf(-0.5f * d2[4 * r4 + 2]),
                                      os * expf(-0.5f * d2[4 * r4 + 3]))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
  __syncthreads();
}

// column of the thread's register tile j within panel p
__device__ __forceinline__ int panel_col(int p, int lane, int j) {
  return p * PANEL + (j < 4 ? 4 * lane + j : PANEL / 2 + 4 * lane + (j - 4));
}

// fp32 (K W) of the tile, panel by panel, for the (M, ncols) row-major W
// streamed through shared memory and K^T in kt; at the end of panel p calls
// epi(p, g) with the thread's 8 x 8 tile g of
// (K W)[8 warp + i, panel_col(p, lane, j)], then zeroes g.
template <class Epilogue>
__device__ __forceinline__ void kw_panels(const float* __restrict__ w,
                                          const float* kt, float* wbuf, int M,
                                          int m_pad, int ncols, Epilogue& epi) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_panels = (ncols + PANEL - 1) / PANEL;
  const int n_chunks = m_pad / BK;
  const int total = n_panels * n_chunks;

  float g[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) g[i][j] = 0.f;

  float pre[PREFETCH];
  load_w_chunk(w, M, ncols, n_chunks, 0, tid, pre);
#pragma unroll
  for (int i = 0; i < PREFETCH; ++i) wbuf[i * PANEL + tid] = pre[i];
  __syncthreads();

  for (int c = 0; c < total; ++c) {
    const int p = c / n_chunks;
    const int kc = c - p * n_chunks;
    if (c + 1 < total) load_w_chunk(w, M, ncols, n_chunks, c + 1, tid, pre);

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

// bf16 (K W) of the tile on the tensor cores.  wt is W^T in bf16,
// (n_panels * PANEL) x m_pad, zero-padded: wt[n][k] = bf16(W[k][n]).  Warp w
// owns the 64 rows x 32 columns [32 w, 32 w + 32) of each panel as 4 x 4
// `mma` tiles; K leaves shared memory as fp32 and is rounded to bf16 on the
// way into the A fragments.  At the end of each panel calls
// epi(n0, c) with c[mt][nt] the tile of rows 16 mt.. and columns
// n0 + 8 nt.. (the `mma` accumulator layout).
template <class Epilogue>
__device__ __forceinline__ void kw_panels_mma(const __nv_bfloat16* __restrict__ wt,
                                              const float* kt, int M, int m_pad,
                                              Epilogue& epi) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_panels = (M + PANEL - 1) / PANEL;

  for (int p = 0; p < n_panels; ++p) {
    const int n0 = p * PANEL + warp * 32;
    if (n0 >= M) continue;  // the whole warp: no column of its own here
    float c[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[mt][nt][e] = 0.f;

    for (int k0 = 0; k0 < m_pad; k0 += 16) {
      const float* kk = kt + (k0 + 2 * t) * KT_STRIDE + g;
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float* km = kk + mt * 16;
        a[mt][0] = pack_bf16(km[0], km[KT_STRIDE]);
        a[mt][1] = pack_bf16(km[8], km[KT_STRIDE + 8]);
        a[mt][2] = pack_bf16(km[8 * KT_STRIDE], km[9 * KT_STRIDE]);
        a[mt][3] = pack_bf16(km[8 * KT_STRIDE + 8], km[9 * KT_STRIDE + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint32_t* wr = reinterpret_cast<const uint32_t*>(
            wt + (size_t)(n0 + nt * 8 + g) * m_pad + k0 + 2 * t);
        const uint32_t b0 = __ldg(wr);
        const uint32_t b1 = __ldg(wr + 4);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_bf16(c[mt][nt], a[mt], b0, b1);
      }
    }
    epi(n0, c);
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

// the same for the `mma` layout: part[2 mt + h] belongs to row 16 mt + 8 h + g
struct VarEpilogueMma {
  const float* kt;
  int M, g, t;
  float part[8];

  __device__ __forceinline__ void operator()(int n0, float (&c)[4][4][4]) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + nt * 8 + 2 * t + e;
        if (n < M) {
          const float* kn = kt + n * KT_STRIDE + g;
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            part[2 * mt] = fmaf(c[mt][nt][e], kn[mt * 16], part[2 * mt]);
            part[2 * mt + 1] = fmaf(c[mt][nt][2 + e], kn[mt * 16 + 8], part[2 * mt + 1]);
          }
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

// epilogue of the wide-d (E zs) product: g is E zs of rows 8 warp + i and
// columns panel_col(p, lane, j) of d.  Writes dx and, per warp, the sums over
// its 8 rows of dxs o x and dmean o x: part[warp][n] and part[warp][d + n].
struct DxEpilogue {
  const float* __restrict__ x;
  const float* __restrict__ inv_ls;
  const float* __restrict__ mean_w;
  float* __restrict__ dx;
  float* __restrict__ part;  // the tile's [8][2 d]
  const float* rse_s;
  const float* dm_s;
  int R, d, lane, warp, row0;

  __device__ __forceinline__ void operator()(int p, float (&g)[8][8]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = panel_col(p, lane, j);
      if (n < d) {
        const float il = inv_ls[n];
        const float mw = mean_w[n];
        float s_dx = 0.f, s_dm = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = warp * 8 + i;
          const int row = row0 + r;
          if (row < R) {
            const float xv = x[(size_t)row * d + n];
            const float dxs = g[i][j] - rse_s[r] * (xv * il);
            dx[(size_t)row * d + n] = fmaf(dxs, il, dm_s[r] * mw);
            s_dx = fmaf(dxs, xv, s_dx);
            s_dm = fmaf(dm_s[r], xv, s_dm);
          }
        }
        part[(size_t)warp * 2 * d + n] = s_dx;
        part[(size_t)warp * 2 * d + d + n] = s_dm;
      }
    }
  }
};

// per-row sums of the `mma` epilogues' partials: over the four lanes that
// share a row, then over the warps in a fixed order; out[r] for r < TR.
// red is 8 x TR floats of shared memory.  Ends with a barrier.
__device__ __forceinline__ void row_sums_mma(float (&part)[8], float* red,
                                             float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = part[i];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (t == 0) red[warp * TR + (i >> 1) * 16 + (i & 1) * 8 + g] = v;
  }
  __syncthreads();
  if (threadIdx.x < TR) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += red[w * TR + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// BF16: w is W^T in bf16 (see kw_panels_mma), else W in fp32, M x M.
template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
fused_gp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ zs,
                    const float* __restrict__ u, const void* __restrict__ w,
                    const float* __restrict__ os_ptr,
                    const float* __restrict__ inv_ls,
                    const float* __restrict__ mean_w,
                    const float* __restrict__ mean_b_ptr,
                    float* __restrict__ mean_out, float* __restrict__ var_out,
                    int R, int d, int M, int m_pad) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                     // [m_pad][KT_STRIDE]  K^T of the tile
  float* wbuf = kt + m_pad * KT_STRIDE; // [2][BK][PANEL] W chunks; staging

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * TR;
  const float os = *os_ptr;

  // 1. K^T of the tile
  tile_kt(x, zs, inv_ls, os, kt, wbuf, row0, R, d, M, m_pad);

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
    // x . mean_w of the warp's rows, lanes stride over d
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + warp * 8 + i;
      if (row < R) {
        const float* xr = x + (size_t)row * d;
        for (int k = lane; k < d; k += 32) acc[i] = fmaf(xr[k], mean_w[k], acc[i]);
      }
    }
    float mine = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float s = warp_sum(acc[i]);
      if (lane == i) mine = s;
    }
    const int row = row0 + warp * 8 + lane;
    if (lane < 8 && row < R) mean_out[row] = *mean_b_ptr + mine;
  }

  // 2.-3. var: (K W) panel by panel, each panel's tile met with K
  if constexpr (BF16) {
    VarEpilogueMma epi{kt, M, lane >> 2, lane & 3,
                       {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}};
    kw_panels_mma(static_cast<const __nv_bfloat16*>(w), kt, M, m_pad, epi);
    float* red = wbuf;             // [8][TR]
    float* sums = wbuf + 8 * TR;   // [TR]
    row_sums_mma(epi.part, red, sums);
    if (tid < TR && row0 + tid < R) var_out[row0 + tid] = os - sums[tid];
  } else {
    VarEpilogue epi{kt, M, lane, warp, {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}};
    kw_panels(static_cast<const float*>(w), kt, wbuf, M, m_pad, M, epi);

    float mine = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float s = warp_sum(epi.var_part[i]);
      if (lane == i) mine = s;
    }
    const int row = row0 + warp * 8 + lane;
    if (lane < 8 && row < R) var_out[row] = os - mine;
  }
}

// Backward launch 1: per-row cotangents, per-tile partial sums, K and E.
// part_m: [tile][2][M] = (K^T dmean, colsum E) of the tile;
// part_s: [tile][slots * 2d + 3]: per slot (a group of the tile's rows: 2
//         at d <= SMALL_D, else 8) (sum dxs o x, sum dmean o x), then
//         (sum E, sum dvar, sum dmean) of the tile.
// kmat: K as (R, M) floats.
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
  float* wbuf = kt + m_pad * KT_STRIDE; // [2][BK][PANEL] W chunks; staging
  float* dm_s = wbuf + WBUF;            // [TR]
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
  tile_kt(x, zs, inv_ls, os, kt, wbuf, row0, R, d, M, m_pad);

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
  {
    EEpilogue epi;
    epi.kt = kt; epi.u = u; epi.emat = emat;
    epi.M = M; epi.R = R; epi.lane = lane; epi.warp = warp; epi.row0 = row0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      epi.dm[i] = dm_s[warp * 8 + i];
      epi.dv[i] = dv_s[warp * 8 + i];
      epi.rowsum[i] = 0.f;
    }
    kw_panels(w, kt, wbuf, M, m_pad, M, epi);  // ends with a barrier
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

  // dxs[r, k] = sum_m E[r, m] zs[m, k] - rowsum(E)[r] xs[r, k], dx, and per
  // slot (a group of the tile's rows) the sums of dxs o x and dmean o x
  const int slots = d > SMALL_D ? 8 : 2;
  float* part_t = part_s + (size_t)tile * (slots * 2 * d + 3);
  if (d > SMALL_D) {
    // wide d: the product is as large as K W; the same register-tiled
    // panels, E^T in the place of K^T and zs (M, d) in the place of W
    DxEpilogue epi{x, inv_ls, mean_w, dx, part_t, rse_s, dm_s, R, d, lane,
                   warp, row0};
    kw_panels(zs, kt, wbuf, M, m_pad, d, epi);
  } else {
    // narrow d: thread (r, grp) takes row r and 8 columns of each
    // 32-column pass; a warp's 32 rows are one slot
    const int r = tid & (TR - 1);
    const int grp = tid >> 6;  // 0..3
    const int row = row0 + r;
    const bool vec = (d & 3) == 0 && ((size_t)zs & 15) == 0;
    for (int kb = 0; kb < d; kb += 32) {
      const int k0 = kb + grp * 8;
      const int nk = min(8, d - k0);  // <= 0: no column of its own
      float acc[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc[jj] = 0.f;
      if (nk == 8 && vec) {
#pragma unroll 4
        for (int m = 0; m < M; ++m) {
          const float e = kt[m * KT_STRIDE + r];
          const float4* zm = reinterpret_cast<const float4*>(zs + (size_t)m * d + k0);
          const float4 za = __ldg(zm), zb = __ldg(zm + 1);
          acc[0] = fmaf(e, za.x, acc[0]); acc[1] = fmaf(e, za.y, acc[1]);
          acc[2] = fmaf(e, za.z, acc[2]); acc[3] = fmaf(e, za.w, acc[3]);
          acc[4] = fmaf(e, zb.x, acc[4]); acc[5] = fmaf(e, zb.y, acc[5]);
          acc[6] = fmaf(e, zb.z, acc[6]); acc[7] = fmaf(e, zb.w, acc[7]);
        }
      } else if (nk > 0) {
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
        float s_dx = 0.f, s_dm = 0.f;
        if (jj < nk && row < R) {
          const int k = k0 + jj;
          const float xv = x[(size_t)row * d + k];
          const float il = inv_ls[k];
          const float dxs = acc[jj] - rse_s[r] * (xv * il);
          dx[(size_t)row * d + k] = fmaf(dxs, il, dm_s[r] * mean_w[k]);
          s_dx = dxs * xv;
          s_dm = dm_s[r] * xv;
        }
        s_dx = warp_sum(s_dx);
        s_dm = warp_sum(s_dm);
        if (lane == 0 && jj < nk) {
          part_t[(size_t)(warp & 1) * 2 * d + k0 + jj] = s_dx;
          part_t[(size_t)(warp & 1) * 2 * d + d + k0 + jj] = s_dm;
        }
      }
    }
  }
  // the tile's scalar sums
  if (tid < 3) {
    const float* src = tid == 0 ? rse_s : (tid == 1 ? dv_s : dm_s);
    float acc = 0.f;
    for (int r = 0; r < TR; ++r) acc += src[r];
    part_t[slots * 2 * d + tid] = acc;
  }
}

// ------------------------------------------------ M in chunks (M > 720) --
//
// At M > 720 the tile's K^T over all of M (m_pad x 68 floats) no longer fits
// a block's shared memory.  The chunked kernels below hold K^T for one
// chunk of `chunk` inducing points (a multiple of the 256-column panel) and
// recompute it as the panels need it: for each panel p of W's columns, the
// chunks are computed in turn, each multiplied into the panel's register
// tile, the chunk that holds the panel's own columns last, so that the
// panel's epilogue finds K[r, n] of its columns in shared memory.  K is
// computed n_panels times instead of once: 3 M d flops a row per panel
// against the panel's 512 M of K W, d / 170 of the product.  Rows, warps
// and register tiles are those of the single-pass kernels above.

// W rows k0.. (of `rows`) and columns n0 + tid of the row-major (rows,
// ncols) w into registers
__device__ __forceinline__ void load_w_rows(const float* __restrict__ w,
                                            int rows, int ncols, int k0,
                                            int n0, int tid,
                                            float (&regs)[PREFETCH]) {
  const int n = n0 + tid;
#pragma unroll
  for (int i = 0; i < PREFETCH; ++i) {
    const int k = k0 + i;
    regs[i] = (k < rows && n < ncols) ? __ldg(w + (size_t)k * ncols + n) : 0.f;
  }
}

// g += the fp32 (K W) tile of panel p over the chunk's rows: kt holds K^T
// of the chunk (rows_pad rows, zeros past `rows`), w the chunk's W rows.
// Begins and ends with a barrier.
__device__ __forceinline__ void kw_panel_rows(const float* __restrict__ w,
                                              const float* kt, float* wbuf,
                                              int rows, int rows_pad,
                                              int ncols, int p,
                                              float (&g)[8][8]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_chunks = rows_pad / BK;
  float pre[PREFETCH];
  load_w_rows(w, rows, ncols, 0, p * PANEL, tid, pre);
  __syncthreads();  // wbuf is free
#pragma unroll
  for (int i = 0; i < PREFETCH; ++i) wbuf[i * PANEL + tid] = pre[i];
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) load_w_rows(w, rows, ncols, (c + 1) * BK, p * PANEL, tid, pre);
    const float* wb = wbuf + (c & 1) * (BK * PANEL);
    const float* ktk = kt + c * BK * KT_STRIDE + warp * 8;
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
    if (c + 1 < n_chunks) {
      float* nb = wbuf + ((c + 1) & 1) * (BK * PANEL);
#pragma unroll
      for (int i = 0; i < PREFETCH; ++i) nb[i * PANEL + tid] = pre[i];
    }
    __syncthreads();
  }
}

// c += the bf16 (K W) tile of the warp's 32 columns n0.. over the chunk's
// rows k_lo.. (rows_pad of them; kt holds their K^T); wt as kw_panels_mma's,
// wt_cols columns
__device__ __forceinline__ void kw_panel_rows_mma(const __nv_bfloat16* __restrict__ wt,
                                                  int wt_cols, const float* kt,
                                                  int k_lo, int rows_pad, int n0,
                                                  float (&c)[4][4][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  for (int k0 = 0; k0 < rows_pad; k0 += 16) {
    const float* kk = kt + (k0 + 2 * t) * KT_STRIDE + g;
    uint32_t a[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const float* km = kk + mt * 16;
      a[mt][0] = pack_bf16(km[0], km[KT_STRIDE]);
      a[mt][1] = pack_bf16(km[8], km[KT_STRIDE + 8]);
      a[mt][2] = pack_bf16(km[8 * KT_STRIDE], km[9 * KT_STRIDE]);
      a[mt][3] = pack_bf16(km[8 * KT_STRIDE + 8], km[9 * KT_STRIDE + 8]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const uint32_t* wr = reinterpret_cast<const uint32_t*>(
          wt + (size_t)(n0 + nt * 8 + g) * wt_cols + k_lo + k0 + 2 * t);
      const uint32_t b0 = __ldg(wr);
      const uint32_t b1 = __ldg(wr + 4);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) mma_bf16(c[mt][nt], a[mt], b0, b1);
    }
  }
}

// chunk i of panel p's sweep: all chunks, the one holding the panel's
// columns last
__device__ __forceinline__ int sweep_chunk(int p, int i, int chunk, int n_chunks) {
  return ((p * PANEL) / chunk + 1 + i) % n_chunks;
}

__device__ __forceinline__ int pad16(int n) { return (n + BK - 1) / BK * BK; }

// For each panel p (n_panels of them over M columns) computes K^T chunk by
// chunk into kt and calls on_chunk(p, lo, cnt, cnt_pad) after each; then
// epilogue(p, home_lo) with the panel's home chunk in kt.
template <class OnChunk, class Epilogue>
__device__ __forceinline__ void chunked_sweeps(const float* __restrict__ x,
                                               const float* __restrict__ zs,
                                               const float* __restrict__ inv_ls,
                                               float os, float* kt, float* wbuf,
                                               int row0, int R, int d, int M,
                                               int chunk, OnChunk& on_chunk,
                                               Epilogue& epilogue) {
  const int n_chunks = (M + chunk - 1) / chunk;
  const int n_panels = (M + PANEL - 1) / PANEL;
  for (int p = 0; p < n_panels; ++p) {
    for (int i = 0; i < n_chunks; ++i) {
      const int lo = sweep_chunk(p, i, chunk, n_chunks) * chunk;
      const int cnt = min(chunk, M - lo);
      tile_kt(x, zs + (size_t)lo * d, inv_ls, os, kt, wbuf, row0, R, d, cnt,
              pad16(cnt));
      on_chunk(p, lo, cnt, pad16(cnt));
    }
    epilogue(p, (p * PANEL) / chunk * chunk);
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
fused_gp_fwd_chunked_kernel(const float* __restrict__ x,
                            const float* __restrict__ zs,
                            const float* __restrict__ u,
                            const void* __restrict__ w,
                            const float* __restrict__ os_ptr,
                            const float* __restrict__ inv_ls,
                            const float* __restrict__ mean_w,
                            const float* __restrict__ mean_b_ptr,
                            float* __restrict__ mean_out,
                            float* __restrict__ var_out, int R, int d, int M,
                            int m_pad, int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                      // [chunk][KT_STRIDE]
  float* wbuf = kt + chunk * KT_STRIDE;  // [2][BK][PANEL]; staging

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * TR;
  const float os = *os_ptr;

  float macc[8];  // K u of the warp's 8 rows, this lane's share
#pragma unroll
  for (int i = 0; i < 8; ++i) macc[i] = 0.f;
  float g[8][8];
  float c[4][4][4];
  VarEpilogue epi{kt, M, lane, warp, {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}};
  VarEpilogueMma epi16{kt, M, lane >> 2, lane & 3,
                       {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}};

  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) g[i][j] = 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[mt][nt][e] = 0.f;
  };
  zero();
  auto on_chunk = [&](int p, int lo, int cnt, int cnt_pad) {
    if (p == 0) {
      for (int m = lane; m < cnt; m += 32) {
        const float um = __ldg(u + lo + m);
        const float4* km = reinterpret_cast<const float4*>(kt + m * KT_STRIDE + warp * 8);
        const float4 a = km[0], b = km[1];
        macc[0] = fmaf(a.x, um, macc[0]); macc[1] = fmaf(a.y, um, macc[1]);
        macc[2] = fmaf(a.z, um, macc[2]); macc[3] = fmaf(a.w, um, macc[3]);
        macc[4] = fmaf(b.x, um, macc[4]); macc[5] = fmaf(b.y, um, macc[5]);
        macc[6] = fmaf(b.z, um, macc[6]); macc[7] = fmaf(b.w, um, macc[7]);
      }
    }
    if constexpr (BF16) {
      const int n0 = p * PANEL + warp * 32;
      if (n0 < M)
        kw_panel_rows_mma(static_cast<const __nv_bfloat16*>(w), m_pad, kt, lo,
                          cnt_pad, n0, c);
    } else {
      kw_panel_rows(static_cast<const float*>(w) + (size_t)lo * M, kt, wbuf,
                    cnt, cnt_pad, M, p, g);
    }
  };
  auto epilogue = [&](int p, int home_lo) {
    // kt holds the rows home_lo..: K[r, n] of the panel's columns n
    if constexpr (BF16) {
      const int n0 = p * PANEL + warp * 32;
      epi16.kt = kt - (ptrdiff_t)home_lo * KT_STRIDE;
      if (n0 < M) epi16(n0, c);
    } else {
      epi.kt = kt - (ptrdiff_t)home_lo * KT_STRIDE;
      epi(p, g);
    }
    zero();
  };
  chunked_sweeps(x, zs, inv_ls, os, kt, wbuf, row0, R, d, M, chunk, on_chunk,
                 epilogue);

  // mean: x . mean_w of the warp's rows, lanes stride over d
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + warp * 8 + i;
    if (row < R) {
      const float* xr = x + (size_t)row * d;
      for (int k = lane; k < d; k += 32) macc[i] = fmaf(xr[k], mean_w[k], macc[i]);
    }
  }
  float mine = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float s = warp_sum(macc[i]);
    if (lane == i) mine = s;
  }
  {
    const int row = row0 + warp * 8 + lane;
    if (lane < 8 && row < R) mean_out[row] = *mean_b_ptr + mine;
  }

  if constexpr (BF16) {
    __syncthreads();  // wbuf: the last product is done
    float* red = wbuf;            // [8][TR]
    float* sums = wbuf + 8 * TR;  // [TR]
    row_sums_mma(epi16.part, red, sums);
    if (tid < TR && row0 + tid < R) var_out[row0 + tid] = os - sums[tid];
  } else {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float s = warp_sum(epi.var_part[i]);
      if (lane == i) v = s;
    }
    const int row = row0 + warp * 8 + lane;
    if (lane < 8 && row < R) var_out[row] = os - v;
  }
}

// E^T of the tile's rows for inducing points lo.. (cnt of them, cnt_pad
// rows) from emat into kt; colsum (if not null) gets each column's sum at
// lo + m.  Begins and ends with a barrier.
__device__ __forceinline__ void load_et(const float* emat, float* kt,
                                        float* __restrict__ colsum, int lo,
                                        int cnt, int cnt_pad, int row0, int R,
                                        int M) {
  __syncthreads();
  for (int m = threadIdx.x; m < cnt_pad; m += THREADS) {
    float* ktm = kt + m * KT_STRIDE;
    float acc = 0.f;
#pragma unroll 16
    for (int r = 0; r < TR; ++r) {
      const int row = row0 + r;
      const float e = (m < cnt && row < R) ? emat[(size_t)row * M + lo + m] : 0.f;
      ktm[r] = e;
      acc += e;
    }
    if (colsum != nullptr && m < cnt) colsum[lo + m] = acc;
  }
  __syncthreads();
}

// Backward launch 1 with M in chunks: the outputs of fused_gp_bwd_rows_kernel.
__global__ void __launch_bounds__(THREADS, 1)
fused_gp_bwd_rows_chunked_kernel(const float* __restrict__ x,
                                 const float* __restrict__ zs,
                                 const float* __restrict__ u,
                                 const float* __restrict__ w,
                                 const float* __restrict__ os_ptr,
                                 const float* __restrict__ inv_ls,
                                 const float* __restrict__ mean_w,
                                 const float* __restrict__ dmean,
                                 const float* __restrict__ dvar,
                                 float* __restrict__ dx, float* kmat,
                                 float* emat, float* __restrict__ part_m,
                                 float* __restrict__ part_s, int R, int d,
                                 int M, int m_pad, int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                      // [chunk][KT_STRIDE]  K^T, then E^T
  float* wbuf = kt + chunk * KT_STRIDE;  // [2][BK][PANEL]; staging
  float* dm_s = wbuf + WBUF;             // [TR]
  float* dv_s = dm_s + TR;               // [TR]
  float* rse_s = dv_s + TR;              // [TR]                rowsum(E)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int row0 = tile * TR;
  const float os = *os_ptr;
  const int n_chunks = (M + chunk - 1) / chunk;

  if (tid < TR) {
    const int row = row0 + tid;
    dm_s[tid] = row < R ? dmean[row] : 0.f;  // tail rows: zero cotangents
    dv_s[tid] = row < R ? dvar[row] : 0.f;
  }
  __syncthreads();

  float g[8][8];
  EEpilogue epi;
  epi.kt = kt; epi.u = u; epi.emat = emat;
  epi.M = M; epi.R = R; epi.lane = lane; epi.warp = warp; epi.row0 = row0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    epi.dm[i] = dm_s[warp * 8 + i];
    epi.dv[i] = dv_s[warp * 8 + i];
    epi.rowsum[i] = 0.f;
  }
  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) g[i][j] = 0.f;
  };
  zero();

  auto on_chunk = [&](int p, int lo, int cnt, int cnt_pad) {
    if (p == 0) {  // K to device memory, and the tile's K^T dmean
      for (int m = tid; m < cnt; m += THREADS) {
        const float* ktm = kt + m * KT_STRIDE;
        const int mg = lo + m;
        float acc = 0.f;
#pragma unroll 16
        for (int r = 0; r < TR; ++r) {
          acc = fmaf(ktm[r], dm_s[r], acc);
          const int row = row0 + r;
          if (row < R) kmat[(size_t)row * M + mg] = ktm[r];
        }
        part_m[((size_t)tile * 2 + 0) * M + mg] = acc;
      }
    }
    kw_panel_rows(w + (size_t)lo * M, kt, wbuf, cnt, cnt_pad, M, p, g);
  };
  auto epilogue = [&](int p, int home_lo) {  // E of the panel's columns
    epi.kt = kt - (ptrdiff_t)home_lo * KT_STRIDE;
    epi(p, g);
    zero();
  };
  chunked_sweeps(x, zs, inv_ls, os, kt, wbuf, row0, R, d, M, chunk, on_chunk,
                 epilogue);
  __syncthreads();  // emat's writes are read back below; wbuf is free
  {
    float mine = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float s = warp_sum(epi.rowsum[i]);
      if (lane == i) mine = s;
    }
    if (lane < 8) rse_s[warp * 8 + lane] = mine;
  }

  // dxs = E zs - rowsum(E) xs, dx and the slots' sums, E^T chunk by chunk;
  // colsum(E) with the first sweep over the chunks
  float* colsum = part_m + ((size_t)tile * 2 + 1) * M;
  const int slots = d > SMALL_D ? 8 : 2;
  float* part_t = part_s + (size_t)tile * (slots * 2 * d + 3);
  if (d > SMALL_D) {
    DxEpilogue dxe{x, inv_ls, mean_w, dx, part_t, rse_s, dm_s, R, d, lane,
                   warp, row0};
    const int n_panels = (d + PANEL - 1) / PANEL;
    for (int p = 0; p < n_panels; ++p) {
      zero();
      for (int ci = 0; ci < n_chunks; ++ci) {
        const int lo = ci * chunk;
        const int cnt = min(chunk, M - lo);
        load_et(emat, kt, p == 0 ? colsum : nullptr, lo, cnt, pad16(cnt), row0,
                R, M);
        kw_panel_rows(zs + (size_t)lo * d, kt, wbuf, cnt, pad16(cnt), d, p, g);
      }
      dxe(p, g);
    }
  } else {
    const int r = tid & (TR - 1);
    const int grp = tid >> 6;  // 0..3
    const int row = row0 + r;
    for (int kb = 0; kb < d; kb += 32) {
      const int k0 = kb + grp * 8;
      const int nk = min(8, d - k0);  // <= 0: no column of its own
      float acc[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc[jj] = 0.f;
      for (int ci = 0; ci < n_chunks; ++ci) {
        const int lo = ci * chunk;
        const int cnt = min(chunk, M - lo);
        load_et(emat, kt, kb == 0 ? colsum : nullptr, lo, cnt, pad16(cnt),
                row0, R, M);
        if (nk > 0) {
          for (int m = 0; m < cnt; ++m) {
            const float e = kt[m * KT_STRIDE + r];
            const float* zm = zs + (size_t)(lo + m) * d + k0;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
              if (jj < nk) acc[jj] = fmaf(e, __ldg(zm + jj), acc[jj]);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float s_dx = 0.f, s_dm = 0.f;
        if (jj < nk && row < R) {
          const int k = k0 + jj;
          const float xv = x[(size_t)row * d + k];
          const float il = inv_ls[k];
          const float dxs = acc[jj] - rse_s[r] * (xv * il);
          dx[(size_t)row * d + k] = fmaf(dxs, il, dm_s[r] * mean_w[k]);
          s_dx = dxs * xv;
          s_dm = dm_s[r] * xv;
        }
        s_dx = warp_sum(s_dx);
        s_dm = warp_sum(s_dm);
        if (lane == 0 && jj < nk) {
          part_t[(size_t)(warp & 1) * 2 * d + k0 + jj] = s_dx;
          part_t[(size_t)(warp & 1) * 2 * d + d + k0 + jj] = s_dm;
        }
      }
    }
  }
  // the tile's scalar sums
  if (tid < 3) {
    const float* src = tid == 0 ? rse_s : (tid == 1 ? dv_s : dm_s);
    float acc = 0.f;
    for (int r = 0; r < TR; ++r) acc += src[r];
    part_t[slots * 2 * d + tid] = acc;
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

// Backward launches 2 and 3 in fp32: for row range s of `rows_per` rows,
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
// each: dinv_ls[k], dmean_w[k], dos, dmean_b.  Only the dW tiles on and
// above the diagonal were computed.
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
    // below the diagonal of a symmetric product, read the mirror element
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
  const int slots = d > SMALL_D ? 8 : 2;
  const int ns = slots * 2 * d + 3;
  float a = 0.f, c = 0.f;
  if (q < 2 * d) {
    for (int t = tid; t < n_tiles * slots; t += THREADS)
      a += part_s[(size_t)(t / slots) * ns + (size_t)(t % slots) * 2 * d + q];
  } else {
    const int qa = q == 2 * d ? 0 : 2;
    for (int t = tid; t < n_tiles; t += THREADS) {
      a += part_s[(size_t)t * ns + slots * 2 * d + qa];
      if (q == 2 * d) c += part_s[(size_t)t * ns + slots * 2 * d + 1];
    }
  }
  a = block_sum(a, red);
  if (q == 2 * d) c = block_sum(c, red);
  if (tid != 0) return;
  if (q < d) dinv_ls[q] = a;
  else if (q < 2 * d) dmean_w[q - d] = a;
  else if (q == 2 * d) *dos = a / *os_ptr + c;
  else *dmean_b = a;
}

// ------------------------------------- bf16 backward on `wgmma` (any M) --
//
// The bf16 VJP as five products and two passes around them, every product
// on Hopper's warpgroup tensor-core instructions (wgmma_bf16.cuh).  The
// reference's three fp32 products -- the distance's cross term, E zs and
// E^T xs -- run on bf16 parts: an fp32 operand v is carried as p0 =
// bf16(v), p1 = bf16(v - p0), p2 = bf16(v - p0 - p1), which hold its 24
// bits, and a product as the sum of the six part products p_i q_j with
// i + j < 3, in fp32.  K W and K^T (dvar o K) take bf16-rounded K as the
// reference specifies; E takes K in fp32.  The tensor cores' fp32 sums are
// less exact than FFMA's over long runs of the summed index, so E zs and
// E^T xs add every 16-column sum into the tile's accumulator in fp32, and
// K W every 512-column one.  (Two parts of K in E, or of E, put dxs, dzs,
// dinv_ls and dos several times farther from float64 than the plain
// version; so did long tensor-core sums, and in K W so did short ones
// where W is ill-conditioned.)  Everything is computed in the orientation
// that lets both operands of every product be read from rows in device
// memory (K and E as (M, R)):
//   prep     xs = x o inv_ls in three parts (R, d) and |xs|^2; zs in three
//            parts, and transposed; W^T as the bf16 (M, M) tile;
//   1. K^T   (M, R) = os exp(-(|zs|^2 + |xs|^2 - 2 zs xs^T) / 2); writes K,
//            bf16(K) and bf16(dvar o K), and per 128-row range the partial
//            K^T dmean (du);
//   2. G^T   = W^T bf16(K)^T, then E^T = (u dmean^T - 2 G^T dvar) o K;
//            writes E's three parts and per range the partial row and
//            column sums of E;
//   3. dxs^T = zs^T E^T - rowsum(E) xs^T; dx = dxs o inv_ls + dmean mean_w
//            through a shared-memory transpose, and per range the partial
//            sums of dxs o x and dmean o x;
//   4. E^T xs over slabs of rows: (S, M, d) partials;
//   5. bf16(K)^T bf16(dvar o K) over slabs of rows: (S, M, M) partials;
//   reduce   the partials in a fixed order, in float64: du, dzs, dW, dos,
//            dinv_ls, dmean_w, dmean_b.
// Each product is one kernel, gemm_kernel: a 128 x 128 output tile per
// block of two warpgroups (64 rows each, 64 x 128 accumulators), the
// operands streamed 64 columns of the summed index at a time through a ring
// of shared-memory stages filled by cp.async.  Scratch arrays are padded to
// whole tiles (rows and columns to 128) and their pads hold zeros, so the
// copies need no masks; the inputs and outputs are not padded.  No atomics:
// two runs give equal gradients bit for bit.

namespace wgb {

using hopper::ROW_BYTES;
typedef __nv_bfloat16 bf16;

constexpr int GT = 128;          // output tile rows and columns
constexpr int GKC = 64;          // summed index per stage
constexpr int GTILE = GT * GKC * 2;  // bytes of one operand part a stage
constexpr int PARTS = 3;         // bf16 parts of an fp32 operand

// An fp32 operand carried as P bf16 parts (P 1: one bf16 operand): part 0 =
// bf16(v), part i = bf16(v - parts 0..i-1), rows of `ld` elements.
struct Operand {
  const bf16* part[PARTS];
  int ld;
};

// stages of the ring: three, two where P = 3 parts leave room for two
template <int P>
__host__ __device__ constexpr int stages() { return P == 3 ? 2 : 3; }
template <int P>
__host__ __device__ constexpr int stage_bytes() { return 2 * P * GTILE; }
template <int P>
__host__ __device__ constexpr int gemm_smem() { return stages<P>() * stage_bytes<P>() + 1024; }

__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float from_bf16(bf16 v) { return __bfloat162float(v); }

// v split into N bf16 parts: v ~ p[0] + ... + p[N - 1]
template <int N>
__device__ __forceinline__ void split(float v, bf16 (&p)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    p[i] = to_bf16(v);
    v -= from_bf16(p[i]);
  }
}

// A block's output tile: row tile rt (rows row0..), column tile ct, and
// the slab of the summed index.  The tiles run along x, the row tiles
// fastest, so that the blocks of a column tile, which share its operand
// rows, run together and x has room for any R; the slabs run along y.
struct Tile {
  int rt, ct, slab, row0, col0;
};
__device__ __forceinline__ Tile tile(int row_tiles) {
  const int rt = blockIdx.x % row_tiles, ct = blockIdx.x / row_tiles;
  return {rt, ct, (int)blockIdx.y, rt * GT, ct * GT};
}

// one stage: A rows row0.. x columns k0..k0+63 (K-major), and B: K-major
// rows col0.. x columns k0.., or MN-major rows k0.. x columns col0..col0+127
template <bool B_MN, int P>
__device__ __forceinline__ void load_stage(unsigned char* st, const Operand& A,
                                           const Operand& B, int row0,
                                           int col0, int k0) {
  const uint32_t base = hopper::smem_u32(st);
  for (int i = threadIdx.x; i < P * GT * 8; i += 2 * 128) {
    const int p = i / (GT * 8);
    const int j = i - p * (GT * 8);
    const int r = j >> 3, c = j & 7;
    const bf16* src = A.part[p] + (size_t)(row0 + r) * A.ld + k0 + c * 8;
    hopper::cp16(base + p * GTILE + hopper::swizzled(GT, r, c), src);
  }
  const uint32_t bbase = base + P * GTILE;
  for (int i = threadIdx.x; i < P * GT * 8; i += 2 * 128) {
    const int p = i / (GT * 8);
    const int j = i - p * (GT * 8);
    const bf16* b = B.part[p];
    if (B_MN) {  // 64 rows of 16 chunks
      const int r = j >> 4, c = j & 15;
      hopper::cp16(bbase + p * GTILE + hopper::swizzled(GKC, r, c),
                   b + (size_t)(k0 + r) * B.ld + col0 + c * 8);
    } else {
      const int r = j >> 3, c = j & 7;
      hopper::cp16(bbase + p * GTILE + hopper::swizzled(GT, r, c),
                   b + (size_t)(col0 + r) * B.ld + k0 + c * 8);
    }
  }
}

// row and column, in the block's 128 x 128 tile, of accumulator element i
// of slab nt
__device__ __forceinline__ int acc_row(int i) {
  return 64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x >> 5) & 3) +
         ((threadIdx.x & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int nt, int i) {
  return 64 * nt + 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// sums of a thread's values over the 4 lanes that share its rows
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// C (the block's 128 x 128 tile) = sum over the summed index in
// [k_len slab, min(k_len (slab + 1), k_total)) of A B, then epi(acc, smem,
// tile).  A and B carry P parts each (1 or PARTS), and the product sums
// the part products A_i B_j with i + j < P.  SUM: the k16 steps whose products the tensor cores sum in a
// fresh accumulator before it is added to the tile's in fp32 (0: the
// tensor cores carry the whole sum; a multiple of 4 steps: whole stages).
template <int P, bool B_MN, int SUM, class Epi>
__global__ void __launch_bounds__(256, 1)
gemm_kernel(Operand A, Operand B, int row_tiles, int k_len, int k_total,
            Epi epi) {
  static_assert(SUM == 0 || SUM == 1 || SUM % (GKC / 16) == 0, "SUM");
  constexpr int GSTAGES = stages<P>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = hopper::align1024(smem_raw);
  const Tile t = tile(row_tiles);
  const int kbeg = t.slab * k_len;
  const int nk = (min(k_len, k_total - kbeg) + GKC - 1) / GKC;
  const int wgi = threadIdx.x >> 7;
  auto stage = [&](int s) { return sm + s * stage_bytes<P>(); };
  auto load = [&](int j) {
    if (j < nk)
      load_stage<B_MN, P>(stage(j % GSTAGES), A, B, t.row0, t.col0, kbeg + j * GKC);
    hopper::cp_commit();
  };
#pragma unroll
  for (int j = 0; j < GSTAGES - 1; ++j) load(j);

  float acc[2][32], part[2][32];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nt][i] = 0.f;
  auto add_part = [&] {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[nt][i] += part[nt][i];
  };

  for (int j = 0; j < nk; ++j) {
    hopper::cp_wait<GSTAGES - 2>();
    hopper::fence_async_smem();
    __syncthreads();  // stage j is in; stage j - 1 is read by every warpgroup
    load(j + GSTAGES - 1);
    const uint32_t s = hopper::smem_u32(stage(j % GSTAGES));
    const uint32_t a0 = s + wgi * 64 * ROW_BYTES;
    const uint32_t b0 = s + P * GTILE;
    auto bdesc = [&](int j, int nt, int kk) {
      const uint32_t b = b0 + j * GTILE;
      return B_MN ? hopper::mndesc(b, GKC, nt, kk)
                  : hopper::kdesc(b + nt * 64 * ROW_BYTES, GT, kk);
    };
    if constexpr (SUM == 1) {
#pragma unroll
      for (int kk = 0; kk < GKC / 16; ++kk) {
        hopper::fence();
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < P; ++i)
#pragma unroll
            for (int j = 0; i + j < P; ++j)
              hopper::mma<B_MN>(part[nt], hopper::kdesc(a0 + i * GTILE, GT, kk),
                                bdesc(j, nt, kk), i + j > 0);
        hopper::commit();
        hopper::wait<0>();
        hopper::pin(part[0]);
        hopper::pin(part[1]);
        add_part();
      }
    } else {
      constexpr int per = SUM ? SUM / (GKC / 16) : 1;  // stages a sum spans
      const bool fresh = j % per == 0;
      hopper::fence();
#pragma unroll
      for (int kk = 0; kk < GKC / 16; ++kk)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < P; ++i)
#pragma unroll
            for (int j = 0; i + j < P; ++j) {
              const uint64_t a = hopper::kdesc(a0 + i * GTILE, GT, kk);
              if constexpr (SUM == 0)
                hopper::mma<B_MN>(acc[nt], a, bdesc(j, nt, kk));
              else
                hopper::mma<B_MN>(part[nt], a, bdesc(j, nt, kk),
                                  !fresh || kk + i + j > 0);
            }
      hopper::commit();
      hopper::wait<0>();
      if constexpr (SUM == 0) {
        hopper::pin(acc[0]);
        hopper::pin(acc[1]);
      } else {
        hopper::pin(part[0]);
        hopper::pin(part[1]);
        if (j % per == per - 1 || j == nk - 1) add_part();
      }
    }
  }
  hopper::cp_wait<0>();
  __syncthreads();  // the ring is free for the epilogue
  epi(acc, reinterpret_cast<float*>(sm), t);
}

// 1. K^T tile: rows m, columns r
struct KEpi {
  const float* x2;  // (Rp) |xs|^2, zeros past R
  const float* z2;  // (Mp)
  const float* os_ptr;
  const float* dmean;
  const float* dvar;
  bf16 *kh, *dvk;   // (Mp, Rp): bf16(K), bf16(dvar o K)
  float* kf;        // (Mp, Rp): K
  float* part_du;   // (Rp / 128, Mp)
  int M, R, Mp, Rp;

  __device__ void operator()(float (&acc)[2][32], float*, const Tile& t) const {
    const float os = *os_ptr;
    float du[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int m = t.row0 + acc_row(i);
        const int r = t.col0 + acc_col(nt, i);
        const float zz = z2[m];
        float k[2], dv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = m < M && r + e < R;
          const float d2 = (x2[r + e] + zz) - 2.f * acc[nt][i + e];
          k[e] = ok ? os * expf(-0.5f * d2) : 0.f;
          dv[e] = r + e < R ? dvar[r + e] : 0.f;
          du[(i >> 1) & 1] = fmaf(k[e], r + e < R ? dmean[r + e] : 0.f, du[(i >> 1) & 1]);
        }
        const size_t at = (size_t)m * Rp + r;
        *reinterpret_cast<float2*>(kf + at) = make_float2(k[0], k[1]);
        *reinterpret_cast<__nv_bfloat162*>(kh + at) =
            __halves2bfloat162(to_bf16(k[0]), to_bf16(k[1]));
        *reinterpret_cast<__nv_bfloat162*>(dvk + at) = __halves2bfloat162(
            to_bf16(dv[0] * k[0]), to_bf16(dv[1] * k[1]));
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float s = quad_sum(du[h]);
      if ((threadIdx.x & 3) == 0)
        part_du[(size_t)t.ct * Mp + t.row0 + acc_row(2 * h)] = s;
    }
  }
};

// 2. G^T tile = W^T K^T: rows m, columns r; E^T = (u dmean - 2 dvar G) o K
struct EEpi {
  const float* kf;
  const float* u;
  const float* dmean;
  const float* dvar;
  bf16* ep;           // PARTS planes (Mp, Rp): E's parts
  float* part_ce;     // (Rp / 128, Mp): sums over the range's rows
  float* part_re;     // (Mp / 128, Rp): sums over the tile's inducing points
  int M, R, Mp, Rp;

  __device__ void operator()(float (&acc)[2][32], float* red, const Tile& t) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const size_t plane = (size_t)Mp * Rp;
    float ce[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int m = t.row0 + acc_row(i);
        const int r = t.col0 + acc_col(nt, i);
        const size_t at = (size_t)m * Rp + r;
        const float2 k = *reinterpret_cast<const float2*>(kf + at);
        const float um = m < M ? u[m] : 0.f;
        bf16 p[2][PARTS];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const bool ok = r + q < R;
          const float dm = ok ? dmean[r + q] : 0.f;
          const float dv = ok ? dvar[r + q] : 0.f;
          const float e = (dm * um - (2.f * dv) * acc[nt][i + q]) * (q ? k.y : k.x);
          acc[nt][i + q] = e;
          ce[(i >> 1) & 1] += e;
          split(e, p[q]);
        }
#pragma unroll
        for (int j = 0; j < PARTS; ++j)
          *reinterpret_cast<__nv_bfloat162*>(ep + j * plane + at) =
              __halves2bfloat162(p[0][j], p[1][j]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float s = quad_sum(ce[h]);
      if ((threadIdx.x & 3) == 0)
        part_ce[(size_t)t.ct * Mp + t.row0 + acc_row(2 * h)] = s;
    }
    // column sums: the two rows of a thread, the 8 row groups of a warp,
    // then the 8 warps in order
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 32; i += 4)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float v = acc[nt][i + q] + acc[nt][i + 2 + q];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (lane < 4) red[warp * GT + acc_col(nt, i + q)] = v;
        }
    __syncthreads();
    if (threadIdx.x < GT) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += red[w * GT + threadIdx.x];
      part_re[(size_t)t.rt * Rp + t.col0 + threadIdx.x] = s;
    }
  }
};

// 3. (E zs)^T tile: rows k of d, columns r; dx through shared memory
struct DxEpi {
  const float* x;  // (R, d) raw
  const float* inv_ls;
  const float* mean_w;
  const float* dmean;
  const float* part_re;  // (Mp / 128, Rp)
  float* dx;             // (R, d)
  float* part_dx;        // (Rp / 128, 2 Dp): sums of dxs o x, then dmean o x
  int R, d, Dp, Rp, m_tiles;

  __device__ void operator()(float (&acc)[2][32], float* sm, const Tile& t) const {
    constexpr int LD = GT + 1;
    float* xt = sm;              // [128 r][LD]: x, then dx
    float* rse = sm + GT * LD;   // [128] rowsum(E)
    float* dms = rse + GT;       // [128] dmean
    for (int i = threadIdx.x; i < GT * GT; i += 256) {
      const int rl = i >> 7, kl = i & (GT - 1);
      const int r = t.col0 + rl, k = t.row0 + kl;
      xt[rl * LD + kl] = (r < R && k < d) ? x[(size_t)r * d + k] : 0.f;
    }
    if (threadIdx.x < GT) {
      const int r = t.col0 + threadIdx.x;
      float s = 0.f;
      for (int m = 0; m < m_tiles; ++m) s += part_re[(size_t)m * Rp + r];
      rse[threadIdx.x] = s;
      dms[threadIdx.x] = r < R ? dmean[r] : 0.f;
    }
    __syncthreads();
    float sdx[2] = {0.f, 0.f}, sdm[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kl = acc_row(i), rl = acc_col(nt, i);
        const int k = t.row0 + kl;
        const float il = k < d ? inv_ls[k] : 0.f;
        const float mw = k < d ? mean_w[k] : 0.f;
        const float xv = xt[rl * LD + kl];
        const float dxs = acc[nt][i] - rse[rl] * (xv * il);
        xt[rl * LD + kl] = dxs * il + dms[rl] * mw;
        sdx[(i >> 1) & 1] = fmaf(dxs, xv, sdx[(i >> 1) & 1]);
        sdm[(i >> 1) & 1] = fmaf(dms[rl], xv, sdm[(i >> 1) & 1]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float a = quad_sum(sdx[h]), b = quad_sum(sdm[h]);
      if ((threadIdx.x & 3) == 0) {
        const int k = t.row0 + acc_row(2 * h);
        part_dx[(size_t)t.ct * 2 * Dp + k] = a;
        part_dx[(size_t)t.ct * 2 * Dp + Dp + k] = b;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < GT * GT; i += 256) {
      const int rl = i >> 7, kl = i & (GT - 1);
      const int r = t.col0 + rl, k = t.row0 + kl;
      if (r < R && k < d) dx[(size_t)r * d + k] = xt[rl * LD + kl];
    }
  }
};

// 4., 5. partial products, one (., ld) plane a slab
struct PartEpi {
  float* out;
  int ld;
  size_t slab;

  __device__ void operator()(float (&acc)[2][32], float*, const Tile& t) const {
    float* o = out + t.slab * slab + (size_t)t.row0 * ld + t.col0;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 32; i += 2)
        *reinterpret_cast<float2*>(o + (size_t)acc_row(i) * ld + acc_col(nt, i)) =
            make_float2(acc[nt][i], acc[nt][i + 1]);
  }
};

// prep, one warp a row of x: xs = x o inv_ls in three bf16 parts, (Rp, Dp)
// each, and |xs|^2; zeros past R and d
__global__ void __launch_bounds__(256)
prep_x_kernel(const float* __restrict__ x, const float* __restrict__ inv_ls,
              bf16* __restrict__ xp, float* __restrict__ x2, int R, int d,
              int Rp, int Dp) {
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= Rp) return;
  const size_t plane = (size_t)Rp * Dp;
  float s = 0.f;
  for (int k = 2 * lane; k < Dp; k += 64) {
    bf16 p[2][PARTS];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v = (r < R && k + e < d) ? x[(size_t)r * d + k + e] * inv_ls[k + e] : 0.f;
      s = fmaf(v, v, s);
      split(v, p[e]);
    }
#pragma unroll
    for (int i = 0; i < PARTS; ++i)
      *reinterpret_cast<__nv_bfloat162*>(xp + i * plane + (size_t)r * Dp + k) =
          __halves2bfloat162(p[0][i], p[1][i]);
  }
  s = warp_sum(s);
  if (lane == 0) x2[r] = s;
}

// prep, one block an inducing point m < Mp: zs in three bf16 parts (Mp, Dp)
// and transposed (Dp, Mp), |zs|^2, and row m of W^T in bf16 (Mp, Mp); zeros
// past M and d
__global__ void __launch_bounds__(256)
prep_z_kernel(const float* __restrict__ zs, const float* __restrict__ w,
              bf16* __restrict__ zp, bf16* __restrict__ ztp,
              float* __restrict__ z2, bf16* __restrict__ w16, int M, int d,
              int Mp, int Dp) {
  __shared__ float red[8];
  const int m = blockIdx.x;
  const size_t plane = (size_t)Mp * Dp;
  float s = 0.f;
  for (int k = threadIdx.x; k < Dp; k += 256) {
    const float v = (m < M && k < d) ? zs[(size_t)m * d + k] : 0.f;
    s = fmaf(v, v, s);
    bf16 p[PARTS];
    split(v, p);
#pragma unroll
    for (int i = 0; i < PARTS; ++i) zp[i * plane + (size_t)m * Dp + k] = p[i];
#pragma unroll
    for (int i = 0; i < PARTS; ++i) ztp[i * plane + (size_t)k * Mp + m] = p[i];
  }
  s = block_sum(s, red);
  if (threadIdx.x == 0) z2[m] = s;
  for (int k = threadIdx.x; k < Mp; k += 256)
    w16[(size_t)m * Mp + k] = to_bf16((m < M && k < M) ? w[(size_t)k * M + m] : 0.f);
}

// sum of v over the block's threads in a fixed order; every thread gets it
__device__ double block_sum_f64(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // red may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = 0.0;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  return s;
}

// fixed-order sums of every partial, in float64 (so that a sum over all
// the rows, such as dmean_b, carries no more rounding than its result's):
// blocks 0..M-1 own inducing point m (du, dzs row, dW row); blocks M.. one
// scalar output each
__global__ void __launch_bounds__(256)
reduce_kernel(const float* __restrict__ part_du, const float* __restrict__ part_ce,
              const float* __restrict__ pz, const float* __restrict__ pw,
              const float* __restrict__ part_dx, const float* __restrict__ zs,
              const float* __restrict__ os_ptr, const float* __restrict__ dmean,
              const float* __restrict__ dvar, float* __restrict__ dzs,
              float* __restrict__ du, float* __restrict__ dw,
              float* __restrict__ dos, float* __restrict__ dinv_ls,
              float* __restrict__ dmean_w, float* __restrict__ dmean_b, int R,
              int d, int M, int Mp, int Dp, int r_tiles, int s_z, int s_w) {
  __shared__ double red[8];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  if (b < M) {
    const int m = b;
    double a = 0.0, c = 0.0;
    for (int t = tid; t < r_tiles; t += 256) {
      a += part_du[(size_t)t * Mp + m];
      c += part_ce[(size_t)t * Mp + m];
    }
    a = block_sum_f64(a, red);
    c = block_sum_f64(c, red);  // colsum(E)[m]
    if (tid == 0) du[m] = (float)a;
    for (int k = tid; k < d; k += 256) {
      double e = 0.0;
      for (int s = 0; s < s_z; ++s) e += pz[((size_t)s * Mp + m) * Dp + k];
      dzs[(size_t)m * d + k] = (float)(e - c * zs[(size_t)m * d + k]);
    }
    for (int n = tid; n < M; n += 256) {
      double e = 0.0;
      for (int s = 0; s < s_w; ++s) e += pw[((size_t)s * Mp + m) * Mp + n];
      dw[(size_t)m * M + n] = (float)-e;
    }
    return;
  }
  const int q = b - M;
  double a = 0.0, c = 0.0;
  if (q < 2 * d) {
    const int col = q < d ? q : Dp + q - d;
    for (int t = tid; t < r_tiles; t += 256) a += part_dx[(size_t)t * 2 * Dp + col];
  } else if (q == 2 * d) {
    for (int i = tid; i < r_tiles * M; i += 256)
      a += part_ce[(size_t)(i / M) * Mp + i % M];
    for (int r = tid; r < R; r += 256) c += dvar[r];
  } else {
    for (int r = tid; r < R; r += 256) a += dmean[r];
  }
  a = block_sum_f64(a, red);
  if (q == 2 * d) c = block_sum_f64(c, red);
  if (tid != 0) return;
  if (q < d) dinv_ls[q] = (float)a;
  else if (q < 2 * d) dmean_w[q - d] = (float)a;
  else if (q == 2 * d) *dos = (float)(a / *os_ptr + c);
  else *dmean_b = (float)a;
}

// scratch of one call, in bytes from its base (each array 256-byte aligned)
struct Plan {
  int Rp, Mp, Dp, r_tiles, s_z, k_z, s_w, k_w;
  size_t xp, x2, zp, ztp, z2, w16, kh, kf, dvk, e, part_du, part_ce, part_re,
      part_dx, pz, pw, total;
};

__host__ inline int round_up(int v, int to) { return (v + to - 1) / to * to; }

// slabs of the summed rows so that `tiles` output tiles make about one wave
__host__ inline void slabs(int Rp, int tiles, int& s, int& k_len) {
  s = 132 / tiles;
  if (s < 1) s = 1;
  if (s > Rp / GKC) s = Rp / GKC;
  k_len = round_up((Rp + s - 1) / s, GKC);
  s = (Rp + k_len - 1) / k_len;
}

__host__ inline Plan plan(int R, int d, int M) {
  Plan p;
  p.Rp = round_up(R, GT);
  p.Mp = round_up(M, GT);
  p.Dp = round_up(d, GT);
  p.r_tiles = p.Rp / GT;
  slabs(p.Rp, (p.Mp / GT) * (p.Dp / GT), p.s_z, p.k_z);
  slabs(p.Rp, (p.Mp / GT) * (p.Mp / GT), p.s_w, p.k_w);
  size_t o = 0;
  auto take = [&](size_t bytes) {
    const size_t at = o;
    o += (bytes + 255) / 256 * 256;
    return at;
  };
  const size_t rd = (size_t)p.Rp * p.Dp, md = (size_t)p.Mp * p.Dp,
               mr = (size_t)p.Mp * p.Rp;
  p.xp = take(PARTS * rd * 2); p.x2 = take((size_t)p.Rp * 4);
  p.zp = take(PARTS * md * 2); p.ztp = take(PARTS * md * 2);
  p.z2 = take((size_t)p.Mp * 4);
  p.w16 = take((size_t)p.Mp * p.Mp * 2);
  p.kh = take(mr * 2); p.kf = take(mr * 4); p.dvk = take(mr * 2);
  p.e = take(PARTS * mr * 2);
  p.part_du = take((size_t)p.r_tiles * p.Mp * 4);
  p.part_ce = take((size_t)p.r_tiles * p.Mp * 4);
  p.part_re = take((size_t)(p.Mp / GT) * p.Rp * 4);
  p.part_dx = take((size_t)p.r_tiles * 2 * p.Dp * 4);
  p.pz = take((size_t)p.s_z * md * 4);
  p.pw = take((size_t)p.s_w * p.Mp * p.Mp * 4);
  p.total = o;
  return p;
}

// the tiles of `row_tiles` x `col_tiles`, `slabs` deep, as gemm_kernel
// places them
template <int P, bool B_MN, int SUM, class Epi>
__host__ int gemm(int row_tiles, int col_tiles, int slabs, Operand A,
                  Operand B, int k_len, int k_total, const Epi& epi,
                  cudaStream_t st) {
  constexpr int smem = gemm_smem<P>();
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<P, B_MN, SUM, Epi>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gemm_kernel<P, B_MN, SUM, Epi><<<dim3(row_tiles * col_tiles, slabs), 256, smem, st>>>(
      A, B, row_tiles, k_len, k_total, epi);
  return (int)cudaGetLastError();
}

__host__ int launch_bwd(const float* x, const float* zs, const float* u,
                        const float* w, const float* os, const float* inv_ls,
                        const float* mean_w, const float* dmean,
                        const float* dvar, float* dx, float* dzs, float* du,
                        float* dw, float* dos, float* dinv_ls, float* dmean_w,
                        float* dmean_b, void* scratch, int R, int d, int M,
                        cudaStream_t st) {
  const Plan p = plan(R, d, M);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  auto b16 = [&](size_t off) { return reinterpret_cast<bf16*>(base + off); };
  auto f32 = [&](size_t off) { return reinterpret_cast<float*>(base + off); };
  const int mt = p.Mp / GT, rt = p.r_tiles, dt = p.Dp / GT;
  int err;

  prep_x_kernel<<<(p.Rp + 7) / 8, 256, 0, st>>>(x, inv_ls, b16(p.xp), f32(p.x2),
                                                R, d, p.Rp, p.Dp);
  if ((err = (int)cudaGetLastError())) return err;
  prep_z_kernel<<<p.Mp, 256, 0, st>>>(zs, w, b16(p.zp), b16(p.ztp), f32(p.z2),
                                      b16(p.w16), M, d, p.Mp, p.Dp);
  if ((err = (int)cudaGetLastError())) return err;

  const size_t rd = (size_t)p.Rp * p.Dp, md = (size_t)p.Mp * p.Dp,
               mr = (size_t)p.Mp * p.Rp;
  auto parts = [&](size_t off, size_t plane, int n, int ld) {
    Operand o{{nullptr, nullptr, nullptr}, ld};
    for (int i = 0; i < n; ++i) o.part[i] = b16(off) + i * plane;
    return o;
  };
  const Operand xs = parts(p.xp, rd, PARTS, p.Dp);
  const Operand zsp = parts(p.zp, md, PARTS, p.Dp);
  const Operand zst = parts(p.ztp, md, PARTS, p.Mp);
  const Operand kt = parts(p.kh, 0, 1, p.Rp);
  const Operand et = parts(p.e, mr, PARTS, p.Rp);
  // 1. K^T: the distance's cross term in three parts, six products
  err = gemm<PARTS, false, 0>(mt, rt, 1, zsp, xs, p.Dp, p.Dp,
                       KEpi{f32(p.x2), f32(p.z2), os, dmean, dvar, b16(p.kh),
                            b16(p.dvk), f32(p.kf), f32(p.part_du), M, R, p.Mp,
                            p.Rp}, st);
  if (err) return err;
  // 2. G^T = W^T K^T in bf16 (sums over 512 inducing points at a time),
  // E^T in the epilogue
  err = gemm<1, true, 32>(mt, rt, 1, parts(p.w16, 0, 1, p.Mp), kt, p.Mp, p.Mp,
                      EEpi{f32(p.kf), u, dmean, dvar, b16(p.e), f32(p.part_ce),
                           f32(p.part_re), M, R, p.Mp, p.Rp}, st);
  if (err) return err;
  // 3. (E zs)^T in three parts (sums over 16 at a time), dx in the epilogue
  err = gemm<PARTS, true, 1>(dt, rt, 1, zst, et, p.Mp, p.Mp,
                       DxEpi{x, inv_ls, mean_w, dmean, f32(p.part_re), dx,
                             f32(p.part_dx), R, d, p.Dp, p.Rp, mt}, st);
  if (err) return err;
  // 4. E^T xs in three parts (sums over 16 rows at a time), over slabs
  err = gemm<PARTS, true, 1>(mt, dt, p.s_z, et, xs, p.k_z, p.Rp,
                       PartEpi{f32(p.pz), p.Dp, md}, st);
  if (err) return err;
  // 5. K^T (dvar o K) in bf16, over slabs of rows
  err = gemm<1, false, 0>(mt, mt, p.s_w, kt, parts(p.dvk, 0, 1, p.Rp), p.k_w,
                       p.Rp, PartEpi{f32(p.pw), p.Mp, (size_t)p.Mp * p.Mp}, st);
  if (err) return err;
  reduce_kernel<<<M + 2 * d + 2, 256, 0, st>>>(
      f32(p.part_du), f32(p.part_ce), f32(p.pz), f32(p.pw), f32(p.part_dx), zs,
      os, dmean, dvar, dzs, du, dw, dos, dinv_ls, dmean_w, dmean_b, R, d, M,
      p.Mp, p.Dp, rt, p.s_z, p.s_w);
  return (int)cudaGetLastError();
}

}  // namespace wgb

struct BwdPlan {
  int n_tiles, m_pad, s_w, rows_w, s_z, rows_z, z_tile;
  long long kmat, emat, part_m, part_s, pw, pz, total;  // scratch offsets
};

// splits over rows so that each column product fills one wave of at most
// TARGET_BLOCKS blocks (rounding up would start a second, nearly empty wave);
// rows_per is a multiple of `chunk`
__host__ void split_rows(int R, int tiles, int chunk, int& s, int& rows_per) {
  s = TARGET_BLOCKS / tiles;
  const int max_s = (R + chunk - 1) / chunk;
  if (s > max_s) s = max_s;
  if (s < 1) s = 1;
  rows_per = (R + s - 1) / s;
  rows_per = (rows_per + chunk - 1) / chunk * chunk;
  s = (R + rows_per - 1) / rows_per;
}

__host__ BwdPlan plan(int R, int d, int M) {
  BwdPlan p;
  p.n_tiles = (R + TR - 1) / TR;
  p.m_pad = (M + BK - 1) / BK * BK;
  const int rp = p.n_tiles * TR;
  const int mt = (M + CBM - 1) / CBM;
  const int nt = (M + DW_TILE - 1) / DW_TILE;
  split_rows(R, nt * (nt + 1) / 2, CK, p.s_w, p.rows_w);
  p.z_tile = d > 64 ? 128 : 32;  // columns of d per E^T x block
  split_rows(R, mt * ((d + p.z_tile - 1) / p.z_tile), CK, p.s_z, p.rows_z);
  long long o = 0;
  p.kmat = o; o += (long long)rp * M;  // K, (R, M)
  p.emat = o; o += (long long)R * M;
  p.part_m = o; o += (long long)p.n_tiles * 2 * M;
  p.part_s = o; o += (long long)p.n_tiles * ((d > SMALL_D ? 8 : 2) * 2 * d + 3);
  p.pw = o; o += (long long)p.s_w * M * M;
  p.pz = o; o += (long long)p.s_z * M * d;
  p.total = o;
  return p;
}

// Shared memory of a forward block that holds K^T for `rows` inducing
// points (all of M, padded, or one chunk); the backward's row launch needs
// 3 TR floats more.  The wrapper's layout() mirrors these two.
int smem_fwd(int rows) {
  return (int)(((long long)rows * KT_STRIDE + WBUF) * (long long)sizeof(float));
}

int smem_bwd(int rows) { return smem_fwd(rows) + 3 * TR * (int)sizeof(float); }

// chunk >= m_pad: the single-pass kernels; else a multiple of PANEL
bool chunk_ok(int M, int chunk) {
  const int m_pad = (M + BK - 1) / BK * BK;
  return chunk >= m_pad || (chunk > 0 && chunk % PANEL == 0);
}

template <bool BF16>
int launch_fwd(const float* x, const float* zs, const float* u, const void* w,
               const float* os, const float* inv_ls, const float* mean_w,
               const float* mean_b, float* mean, float* var, int R, int d,
               int M, int chunk, cudaStream_t stream) {
  if (!chunk_ok(M, chunk)) return (int)cudaErrorInvalidValue;
  const int m_pad = (M + BK - 1) / BK * BK;
  const int blocks = (R + TR - 1) / TR;
  if (chunk >= m_pad) {
    const int smem = smem_fwd(m_pad);
    cudaError_t err = cudaFuncSetAttribute(
        fused_gp_fwd_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    fused_gp_fwd_kernel<BF16><<<blocks, THREADS, smem, stream>>>(
        x, zs, u, w, os, inv_ls, mean_w, mean_b, mean, var, R, d, M, m_pad);
    return (int)cudaGetLastError();
  }
  const int smem = smem_fwd(chunk);
  cudaError_t err = cudaFuncSetAttribute(
      fused_gp_fwd_chunked_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_gp_fwd_chunked_kernel<BF16><<<blocks, THREADS, smem, stream>>>(
      x, zs, u, w, os, inv_ls, mean_w, mean_b, mean, var, R, d, M, m_pad, chunk);
  return (int)cudaGetLastError();
}

int launch_bwd(const float* x, const float* zs, const float* u, const float* w,
               const float* os, const float* inv_ls, const float* mean_w,
               const float* dmean, const float* dvar, float* dx, float* dzs,
               float* du, float* dw, float* dos, float* dinv_ls,
               float* dmean_w, float* dmean_b, float* scratch, int R, int d,
               int M, int chunk, cudaStream_t st) {
  if (!chunk_ok(M, chunk)) return (int)cudaErrorInvalidValue;
  const BwdPlan p = plan(R, d, M);
  float* kmat = scratch + p.kmat;
  float* emat = scratch + p.emat;
  float* part_m = scratch + p.part_m;
  float* part_s = scratch + p.part_s;
  float* pw = scratch + p.pw;
  float* pz = scratch + p.pz;

  cudaError_t err;
  if (chunk >= p.m_pad) {
    const int smem = smem_bwd(p.m_pad);
    err = cudaFuncSetAttribute(
        fused_gp_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    fused_gp_bwd_rows_kernel<<<p.n_tiles, THREADS, smem, st>>>(
        x, zs, u, w, os, inv_ls, mean_w, dmean, dvar, dx, kmat, emat, part_m,
        part_s, R, d, M, p.m_pad);
  } else {
    const int smem = smem_bwd(chunk);
    err = cudaFuncSetAttribute(
        fused_gp_bwd_rows_chunked_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    fused_gp_bwd_rows_chunked_kernel<<<p.n_tiles, THREADS, smem, st>>>(
        x, zs, u, w, os, inv_ls, mean_w, dmean, dvar, dx, kmat, emat, part_m,
        part_s, R, d, M, p.m_pad, chunk);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int mt = (M + CBM - 1) / CBM;
  const int nt = (M + DW_TILE - 1) / DW_TILE;
  fused_gp_bwd_cols_kernel<8, 8, true><<<dim3(nt * (nt + 1) / 2, 1, p.s_w), THREADS, 0, st>>>(
      kmat, kmat, dvar, pw, R, M, M, p.rows_w);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 zgrid((d + p.z_tile - 1) / p.z_tile, mt, p.s_z);
  if (p.z_tile == 128)
    fused_gp_bwd_cols_kernel<8, 8, false><<<zgrid, THREADS, 0, st>>>(
        emat, x, nullptr, pz, R, M, d, p.rows_z);
  else
    fused_gp_bwd_cols_kernel<8, 2, false><<<zgrid, THREADS, 0, st>>>(
        emat, x, nullptr, pz, R, M, d, p.rows_z);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  fused_gp_bwd_reduce_kernel<<<M + 2 * d + 2, THREADS, 0, st>>>(
      part_m, part_s, pw, pz, zs, inv_ls, os, dzs, du, dw, dos, dinv_ls,
      dmean_w, dmean_b, p.n_tiles, d, M, p.s_w, p.s_z);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of device scratch the backward needs (the wrapper allocates it).
long long fused_gp_bwd_scratch_floats(int R, int d, int M) {
  return plan(R, d, M).total;
}

long long fused_gp_bf16_bwd_scratch_floats(int R, int d, int M) {
  return (long long)((wgb::plan(R, d, M).total + 3) / 4);
}

// Rows and columns of the bf16 W^T the bf16 forward takes: wt[n][k] =
// bf16(W[k][n]), zero beyond M.
int fused_gp_bf16_wt_rows(int M) { return (M + PANEL - 1) / PANEL * PANEL; }
int fused_gp_bf16_wt_cols(int M) { return (M + BK - 1) / BK * BK; }

// x (R, d) raw rows; zs (M, d) = Z / lengthscale; u (M,); w (M, M) row-major;
// os, mean_b: device scalars; inv_ls, mean_w (d,); mean, var (R,) outputs.
// chunk: the inducing points a block holds K^T for (the wrapper's layout():
// M padded to 16 for the single-pass kernels, else a multiple of 256).
// Returns the cudaError_t of the launch.
int fused_gp_fwd(const float* x, const float* zs, const float* u, const float* w,
                 const float* os, const float* inv_ls, const float* mean_w,
                 const float* mean_b, float* mean, float* var, int R, int d,
                 int M, int chunk, void* stream) {
  return launch_fwd<false>(x, zs, u, w, os, inv_ls, mean_w, mean_b, mean, var,
                           R, d, M, chunk, (cudaStream_t)stream);
}

// The same with the K W product in bf16 on the tensor cores; wt is the bf16
// W^T described at fused_gp_bf16_wt_rows.
int fused_gp_bf16_fwd(const float* x, const float* zs, const float* u,
                      const void* wt, const float* os, const float* inv_ls,
                      const float* mean_w, const float* mean_b, float* mean,
                      float* var, int R, int d, int M, int chunk,
                      void* stream) {
  return launch_fwd<true>(x, zs, u, wt, os, inv_ls, mean_w, mean_b, mean, var,
                          R, d, M, chunk, (cudaStream_t)stream);
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
                 int M, int chunk, void* stream) {
  return launch_bwd(x, zs, u, w, os, inv_ls, mean_w, dmean, dvar, dx,
                           dzs, du, dw, dos, dinv_ls, dmean_w, dmean_b,
                           scratch, R, d, M, chunk, (cudaStream_t)stream);
}

// The bf16 VJP: K W and K^T (dvar o K) in bf16 on the tensor cores, at any
// M (one design, so no chunk); inputs and outputs as fused_gp_bwd's, w the
// fp32 (M, M); scratch of fused_gp_bf16_bwd_scratch_floats floats.
int fused_gp_bf16_bwd(const float* x, const float* zs, const float* u,
                      const float* w, const float* os, const float* inv_ls,
                      const float* mean_w, const float* dmean,
                      const float* dvar, float* dx, float* dzs, float* du,
                      float* dw, float* dos, float* dinv_ls, float* dmean_w,
                      float* dmean_b, float* scratch, int R, int d, int M,
                      void* stream) {
  return wgb::launch_bwd(x, zs, u, w, os, inv_ls, mean_w, dmean, dvar, dx,
                         dzs, du, dw, dos, dinv_ls, dmean_w, dmean_b, scratch,
                         R, d, M, (cudaStream_t)stream);
}

}  // extern "C"
